"""The CogVideoX transformer's model FLOPs over the window's wall time, as a
share of the card's dense bf16 peak, in %: the window's sample passes
(videos x steps x the CFG batch's 2) at arith/cogvideox_flops.py's count of
one pass. The VAE decoder is not counted, so it is a floor on the whole
call's share."""

from benchmark.arith.cogvideox_flops import cogvideox_forward_flops
from benchmark.arith.roofline import PEAK_FLOPS


def read(ctx):
    if not ctx.get("forwards") or not ctx.get("wall_s"):
        return None
    flops = ctx["forwards"] * cogvideox_forward_flops(ctx["cfg"])["total"]
    return 100.0 * flops / ctx["wall_s"] / PEAK_FLOPS["bfloat16"]
