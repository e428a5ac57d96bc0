"""The denoiser's model FLOPs over the window's wall time, as a share of the
card's dense bf16 peak, in %: 2B forwards a step (batched classifier-free
guidance) at the tokens the core runs, without padding. The VAE, codec and
heads are not counted, so it is a floor on the whole call's share."""

from benchmark.arith.flops import denoiser_forward_flops
from benchmark.arith.roofline import PEAK_FLOPS


def read(ctx):
    if not ctx.get("forwards") or not ctx.get("wall_s"):
        return None
    flops = ctx["forwards"] * denoiser_forward_flops(ctx["cfg"])
    return 100.0 * flops / ctx["wall_s"] / PEAK_FLOPS["bfloat16"]
