"""The flash-attention forward kernel's share of its roofline in the
CogVideoX cell, in %: over the profiled calls, the sum of each launch's
least time (arith/roofline.py at the joint attention's [2 B, heads, L + n,
head dim], the CFG batch, every key valid) over the sum of the launches'
device times."""

from benchmark.arith.cogvideox_flops import tokens
from benchmark.arith.roofline import attention_fwd_bound_s


def read(ctx):
    trace = ctx.get("trace")
    launches = [k for k in trace.kernels if "flash_fwd" in k.name] if trace else []
    if not launches:
        return None
    core = ctx["cfg"]["model"]["core"]
    B, H, N = 2 * int(ctx["traffic"]["batch"]), int(core["n_heads"]), tokens(ctx["cfg"])["total"]
    bound = attention_fwd_bound_s((B, H, N, int(core["d_model"]) // H), "bfloat16", [N] * B, False)
    return 100.0 * bound * len(launches) / sum(k.seconds for k in launches)
