"""The flash-attention forward kernel's share of its roofline over the
profiled calls, in %: the sum of each launch's least time (arith/roofline.py,
at the sampler's [2B, heads, N, head dim] with N the core's tokens padded to
model.core.seq_multiple) over the sum of the launches' device times."""

import math

from benchmark.arith.flops import core_tokens
from benchmark.arith.roofline import attention_fwd_bound_s


def read(ctx):
    trace = ctx.get("trace")
    launches = [k for k in trace.kernels if "flash_fwd" in k.name] if trace else []
    if not launches:
        return None
    core = ctx["cfg"]["model"]["core"]
    n = core_tokens(ctx["cfg"])["total"]
    mult = max(1, int(core.get("seq_multiple", 1) or 1))
    n_pad = math.ceil(n / mult) * mult
    B2 = 2 * int(ctx["traffic"]["batch"])
    H = int(core["n_heads"])
    shape = (B2, H, n_pad, int(core["d_model"]) // H)
    bound = attention_fwd_bound_s(shape, "bfloat16", [n] * B2, n_pad != n)
    return 100.0 * bound * len(launches) / sum(k.seconds for k in launches)
