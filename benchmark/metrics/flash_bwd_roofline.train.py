"""The flash-attention backward kernels' share of their roofline over the
profiled training steps, in %: each dK/dV and dQ launch's least time
(arith/roofline_bwd.py, at the step's [B, heads, N, head dim], N the core's
tokens padded to model.core.seq_multiple) summed, over the launches' summed
device times."""

import math

from benchmark.arith.flops import core_tokens
from benchmark.arith.roofline_bwd import attention_bwd_bound_s


def read(ctx):
    trace = ctx.get("trace")
    launches = [k for k in trace.kernels if "flash_bwd" in k.name] if trace else []
    if not launches:
        return None
    core = ctx["cfg"]["model"]["core"]
    n = core_tokens(ctx["cfg"])["total"]
    mult = max(1, int(core.get("seq_multiple", 1) or 1))
    n_pad = math.ceil(n / mult) * mult
    B, H = int(ctx["traffic"]["batch"]), int(core["n_heads"])
    shape = (B, H, n_pad, int(core["d_model"]) // H)
    bound = sum(attention_bwd_bound_s("dq" if "dq" in k.name else "dkdv", shape, "bfloat16",
                                      [n] * B, n_pad != n) for k in launches)
    return 100.0 * bound / sum(k.seconds for k in launches)
