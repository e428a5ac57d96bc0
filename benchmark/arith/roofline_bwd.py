"""The least time of the flash-attention backward kernels, copied from the
kernel table's arithmetic (``chip_smoke.py::attention_bwd_bound_ms``): the
dK/dV kernel reads q, dO, k, v, lse and D and writes dk and dv (4 products:
S, dP, dV, dK); the dQ kernel reads the same and writes dq (3 products: S,
dP, dQ). The bound is the larger of the bytes over HBM's rate and the
FLOPs of the valid keys over the dense peak.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from benchmark.arith.roofline import HBM_BYTES_PER_S, PEAK_FLOPS


def attention_bwd_bound_s(kernel: str, shape: Tuple[int, int, int, int], dtype_name: str,
                          n_valid_keys: Sequence[int], masked: bool) -> float:
    """kernel "dkdv" or "dq"; shape [B, H, N, Dh]; n_valid_keys: the
    attendable keys of each batch row."""
    B, H, N, Dh = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    tensors, products = (6, 4) if kernel == "dkdv" else (5, 3)
    nbytes = tensors * B * H * N * Dh * elt + 2 * B * H * N * 4 + (B * N if masked else 0)
    flops = products * 2 * H * N * Dh * sum(n_valid_keys)
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name])
