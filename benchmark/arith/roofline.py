"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit) and the least time of the flash-attention kernels, copied from the
kernel table's arithmetic (``chip_smoke.py::attention_bound_ms``): each
input read once and each output written once against the FLOPs of the
valid keys; the bound is the larger of the two times.
"""

from __future__ import annotations

from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def _elt(dtype_name: str) -> int:
    return 2 if dtype_name == "bfloat16" else 4


def attention_fwd_bound_s(shape: Tuple[int, int, int, int], dtype_name: str,
                          n_valid_keys: Sequence[int], masked: bool) -> float:
    """shape [B, H, N, Dh]; n_valid_keys: the attendable keys of each batch
    row. Reads q, k, v, writes out (4 tensors) and the fp32 lse."""
    B, H, N, Dh = shape
    nbytes = 4 * B * H * N * Dh * _elt(dtype_name) + B * H * N * 4 + (B * N if masked else 0)
    flops = 4 * H * N * Dh * sum(n_valid_keys)
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name])

