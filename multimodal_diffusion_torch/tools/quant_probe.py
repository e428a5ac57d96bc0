"""Reduced-precision matmul probe on one CUDA card: bf16 vs int8 vs fp8,
their rates and their numerics (counterpart of the repo root's
``tools/quant_probe.py``):

    python -m multimodal_diffusion_torch.tools.quant_probe [--sizes 2048 4096 8192]
        [--d 512] [--tokens 1152] [--batch 8] [--out report.json] [--device cpu]

  1. a bf16 calibration suite: ``F.linear`` at the square sizes and at the
     t2i core's GEMM shapes ([B*N, d] x [d, k*d]: the fused qkv, fc1, fc2),
     each rate and the best;
  2. at one square size (the larger of the first two), the rate of bf16
     ``F.linear``, of the int8 product (``ops/quant.py::int8_matmul``:
     ``torch._int_mm``, the product inside ``int8_linear``) on per-channel
     symmetric int8 operands, and of an fp8 e4m3 product
     (``torch._scaled_mm``, unit scales) on a plain cast of the operands / 8;
  3. the numerics of each on the t2i qkv projection: the relative Frobenius
     error against the fp32 product (int8: per-row activation and
     per-output-channel weight scales; fp8: a plain cast).

On the card each rate stands beside its share of the H100's published dense
peak (989 TFLOP/s bf16, 1979 TOP/s int8, 1979 TFLOP/s fp8) and the card's
power limit. These are library calls timed as yardsticks: the probe ports
no kernel. Times are ``mfu_probe.chain_time``'s (CUDA events). On the CPU
(``--device cpu``) the compute dtype is fp32 in place of bf16, as the JAX
probe's off the TPU, and no peak share is given; without CUDA and without
``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.quant import int8_matmul
from ..utils.io import resolve_device
from .mfu_probe import chain_time, device_kind

# NVIDIA H100 SXM data sheet, dense: ops/s by operand type
H100_PEAK = {"bf16": 989e12, "int8": 1979e12, "fp8": 1979e12}


def rel_err(ref: np.ndarray, got: np.ndarray) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-12))


def quantize_per_channel(a: np.ndarray, axis: int):
    """Symmetric int8 along `axis` (scale = absmax / 127 over it): (q, s)."""
    s = np.abs(a).max(axis=axis, keepdims=True) / 127.0
    return np.clip(np.rint(a / s), -127, 127).astype(np.int8), s


def fp8_matmul(a: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """[M, K] x [N, K] float8_e4m3fn -> [M, N] (a @ w.T), unit scales."""
    one = torch.ones((), dtype=torch.float32, device=a.device)
    return torch._scaled_mm(a, w.t(), scale_a=one, scale_b=one, out_dtype=out_dtype)


def power_limit(dev: torch.device):
    if dev.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[2048, 4096, 8192])
    ap.add_argument("--d", type=int, default=512,
                    help="t2i core width for the GEMM-shape calibration rows")
    ap.add_argument("--tokens", type=int, default=1152,
                    help="padded t2i sequence (1101 -> 1152 at seq_multiple 128)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device("cpu" if (args.device or "").lower() == "cpu" else "cuda")
    on_card = dev.type == "cuda"
    bf = torch.bfloat16 if on_card else torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"backend": dev.type, "device_kind": device_kind(dev),
              "nvidia_smi": power_limit(dev)}

    def share(ops_per_s: float, kind: str):
        return round(ops_per_s / H100_PEAK[kind], 4) if on_card else None

    def randn(shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev).to(bf)

    # 1. calibration suite (bf16): square sizes + the core's GEMM shapes
    BN, d = args.batch * args.tokens, args.d
    shapes = [(s, s, s) for s in args.sizes] + [(BN, d, 3 * d), (BN, d, 4 * d), (BN, 4 * d, d)]
    calib, calib_share = {}, {}
    for m, kk, n in shapes:
        a, w = randn((m, kk), 0), randn((n, kk), 1)
        t = chain_time(lambda: F.linear(a, w), dev, n_inner=10)
        calib[f"{m}x{kk}x{n}"] = round(2 * m * kk * n / t / 1e12, 1)
        calib_share[f"{m}x{kk}x{n}"] = share(2 * m * kk * n / t, "bf16")
        del a, w
    report["calib_suite_bf16_tflops"] = calib
    report["calib_suite_bf16_peak_share"] = calib_share
    report["calib_best_tflops"] = max(calib.values())

    # 2. reduced-precision square products
    M = max(args.sizes[:2])
    a32 = np.random.default_rng(0).normal(size=(M, M)).astype(np.float32)
    b32 = np.random.default_rng(1).normal(size=(M, M)).astype(np.float32)  # [N, K]
    flop = 2 * M ** 3
    a8, _ = quantize_per_channel(a32, 1)
    b8, _ = quantize_per_channel(b32, 1)
    a8, b8 = torch.from_numpy(a8).to(dev), torch.from_numpy(b8).to(dev)
    t_i8 = chain_time(lambda: int8_matmul(a8, b8), dev, n_inner=10)
    a_f8 = torch.from_numpy(a32 / 8.0).to(dev).to(torch.float8_e4m3fn)  # within e4m3's range
    b_f8 = torch.from_numpy(b32 / 8.0).to(dev).to(torch.float8_e4m3fn)
    t_f8 = chain_time(lambda: fp8_matmul(a_f8, b_f8, bf), dev, n_inner=10)
    a_bf, b_bf = torch.from_numpy(a32).to(dev, bf), torch.from_numpy(b32).to(dev, bf)
    t_bf = chain_time(lambda: F.linear(a_bf, b_bf), dev, n_inner=10)
    report["square_matmul"] = {
        "size": M,
        "int8_tops": round(flop / t_i8 / 1e12, 1), "int8_peak_share": share(flop / t_i8, "int8"),
        "fp8_e4m3_tflops": round(flop / t_f8 / 1e12, 1),
        "fp8_peak_share": share(flop / t_f8, "fp8"),
        "bf16_tflops": round(flop / t_bf / 1e12, 1), "bf16_peak_share": share(flop / t_bf, "bf16"),
        "int8_speedup_vs_bf16": round(t_bf / t_i8, 2),
        "fp8_speedup_vs_bf16": round(t_bf / t_f8, 2),
    }
    del a8, b8, a_f8, b_f8, a_bf, b_bf

    # 3. numerics on the t2i qkv projection
    rng = np.random.default_rng(2)
    x32 = rng.normal(size=(BN, d)).astype(np.float32)
    w_in_out = (rng.normal(size=(d, 3 * d)) / np.sqrt(d)).astype(np.float32)  # the JAX draw
    w32 = np.ascontiguousarray(w_in_out.T)  # [out, in], F.linear's layout
    ref = x32 @ w_in_out
    err = {}
    y_bf = F.linear(torch.from_numpy(x32).to(dev, bf), torch.from_numpy(w32).to(dev, bf))
    err["bf16_rel_err"] = round(rel_err(ref, y_bf.float().cpu().numpy()), 5)
    x8, sx = quantize_per_channel(x32, 1)
    w8, sw = quantize_per_channel(w32, 1)  # per output channel
    y_i8 = int8_matmul(torch.from_numpy(x8).to(dev), torch.from_numpy(w8).to(dev))
    err["int8_rel_err"] = round(rel_err(ref, y_i8.cpu().numpy().astype(np.float64) * sx * sw.T),
                                5)
    y_f8 = fp8_matmul(torch.from_numpy(x32).to(dev).to(torch.float8_e4m3fn),
                      torch.from_numpy(w32).to(dev).to(torch.float8_e4m3fn), torch.float32)
    err["fp8_e4m3_rel_err"] = round(rel_err(ref, y_f8.cpu().numpy()), 5)
    report["qkv_numerics"] = err

    print(json.dumps(report), flush=True)
    if args.out:
        args.out.write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
