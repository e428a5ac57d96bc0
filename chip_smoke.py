#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py            # from the repo root, one CUDA card

Phases, one JSON line each (any failure raises and exits non-zero):
  1. device  — the card (nvidia-smi name, power limit), torch and CUDA versions;
  2. build   — nvcc builds multimodal_diffusion_torch/csrc/flash_fwd.cu;
  3. kernel  — the flash-attention forward kernel against its plain PyTorch
               version (out and lse) at the mvp, flagship and t2i shapes, masked
               and unmasked, bf16 and fp32 (TF32 off), with its time, the plain
               version's, SDPA's (a yardstick the port never calls) and the
               least time the card could take;
  4. v2a     — the main path at mvp full width through the public entry point
               (build_components + sample_one_direction): B=8 clips, 50 DDIM
               steps with batched CFG, seeded N(0, 0.02) weights, bf16 compute;
               the kernel must launch exactly 50 x 8 = 400 times; one
               denoise_tokens forward with and without the kernel must agree.
Then a `kernels` line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. The device time by kernel of one v2a batch is
`python -m multimodal_diffusion_torch.tools.profile_v2a`.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# (name, [B, H, N, Dh], masked keys in batch row 0): the mvp sampling call
# (CFG-doubled batch 16), the flagship training shape, the t2i-512 core
# (1152 padded from 1101: 51 keys masked), and one batch row fully masked
KERNEL_CASES = [
    ("mvp", (16, 8, 133, 64), 0),
    ("flagship", (8, 8, 421, 128), 0),
    ("t2i", (2, 4, 1152, 128), 51),
    ("all_masked_row", (2, 8, 133, 64), 133),
]
TOL = {"float32": {"out": 1e-4, "lse": 1e-4}, "bfloat16": {"out": 2e-2, "lse": 1e-3}}
V2A_CLIPS, V2A_STEPS = 8, 50
# denoise_tokens with and without the kernel, bf16: max |diff| / max |ref|.
# Both paths round activations to bf16 (relative 2^-8 = 3.9e-3) after each of
# 8 layers; the H100 read 3.9e-3 (eps_v) and 4.5e-3 (eps_a), see PERF.md
DENOISE_REL_TOL = 1.5e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def spin_cycles_per_s() -> float:
    """Rate of torch.cuda._sleep's spin loop, in cycles per second."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / (start.elapsed_time(end) / 1e3)


def cuda_median_ms(fn, cycles_per_s: float, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, from CUDA events around each of
    `reps` calls. A spin kernel holds the stream while the host enqueues all
    of them, so the events time the device work back to back and not the
    host's gaps between launches (a call's host cost is comparable to the
    kernel's time at the mvp shape)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    enqueue_s = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        enqueue_s = max(enqueue_s, time.perf_counter() - t0)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(int(cycles_per_s * (0.005 + 3 * reps * enqueue_s)))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def attention_bound_ms(shape, dtype_name: str, n_valid_keys: list, masked: bool):
    """Least time for the function on this card: each input read once and each
    output written once, against 4*H*N*Dh*sum_b(valid keys of row b) FLOPs."""
    B, H, N, Dh = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * B * H * N * Dh * elt + B * H * N * 4 + (B * N if masked else 0)
    flops = 4 * H * N * Dh * sum(n_valid_keys)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(fa):
    import torch
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cycles_per_s = spin_cycles_per_s()
    results = {}
    for case_idx, (name, shape, n_masked) in enumerate(KERNEL_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            B, H, N, Dh = shape
            g = torch.Generator(device=dev).manual_seed(case_idx)
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(3))
            valid = None
            n_valid = [N] * B
            if n_masked:
                valid = torch.ones((B, N), dtype=torch.bool, device=dev)
                valid[0, N - n_masked:] = False
                n_valid[0] = N - n_masked
            out, lse = fa.flash_forward(q, k, v, valid)
            ref_out, ref_lse = fa.flash_forward_reference(q, k, v, valid)
            torch.cuda.synchronize()
            err_out = float((out.float() - ref_out.float()).abs().max())
            err_lse = float((lse - ref_lse).abs().max())
            tol = TOL[dname]
            if not (err_out <= tol["out"] and err_lse <= tol["lse"]):
                raise AssertionError(f"{name} {dname}: kernel disagrees with its plain "
                                     f"version: out {err_out} lse {err_lse} (tol {tol})")
            if n_masked == N and not bool((out[0] == 0).all()):
                raise AssertionError(f"{name} {dname}: a fully masked row is not exactly 0")
            mask4 = None if valid is None else valid[:, None, None, :]
            ms = cuda_median_ms(lambda: fa.flash_forward(q, k, v, valid), cycles_per_s)
            plain_ms = cuda_median_ms(lambda: fa.flash_forward_reference(q, k, v, valid),
                                      cycles_per_s)
            library_ms = cuda_median_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4),
                cycles_per_s)
            bound_ms, bound_by = attention_bound_ms(shape, dname, n_valid, valid is not None)
            rec = {"phase": "kernel", "kernel": "flash_fwd", "case": name,
                   "shape": list(shape), "dtype": dname, "masked_keys": n_masked,
                   "max_abs_err_out": err_out, "max_abs_err_lse": err_lse, "tol": tol,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_share": bound_ms / ms}
            emit(rec)
            results[(name, dname)] = rec
    return results


def v2a_phase(fa):
    import numpy as np
    import torch

    from multimodal_diffusion_torch.tools.profile_v2a import v2a_workload
    from multimodal_diffusion_torch.utils.io import latent_shapes_from_config

    t0 = time.perf_counter()
    cfg, model, run = v2a_workload(V2A_CLIPS, V2A_STEPS)
    setup_s = time.perf_counter() - t0

    fa.flash_forward.launches = 0
    t0 = time.perf_counter()
    out = run()
    first_s = time.perf_counter() - t0
    launches = fa.flash_forward.launches
    wav = out["audio"]
    expected = V2A_STEPS * cfg["model"]["core"]["n_layers"]
    if launches != expected:
        raise AssertionError(f"flash_fwd launched {launches} times on the v2a path, "
                             f"expected {expected}")
    L = latent_shapes_from_config(cfg, V2A_CLIPS)["audio"][-1]
    if wav.shape != (V2A_CLIPS, L) or not np.all(np.isfinite(wav)) or np.abs(wav).max() > 1:
        raise AssertionError(f"bad v2a output: shape {wav.shape}, finite "
                             f"{np.all(np.isfinite(wav))}, max |x| {np.abs(wav).max()}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    batch_s = statistics.median(times)

    # one full-width denoiser forward, kernel vs dense attention (bf16)
    rng = np.random.default_rng(0)
    B2 = 2 * V2A_CLIPS
    tok_v = torch.from_numpy(rng.normal(size=(B2, 96, 256)).astype(np.float32)).cuda()
    tok_a = torch.from_numpy(rng.normal(size=(B2, 37, 32)).astype(np.float32)).cuda()
    t_v = torch.zeros(B2, dtype=torch.long, device="cuda")
    t_a = torch.from_numpy(rng.integers(0, 1000, B2)).cuda()
    keep = torch.cat([torch.ones(V2A_CLIPS), torch.zeros(V2A_CLIPS)]).cuda()
    with torch.inference_mode():
        a = model.denoise_tokens(tok_v, tok_a, t_v, t_a, (6, 4, 4), keep, None, use_kernel=True)
        b = model.denoise_tokens(tok_v, tok_a, t_v, t_a, (6, 4, 4), keep, None, use_kernel=False)
    rel = {key: float((a[key].float() - b[key].float()).abs().max()
                      / b[key].float().abs().max()) for key in ("eps_v", "eps_a")}
    if max(rel.values()) > DENOISE_REL_TOL:
        raise AssertionError(f"denoise_tokens kernel vs dense: {rel} > {DENOISE_REL_TOL}")

    emit({"phase": "v2a", "config": "mvp+v2a", "clips": V2A_CLIPS, "steps": V2A_STEPS,
          "compute_dtype": "bfloat16", "setup_s": setup_s, "first_batch_s": first_s,
          "batch_s": times, "median_batch_s": batch_s,
          "clips_per_s": V2A_CLIPS / batch_s, "flash_fwd_launches": launches,
          "wav_shape": list(wav.shape), "wav_max_abs": float(np.abs(wav).max()),
          "denoise_kernel_vs_dense_rel_err": rel, "rel_tol": DENOISE_REL_TOL,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from multimodal_diffusion_torch.ops import flash_attention as fa

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0], "kind": kind,
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    lib = fa.build()
    fa._library()
    log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
    emit({"phase": "build", "library": lib.name, "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    cases = kernel_phase(fa)
    launches = v2a_phase(fa)

    mvp = cases[("mvp", "bfloat16")]
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "multimodal_diffusion_torch/csrc/flash_fwd.cu",
        "replaces": "multimodal_diffusion_tpu/ops/flash_attention.py:49",
        "launches": launches, "max_abs_err": mvp["max_abs_err_out"],
        "ms": mvp["ms"], "plain_ms": mvp["plain_ms"], "bound_ms": mvp["bound_ms"],
        "bound_by": mvp["bound_by"], "library_ms": mvp["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
