#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py            # from the repo root, one CUDA card

Phases, one JSON line each (any failure raises and exits non-zero):
  1. device  — the card (nvidia-smi name, power limit), torch and CUDA versions;
  2. build   — nvcc builds multimodal_diffusion_torch/csrc/flash_fwd.cu and
               csrc/flash_bwd.cu, one nvcc each, started together; their
               registers and spills, and the bf16 backward kernels' shared
               memory per block and blocks per SM;
  3. kernel  — the flash-attention forward kernel against its plain PyTorch
               version (out and lse), then the two backward kernels (dK/dV,
               dQ) against theirs (dq, dk, dv), at the mvp sampling and
               training, flagship and t2i shapes, masked and unmasked, bf16
               and fp32 (TF32 off), with each kernel's time, the plain
               version's, SDPA's forward or backward (a yardstick the port
               never calls) and the least time the card could take; two
               backward calls must give bit-identical grads; the backward
               pair again with the train step's strides (head views of a
               fused qkv buffer, dO a [B, N, H, Dh] buffer) and, untimed, at
               the 16-row edges N = 15, 16, 17, 145, masked and unmasked;
  4. v2a     — sampling at mvp full width through the public entry point
               (build_components + sample_one_direction): B=8 clips, 50 DDIM
               steps with batched CFG, seeded N(0, 0.02) weights, bf16 compute;
               the forward kernel must launch exactly 50 x 8 = 400 times; one
               denoise_tokens forward with and without the kernel must agree;
  5. train   — the mvp train step at full width through create_trainer +
               run_training (the bench.py --task train workload: B=8, bf16
               compute, fp32 parameters, AdamW + EMA, targets from the
               Any2AnySchedule): 2 warm-up steps, then 10 timed steps in which
               each of the three kernels must launch exactly 8 times per step;
               finite losses, parameters that stay put at LR 0 and move after,
               an EMA that moves, and one full-width gradient with and without
               the kernels that agree.
Then a `kernels` line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. The device time by kernel of one v2a batch is
`python -m multimodal_diffusion_torch.tools.profile_v2a`, of one train step
`python -m multimodal_diffusion_torch.tools.profile_train`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# (name, [B, H, N, Dh], masked keys in batch row 0): the mvp sampling call
# (CFG-doubled batch 16), the mvp train step (batch 8), the flagship training
# shape, the t2i-512 core (1152 padded from 1101: 51 keys masked), and one
# batch row fully masked
KERNEL_CASES = [
    ("mvp", (16, 8, 133, 64), 0),
    ("mvp_train", (8, 8, 133, 64), 0),
    ("flagship", (8, 8, 421, 128), 0),
    ("t2i", (2, 4, 1152, 128), 51),
    ("all_masked_row", (2, 8, 133, 64), 133),
]
TOL = {"float32": {"out": 1e-4, "lse": 1e-4}, "bfloat16": {"out": 2e-2, "lse": 1e-3}}
# backward kernels vs their plain version: max |diff| / max(1, max |plain|)
# over dq, dk, dv. fp32 sums in another order; in bf16 both round P and dS
# to bf16, and another fp32 sum order can flip one rounding by an ulp (2^-8)
# (the H100 read <= 6.0e-7 in fp32 and <= 2.8e-3 in bf16, see PERF.md)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the mvp train step's attention operands, and sequence lengths around the
# 16-row pieces the tensor-core backward kernels work in
BWD_STRIDED_SHAPE = (8, 8, 133, 64)
BWD_EDGE_N = (15, 16, 17, 145)
V2A_CLIPS, V2A_STEPS = 8, 50
TRAIN_CLIPS, TRAIN_WARMUP, TRAIN_STEPS = 8, 2, 10
# one full-width train-loss gradient (eval mode, fixed batch and draws) with
# the kernels vs dense attention, bf16: max |diff| / max |dense| over every
# qkv weight grad, and the relative difference of the global grad norm. The
# kernels round dS to bf16 where dense autograd keeps fp32; the H100 read
# 7.8e-3 (two bf16 ulps, 2^-7) on the qkv grads and 2.2e-4 on the norm, see
# PERF.md
GRAD_REL_TOL = 2.5e-2
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


def attention_bwd_bound_ms(kernel: str, shape, dtype_name: str, n_valid_keys: list,
                           masked: bool):
    """The same for a backward kernel: dK/dV reads q, dO, k, v, lse, D and
    writes dk, dv (4 products: S, dP, dV, dK); dQ reads the same and writes
    dq (3 products: S, dP, dQ)."""
    B, H, N, Dh = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    tensors, products = (6, 4) if kernel == "dkdv" else (5, 3)
    nbytes = tensors * B * H * N * Dh * elt + 2 * B * H * N * 4 + (B * N if masked else 0)
    flops = products * 2 * H * N * Dh * sum(n_valid_keys)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def backward_check(fa, name, q, k, v, valid, out, lse, dout, n_valid):
    """Both backward kernels against their plain version on the same inputs,
    and against themselves: a second call must give the same bits."""
    import torch

    dname = str(q.dtype).split(".")[-1]
    grads = fa.flash_backward(q, k, v, out, lse, dout, valid)
    again = fa.flash_backward(q, k, v, out, lse, dout, valid)
    refs = fa.flash_backward_reference(q, k, v, out, lse, dout, valid)
    torch.cuda.synchronize()
    errs = {gname: float((a.float() - b.float()).abs().max()) for gname, a, b in
            zip(("dq", "dk", "dv"), grads, refs)}
    rel = max(float((a.float() - b.float()).abs().max()) / max(1.0, float(b.float().abs().max()))
              for a, b in zip(grads, refs))
    if not rel <= BWD_TOL[dname]:
        raise AssertionError(f"{name} {dname}: backward kernels disagree with their plain "
                             f"version: {errs}, relative {rel} (tol {BWD_TOL[dname]})")
    if not all(bool(torch.isfinite(x.float()).all()) for x in grads):
        raise AssertionError(f"{name} {dname}: non-finite grads")
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{name} {dname}: two backward calls differ")
    if n_valid[0] == 0 and not all(bool((x[0] == 0).all()) for x in grads):
        raise AssertionError(f"{name} {dname}: a fully masked row's grads are not exactly 0")
    return errs, rel


def backward_case(fa, name, q, k, v, valid, out, lse, dout, n_valid, cycles_per_s):
    """The two backward kernels at one case: checked (backward_check), then
    timed alone, beside the plain version and SDPA's backward
    (torch.autograd.grad of its output with the same dO)."""
    import torch
    import torch.nn.functional as F

    dtype = q.dtype
    dname = str(dtype).split(".")[-1]
    shape = B, H, N, Dh = tuple(q.shape)
    errs, rel = backward_check(fa, name, q, k, v, valid, out, lse, dout, n_valid)
    delta = (dout.float() * out.float()).sum(dim=-1)
    buf = torch.empty((B, N, 3, H, Dh), dtype=dtype, device=q.device)
    ms = {kernel: cuda_median_ms(lambda kernel=kernel: fa.launch_backward_kernel(
        kernel, q, k, v, dout, lse, delta, valid, buf), cycles_per_s) for kernel in ("dkdv", "dq")}
    plain_ms = cuda_median_ms(
        lambda: fa.flash_backward_reference(q, k, v, out, lse, dout, valid, delta), cycles_per_s)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(
        *leaves, attn_mask=None if valid is None else valid[:, None, None, :])
    library_ms = cuda_median_ms(
        lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True), cycles_per_s)
    recs = {}
    for kernel in ("dkdv", "dq"):
        bound_ms, bound_by = attention_bwd_bound_ms(kernel, shape, dname, n_valid,
                                                    valid is not None)
        rec = {"phase": "kernel", "kernel": f"flash_bwd_{kernel}", "case": name,
               "shape": list(shape), "dtype": dname, "masked_keys": N * B - sum(n_valid),
               "max_abs_err": errs, "rel_err": rel, "tol": BWD_TOL[dname],
               "repeat_bit_identical": True,
               "ms": ms[kernel], "pair_ms": ms["dkdv"] + ms["dq"], "plain_pair_ms": plain_ms,
               "library_pair_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms[kernel]}
        emit(rec)
        recs[kernel] = rec
    return recs


def backward_stride_and_edge_cases(fa, cycles_per_s):
    """The backward pair with the operands the train step hands it (q, k, v
    head views of one fused qkv buffer [B, N, 3, H, Dh], dO a [B, N, H, Dh]
    buffer), checked and timed; then, checked only, at the edges of the
    tensor-core kernels' 16-row pieces, masked and unmasked, bf16 and fp32."""
    import torch

    dev = torch.device("cuda")
    B, H, N, Dh = BWD_STRIDED_SHAPE
    g = torch.Generator(device=dev).manual_seed(50)
    qkv = torch.randn((B, N, 3, H, Dh), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    dout = torch.randn((B, N, H, Dh), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
    out, lse = fa.flash_forward(q, k, v)
    backward_case(fa, "mvp_train_qkv_strides", q, k, v, None, out, lse, dout, [N] * B,
                  cycles_per_s)

    for N in BWD_EDGE_N:
        for n_masked in (0, min(5, N - 1)):
            for dtype in (torch.bfloat16, torch.float32):
                shape = (2, 8, N, 64)
                g = torch.Generator(device=dev).manual_seed(60 + N)
                q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(dtype)
                                 for _ in range(4))
                valid, n_valid = None, [N, N]
                if n_masked:
                    valid = torch.ones((2, N), dtype=torch.bool, device=dev)
                    valid[0, N - n_masked:] = False
                    n_valid[0] = N - n_masked
                out, lse = fa.flash_forward(q, k, v, valid)
                name, dname = f"edge_n{N}", str(dtype).split(".")[-1]
                errs, rel = backward_check(fa, name, q, k, v, valid, out, lse, dout, n_valid)
                emit({"phase": "kernel", "kernel": "flash_bwd_pair", "case": name,
                      "shape": list(shape), "dtype": dname, "masked_keys": n_masked,
                      "max_abs_err": errs, "rel_err": rel, "tol": BWD_TOL[dname],
                      "repeat_bit_identical": True})


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
            gd = torch.Generator(device=dev).manual_seed(100 + N)
            dout = torch.randn(shape, generator=gd, device=dev).to(dtype)
            for kernel, brec in backward_case(fa, name, q, k, v, valid, out, lse, dout,
                                              n_valid, cycles_per_s).items():
                results[(name, dname, kernel)] = brec
    backward_stride_and_edge_cases(fa, cycles_per_s)
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


def train_phase(fa):
    """The mvp train step at full width through create_trainer + run_training."""
    import numpy as np
    import torch

    from multimodal_diffusion_torch.tools.profile_train import train_workload
    from multimodal_diffusion_torch.train import trainer as TT

    t0 = time.perf_counter()
    cfg, bundle, batch, run = train_workload(TRAIN_CLIPS)
    setup_s = time.perf_counter() - t0
    params = list(bundle.model.parameters())
    before = [p.detach().clone() for p in params]
    t0 = time.perf_counter()
    run(1)  # optax semantics: the first update reads LR(0) = 0 in warmup
    if any(not torch.equal(p, b) for p, b in zip(params, before)):
        raise AssertionError("a parameter moved in the first step, at LR 0")
    run(TRAIN_WARMUP - 1)
    warmup_s = time.perf_counter() - t0
    if all(torch.equal(p, b) for p, b in zip(params, before)):
        raise AssertionError("no parameter moved after a step with a nonzero LR")
    del before
    ema_before = {k: v.clone() for k, v in bundle.state.ema.items()}

    fa.flash_forward.launches = 0
    fa.flash_backward.dkdv_launches = fa.flash_backward.dq_launches = 0
    torch.cuda.reset_peak_memory_stats()
    logs = []
    run(TRAIN_STEPS, log_fn=lambda step, m: logs.append(m))
    launches = {"flash_fwd": fa.flash_forward.launches,
                "flash_bwd_dkdv": fa.flash_backward.dkdv_launches,
                "flash_bwd_dq": fa.flash_backward.dq_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = TRAIN_STEPS * cfg["model"]["core"]["n_layers"]
    if any(n != expected for n in launches.values()):
        raise AssertionError(f"kernel launches on the train path {launches}, expected "
                             f"{expected} each")
    if len(logs) != TRAIN_STEPS:
        raise AssertionError(f"{len(logs)} logged steps, expected {TRAIN_STEPS}")
    for m in logs:
        if not all(np.isfinite([m["loss"], m["grad_norm"]])):
            raise AssertionError(f"non-finite loss or grad_norm: {m}")
    if all(torch.equal(v, ema_before[k]) for k, v in bundle.state.ema.items()):
        raise AssertionError("the EMA shadow did not move")
    del ema_before
    step_s = [1.0 / m["steps_per_sec"] for m in logs]
    median_s = statistics.median(step_s)

    # one full-width gradient of the train loss, eval mode (no dropout), fixed
    # batch and draws, with the kernels and with dense attention
    model = bundle.model.eval()
    sc = bundle.step_config
    draws = TT.draw_step_randomness(torch.Generator(device="cuda").manual_seed(7), sc)
    dev_batch = TT.batch_to_device(batch, bundle.device)
    grads = {}
    for use_kernel in (True, False):
        loss, _ = TT.train_loss(model, dataclasses.replace(sc, use_kernel=use_kernel),
                                bundle.abar_v, bundle.abar_a, dev_batch, 0.0, draws)
        named = [(n, p) for n, p in model.named_parameters()]
        gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        grads[use_kernel] = {n: g for (n, _), g in zip(named, gs) if g is not None}
    model.train()
    qkv = [n for n in grads[False] if n.endswith("attn.qkv.weight")]
    qkv_rel = max(float((grads[True][n] - grads[False][n]).abs().max())
                  / float(grads[False][n].abs().max()) for n in qkv)
    norms = {k: float(TT.global_norm(list(g.values()))) for k, g in grads.items()}
    norm_rel = abs(norms[True] - norms[False]) / norms[False]
    if len(qkv) != cfg["model"]["core"]["n_layers"] or max(qkv_rel, norm_rel) > GRAD_REL_TOL:
        raise AssertionError(f"train grads with the kernels vs dense: qkv {qkv_rel}, "
                             f"norm {norm_rel} (tol {GRAD_REL_TOL}, {len(qkv)} qkv grads)")
    del grads

    emit({"phase": "train", "config": "mvp", "clips": TRAIN_CLIPS,
          "compute_dtype": "bfloat16", "setup_s": setup_s, "warmup_steps": TRAIN_WARMUP,
          "warmup_s": warmup_s, "step_s": step_s, "median_step_s": median_s,
          "train_clips_per_s": TRAIN_CLIPS / median_s,
          "first_loss": logs[0]["loss"], "last_loss": logs[-1]["loss"],
          "grad_norms": [m["grad_norm"] for m in logs], "launches": launches,
          "launches_expected": expected,
          "grad_check": {"qkv_weight_rel_err": qkv_rel, "grad_norm_rel_err": norm_rel,
                         "grad_norm_kernel": norms[True], "grad_norm_dense": norms[False],
                         "rel_tol": GRAD_REL_TOL},
          "peak_mem_gb": peak_gb})
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
    names = list(fa.SOURCES)
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, together
        libs = dict(zip(names, pool.map(fa.build, names)))
    built = {}
    for name, lib in libs.items():
        fa._library(name)
        log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
        built[name] = {"library": lib.name, "ptxas": [
            ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libraries": built,
          "backward_bf16_occupancy": fa.backward_occupancy()})

    cases = kernel_phase(fa)
    v2a_launches = v2a_phase(fa)
    train_launches = train_phase(fa)

    mvp = cases[("mvp", "bfloat16")]
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "multimodal_diffusion_torch/csrc/flash_fwd.cu",
        "replaces": "multimodal_diffusion_tpu/ops/flash_attention.py:49",
        "launches": v2a_launches + train_launches["flash_fwd"],
        "launches_by_path": {"v2a": v2a_launches, "train": train_launches["flash_fwd"]},
        "max_abs_err": mvp["max_abs_err_out"], "ms": mvp["ms"], "plain_ms": mvp["plain_ms"],
        "bound_ms": mvp["bound_ms"], "bound_by": mvp["bound_by"],
        "library_ms": mvp["library_ms"]}]
    for kernel, line in (("dkdv", 205), ("dq", 276)):
        rec = cases[("mvp_train", "bfloat16", kernel)]
        name = f"flash_bwd_{kernel}"
        # plain_ms and library_ms time the pair (the plain version and SDPA's
        # backward compute dq, dk and dv together)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "multimodal_diffusion_torch/csrc/flash_bwd.cu",
            "replaces": f"multimodal_diffusion_tpu/ops/flash_attention.py:{line}",
            "launches": train_launches[name], "launches_by_path": {"train": train_launches[name]},
            "max_abs_err": max(rec["max_abs_err"].values()), "ms": rec["ms"],
            "plain_ms": rec["plain_pair_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_pair_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
