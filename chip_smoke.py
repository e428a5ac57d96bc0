#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py            # from the repo root, one CUDA card

Phases, one JSON line each (any failure raises and exits non-zero):
  1. device  — the card (nvidia-smi name, power limit), torch and CUDA versions;
  2. build   — nvcc builds multimodal_diffusion_torch/csrc/flash_fwd.cu and
               csrc/flash_bwd.cu, one nvcc each, started together; their
               registers and spills, and the bf16 kernels' shared memory per
               block and blocks per SM;
  3. kernel  — the timing method's floor (the device time it reads for the
               smallest launches); the flash-attention forward kernel against
               its plain PyTorch version (out and lse), then the two backward
               kernels (dK/dV, dQ) against theirs (dq, dk, dv), at the mvp
               sampling and training, flagship training and sampling and t2i
               shapes, masked and unmasked, bf16 and fp32 (TF32 off), with each
               kernel's time, the plain version's, SDPA's forward or backward
               (a yardstick the port never calls) and the least time the card
               could take; two calls of a kernel must give the same bits; the
               forward with the sampler's strides and the backward pair with
               the train step's (head views of a fused qkv buffer, dO a
               [B, N, H, Dh] buffer), at mvp and at flagship width (the
               guided sampler's backward has the train step's strides); all
               three, untimed, at the 16-row edges N = 15, 16, 17, 145, masked
               and unmasked; the forward at N = 128, 133, 192 (what the ragged
               edge costs);
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
               the kernels that agree;
  6. spec8_train — the flagship (specificity8: d=1024, 16 layers, 8 heads of
               128, patch VideoVAE, 288 mouth-crop tokens, N = 421) train step
               the same way: B=8, bf16 moments, reconstruction every 8th step;
               2 warm-up steps, then 16 timed steps, two of them with the
               decode: exactly 16 launches of each kernel per step, loss_recon
               > 0 on exactly the decode steps, finite losses, and one
               full-width gradient of a decode step with and without the
               kernels that agree and reach the encoders;
  7. spec8_v2a — flagship sampling through build_components +
               sample_one_direction: B=8, 50 DDIM steps, batched CFG, mouth
               tokens cut from the frames: exactly 50 x 16 = 800 forward
               launches; one denoise_tokens forward with mouth tokens, with
               and without the kernel, must agree;
  8. spec8_v2a_guided — the same batch with sync guidance (scale 0.5, source
               mouth), once under ddim and once under dpmpp_2m: per batch 1600
               forward launches and 800 of each backward kernel (the gradient
               w.r.t. the audio latent runs through them), an output that
               differs from the unguided one, no parameter left with a .grad;
  9. spec8_cli_resident — the train_joint CLI (train/train_joint.py main, in
               this process) with configs/mvp.yaml + configs/specificity8.yaml
               and an overlay, on a corpus of 512 flagship-sized clips
               (uint8 video [48, 128, 128, 3], float32 audio [48000], a few
               without video or audio; 4 .avrec shards, ~1.3 GB) written here
               with the port's write_record_shards; 384 of them, strided
               across the shards, resident on the card: 8 steps, then
               --resume to step 12. Exactly 16 launches of each kernel per
               step, finite losses and grad norms, every batch a CUDA uint8
               tensor with no host-to-device batch copy, the restored state
               bit-equal to step 8's (params, moments, EMA, generator),
               checkpoints at 8 and 12, an EMA that moves; upload, step,
               save and restore times and peak memory;
 10. spec8_cli_streamed — the same shards streamed (device_resident false):
               the DataLoader's threads collate, device_prefetch copies each
               batch on a side stream; 6 steps with the same gates, every
               batch copied once.
Then a `kernels` line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. The device time by kernel of one v2a batch is
`python -m multimodal_diffusion_torch.tools.profile_v2a`, of one train step
`python -m multimodal_diffusion_torch.tools.profile_train` (each takes
`--config specificity8`).
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
# (CFG-doubled batch 16), the mvp train step (batch 8), the flagship train
# step and guided forward (batch 8), the flagship sampling call (batch 16),
# the t2i-512 core (1152 padded from 1101: 51 keys masked), and one batch row
# fully masked
KERNEL_CASES = [
    ("mvp", (16, 8, 133, 64), 0),
    ("mvp_train", (8, 8, 133, 64), 0),
    ("flagship", (8, 8, 421, 128), 0),
    ("flagship_sample", (16, 8, 421, 128), 0),
    ("t2i", (2, 4, 1152, 128), 51),
    ("all_masked_row", (2, 8, 133, 64), 133),
]
TOL = {"float32": {"out": 1e-4, "lse": 1e-4}, "bfloat16": {"out": 2e-2, "lse": 1e-3}}
# backward kernels vs their plain version: max |diff| / max(1, max |plain|)
# over dq, dk, dv. fp32 sums in another order; in bf16 both round P and dS
# to bf16, and another fp32 sum order can flip one rounding by an ulp (2^-8)
# (the H100 read <= 6.0e-7 in fp32 and <= 2.8e-3 in bf16, see PERF.md)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the attention operands of the mvp sampler (CFG-doubled batch) and of the mvp
# train step, sequence lengths around the 16-row pieces the tensor-core
# kernels work in, and lengths around the 64-row tiles (mvp has N = 133)
FWD_STRIDED_SHAPE = (16, 8, 133, 64)
BWD_STRIDED_SHAPE = (8, 8, 133, 64)
# (name, shape, backward too): fused-qkv head views at mvp and flagship width;
# the flagship train step and the guided sampler's B-sized forward + backward
# share one shape and one set of strides
STRIDED_CASES = [
    ("mvp_qkv_strides", FWD_STRIDED_SHAPE, False),
    ("mvp_train_qkv_strides", BWD_STRIDED_SHAPE, True),
    ("flagship_sample_qkv_strides", (16, 8, 421, 128), False),
    ("flagship_train_qkv_strides", (8, 8, 421, 128), True),
]
EDGE_N = (15, 16, 17, 145)
RAGGED_N = (128, 133, 192)
V2A_CLIPS, V2A_STEPS = 8, 50
TRAIN_CLIPS, TRAIN_WARMUP, TRAIN_STEPS = 8, 2, 10
SPEC8_TRAIN_STEPS = 16  # after TRAIN_WARMUP: steps 3..18, the decode on 8 and 16
SYNC_GUIDANCE = {"sync_guidance_scale": 0.5, "sync_guidance_source": "mouth"}
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
# the same two checks at flagship width: 16 layers round twice as often as
# mvp's 8, so errors that add like a random walk grow by about sqrt(2): the
# gradient (of a decode step) gets 3e-2 and the denoiser forward (with mouth
# tokens) 2e-2 on eps_v and eps_a. h_m, the mouth tokens' features, is the
# final norm's bf16 output before any head, 288 rows a sample: its largest
# difference is a few bf16 ulps (2^-8 each) of its largest magnitude, 4e-2;
# readings in PERF.md
SPEC8_GRAD_REL_TOL = 3e-2
SPEC8_DENOISE_REL_TOL = {"eps_v": 2e-2, "eps_a": 2e-2, "h_m": 4e-2}
# the CLI phases' corpus: flagship-sized clips, a few without video or audio
CLI_CLIPS, CLI_CLIPS_PER_SHARD, CLI_RESIDENT_CLIPS = 512, 128, 384
CLI_NO_VIDEO, CLI_NO_AUDIO = (17, 200, 401), (5, 130, 333, 470)
CLI_STEPS, CLI_RESUME_STEPS, CLI_STREAMED_STEPS = 8, 12, 6


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


def forward_check(fa, name, q, k, v, valid, n_valid):
    """The forward kernel against its plain version on the same inputs (out
    and lse), and against itself: a second call must give the same bits."""
    import torch

    dname = str(q.dtype).split(".")[-1]
    out, lse = fa.flash_forward(q, k, v, valid)
    again = fa.flash_forward(q, k, v, valid)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, valid)
    torch.cuda.synchronize()
    err_out = float((out.float() - ref_out.float()).abs().max())
    err_lse = float((lse - ref_lse).abs().max())
    tol = TOL[dname]
    if not (err_out <= tol["out"] and err_lse <= tol["lse"]):
        raise AssertionError(f"{name} {dname}: kernel disagrees with its plain "
                             f"version: out {err_out} lse {err_lse} (tol {tol})")
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError(f"{name} {dname}: two forward calls differ")
    if n_valid[0] == 0 and not bool((out[0] == 0).all()):
        raise AssertionError(f"{name} {dname}: a fully masked row is not exactly 0")
    return out, lse, err_out, err_lse


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


def forward_case(fa, name, q, k, v, valid, n_valid, cycles_per_s):
    """The forward kernel at one case: checked (forward_check), then timed
    beside the plain version and SDPA's forward."""
    import torch.nn.functional as F

    dname = str(q.dtype).split(".")[-1]
    shape = tuple(q.shape)
    out, lse, err_out, err_lse = forward_check(fa, name, q, k, v, valid, n_valid)
    mask4 = None if valid is None else valid[:, None, None, :]
    ms = cuda_median_ms(lambda: fa.flash_forward(q, k, v, valid), cycles_per_s)
    plain_ms = cuda_median_ms(lambda: fa.flash_forward_reference(q, k, v, valid), cycles_per_s)
    library_ms = cuda_median_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4), cycles_per_s)
    bound_ms, bound_by = attention_bound_ms(shape, dname, n_valid, valid is not None)
    rec = {"phase": "kernel", "kernel": "flash_fwd", "case": name,
           "shape": list(shape), "dtype": dname,
           "masked_keys": shape[2] * shape[0] - sum(n_valid),
           "max_abs_err_out": err_out, "max_abs_err_lse": err_lse, "tol": TOL[dname],
           "repeat_bit_identical": True,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms}
    emit(rec)
    return out, lse, rec


def timing_floor(fa, cycles_per_s):
    """What cuda_median_ms reads for the smallest launches it can make: a
    one-element fill, and each flash_forward kernel on one query and one key.
    A kernel's share of its bound is best read net of this."""
    import torch

    dev = torch.device("cuda")
    one = torch.zeros(1, device=dev)
    floor = {"fill_1_element_ms": cuda_median_ms(lambda: one.fill_(1.0), cycles_per_s)}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.ones((1, 1, 1, 32), dtype=dtype, device=dev)
        dname = str(dtype).split(".")[-1]
        floor[f"flash_fwd_1x1x1x32_{dname}_ms"] = cuda_median_ms(
            lambda: fa.flash_forward(q, q, q), cycles_per_s)
    emit({"phase": "kernel", "timing_floor": floor})


def stride_and_edge_cases(fa, cycles_per_s):
    """The forward with the operands the sampler hands it and the backward
    pair with the train step's (q, k, v head views of one fused qkv buffer
    [B, N, 3, H, Dh], dO a [B, N, H, Dh] buffer), checked and timed; then,
    checked only, all three at the edges of the tensor-core kernels' 16-row
    pieces, masked and unmasked, bf16 and fp32; then the forward timed at
    sequence lengths around its 64-row tiles."""
    import torch

    dev = torch.device("cuda")
    for name, shape, with_backward in STRIDED_CASES:
        B, H, N, Dh = shape
        g = torch.Generator(device=dev).manual_seed(50)
        qkv = torch.randn((B, N, 3, H, Dh), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out, lse, _ = forward_case(fa, name, q, k, v, None, [N] * B, cycles_per_s)
        if with_backward:
            dout = torch.randn((B, N, H, Dh), generator=g, device=dev).to(
                torch.bfloat16).transpose(1, 2)
            backward_case(fa, name, q, k, v, None, out, lse, dout, [N] * B, cycles_per_s)

    for N in EDGE_N:
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
                name, dname = f"edge_n{N}", str(dtype).split(".")[-1]
                out, lse, err_out, err_lse = forward_check(fa, name, q, k, v, valid, n_valid)
                emit({"phase": "kernel", "kernel": "flash_fwd", "case": name,
                      "shape": list(shape), "dtype": dname, "masked_keys": n_masked,
                      "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
                      "tol": TOL[dname], "repeat_bit_identical": True})
                errs, rel = backward_check(fa, name, q, k, v, valid, out, lse, dout, n_valid)
                emit({"phase": "kernel", "kernel": "flash_bwd_pair", "case": name,
                      "shape": list(shape), "dtype": dname, "masked_keys": n_masked,
                      "max_abs_err": errs, "rel_err": rel, "tol": BWD_TOL[dname],
                      "repeat_bit_identical": True})

    ragged = {}
    for N in RAGGED_N:
        B, H, _, Dh = FWD_STRIDED_SHAPE
        g = torch.Generator(device=dev).manual_seed(70)
        q, k, v = (torch.randn((B, H, N, Dh), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        ragged[f"n{N}_ms"] = cuda_median_ms(lambda: fa.flash_forward(q, k, v), cycles_per_s)
    emit({"phase": "kernel", "kernel": "flash_fwd", "case": "ragged_edge",
          "shape": [FWD_STRIDED_SHAPE[0], FWD_STRIDED_SHAPE[1], list(RAGGED_N), 64],
          "dtype": "bfloat16", **ragged})


def kernel_phase(fa):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cycles_per_s = spin_cycles_per_s()
    timing_floor(fa, cycles_per_s)
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
            out, lse, rec = forward_case(fa, name, q, k, v, valid, n_valid, cycles_per_s)
            results[(name, dname)] = rec
            gd = torch.Generator(device=dev).manual_seed(100 + N)
            dout = torch.randn(shape, generator=gd, device=dev).to(dtype)
            for kernel, brec in backward_case(fa, name, q, k, v, valid, out, lse, dout,
                                              n_valid, cycles_per_s).items():
                results[(name, dname, kernel)] = brec
    stride_and_edge_cases(fa, cycles_per_s)
    return results


def v2a_phase(fa):
    import numpy as np
    import torch

    from multimodal_diffusion_torch.tools.profile_v2a import v2a_workload

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
    check_wav(wav, cfg, "v2a")

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

    reset_launch_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    logs = []
    run(TRAIN_STEPS, log_fn=lambda step, m: logs.append(m))
    launches = launch_counts(fa)
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

    # one full-width gradient of the train loss, with the kernels and with
    # dense attention
    grads, n_qkv, qkv_rel, norms = kernel_vs_dense_grads(TT, bundle, batch)
    norm_rel = abs(norms[True] - norms[False]) / norms[False]
    if n_qkv != cfg["model"]["core"]["n_layers"] or max(qkv_rel, norm_rel) > GRAD_REL_TOL:
        raise AssertionError(f"train grads with the kernels vs dense: qkv {qkv_rel}, "
                             f"norm {norm_rel} (tol {GRAD_REL_TOL}, {n_qkv} qkv grads)")
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


def reset_launch_counts(fa) -> None:
    fa.flash_forward.launches = 0
    fa.flash_backward.dkdv_launches = fa.flash_backward.dq_launches = 0


def launch_counts(fa) -> dict:
    return {"flash_fwd": fa.flash_forward.launches,
            "flash_bwd_dkdv": fa.flash_backward.dkdv_launches,
            "flash_bwd_dq": fa.flash_backward.dq_launches}


def kernel_vs_dense_grads(TT, bundle, batch, with_recon=None):
    """One full-width gradient of the train loss (eval mode: no dropout; a
    fixed batch and draws; audio the target) with the kernels and with dense
    attention: {use_kernel: {parameter name: grad}}, the largest relative
    difference over the qkv weight grads, and that of the global grad norm."""
    import torch

    model = bundle.model.eval()
    sc = bundle.step_config
    draws = TT.draw_step_randomness(torch.Generator(device="cuda").manual_seed(7), sc)
    dev_batch = TT.batch_to_device(batch, bundle.device)
    grads = {}
    for use_kernel in (True, False):
        loss, _ = TT.train_loss(model, dataclasses.replace(sc, use_kernel=use_kernel),
                                bundle.abar_v, bundle.abar_a, dev_batch, 0.0, draws, with_recon)
        named = [(n, p) for n, p in model.named_parameters()]
        gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        grads[use_kernel] = {n: g for (n, _), g in zip(named, gs) if g is not None}
    model.train()
    qkv = [n for n in grads[False] if n.endswith("attn.qkv.weight")]
    qkv_rel = max(float((grads[True][n] - grads[False][n]).abs().max())
                  / float(grads[False][n].abs().max()) for n in qkv)
    norms = {k: float(TT.global_norm(list(g.values()))) for k, g in grads.items()}
    return grads, len(qkv), qkv_rel, norms


def spec8_train_phase(fa):
    """The flagship train step at full width through create_trainer +
    run_training."""
    import numpy as np
    import torch

    from multimodal_diffusion_torch.tools.profile_train import train_workload
    from multimodal_diffusion_torch.train import trainer as TT

    t0 = time.perf_counter()
    cfg, bundle, batch, run = train_workload(TRAIN_CLIPS, config="specificity8")
    setup_s = time.perf_counter() - t0
    sc = bundle.step_config
    if (sc.recon_every, sc.recon_weight, sc.sync_source) != (8, 1.0, "video") or \
            bundle.state.optimizer.mv_dtype != torch.bfloat16 or not bundle.model.cfg.mouth_enabled:
        raise AssertionError(f"not the flagship step: {sc}")
    t0 = time.perf_counter()
    run(TRAIN_WARMUP)
    warmup_s = time.perf_counter() - t0

    reset_launch_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    logs = []
    run(SPEC8_TRAIN_STEPS, log_fn=lambda step, m: logs.append((step, m)))
    launches = launch_counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_layers = cfg["model"]["core"]["n_layers"]
    expected = SPEC8_TRAIN_STEPS * n_layers
    if any(n != expected for n in launches.values()):
        raise AssertionError(f"kernel launches on the flagship train path {launches}, "
                             f"expected {expected} each")
    if [step for step, _ in logs] != list(range(TRAIN_WARMUP + 1,
                                                TRAIN_WARMUP + SPEC8_TRAIN_STEPS + 1)):
        raise AssertionError(f"logged steps {[step for step, _ in logs]}")
    step_s = {True: [], False: []}
    for step, m in logs:
        decode = step % sc.recon_every == 0
        if not all(np.isfinite([m[k] for k in m])):
            raise AssertionError(f"non-finite metric at step {step}: {m}")
        if (m["loss_recon"] > 0.0) != decode:
            raise AssertionError(f"step {step}: loss_recon {m['loss_recon']}, decode {decode}")
        if not (m["loss_sync"] > 0.0 and m["loss_align"] > 0.0):
            raise AssertionError(f"step {step}: the sync or alignment loss is off: {m}")
        step_s[decode].append(1.0 / m["steps_per_sec"])
    if len(step_s[True]) != 2:
        raise AssertionError(f"{len(step_s[True])} decode steps among the timed ones, expected 2")
    # a training run's mean step: K - 1 steps without the decode and one with
    # it, the latter taken from the second decode step (the first also pays
    # for the decoder's first use on the card)
    every = sc.recon_every
    mean_step_s = (statistics.median(step_s[False]) * (every - 1) + step_s[True][1]) / every

    # one full-width gradient of a decode step, kernels vs dense attention
    grads, n_qkv, qkv_rel, norms = kernel_vs_dense_grads(TT, bundle, batch, with_recon=True)
    norm_rel = abs(norms[True] - norms[False]) / norms[False]
    if n_qkv != n_layers or max(qkv_rel, norm_rel) > SPEC8_GRAD_REL_TOL:
        raise AssertionError(f"flagship train grads with the kernels vs dense: qkv {qkv_rel}, "
                             f"norm {norm_rel} (tol {SPEC8_GRAD_REL_TOL}, {n_qkv} qkv grads)")
    encoder_grads = {}
    for name in ("vid_vae.patch_embed.weight", "vid_vae.enc.0.conv.weight",
                 "aud_codec.pre0.weight"):
        g = grads[True].get(name)
        if g is None or not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0.0:
            raise AssertionError(f"no gradient reached {name} on a decode step")
        encoder_grads[name] = float(g.abs().max())
    del grads

    emit({"phase": "spec8_train", "config": "mvp+specificity8", "clips": TRAIN_CLIPS,
          "tokens": 421, "compute_dtype": "bfloat16", "moments_dtype": "bfloat16",
          "recon_every": every, "setup_s": setup_s, "warmup_steps": TRAIN_WARMUP,
          "warmup_s": warmup_s, "step_s": [1.0 / m["steps_per_sec"] for _, m in logs],
          "median_norecon_step_s": statistics.median(step_s[False]),
          "recon_step_s": step_s[True], "median_recon_step_s": statistics.median(step_s[True]),
          "warm_recon_step_s": step_s[True][1], "mean_step_s": mean_step_s,
          "train_clips_per_s": TRAIN_CLIPS / mean_step_s,
          "first_loss": logs[0][1]["loss"], "last_loss": logs[-1][1]["loss"],
          "loss_recon": [m["loss_recon"] for _, m in logs],
          "grad_norms": [m["grad_norm"] for _, m in logs], "launches": launches,
          "launches_expected": expected,
          "grad_check": {"with_recon": True, "qkv_weight_rel_err": qkv_rel,
                         "grad_norm_rel_err": norm_rel, "grad_norm_kernel": norms[True],
                         "grad_norm_dense": norms[False], "rel_tol": SPEC8_GRAD_REL_TOL,
                         "encoder_grad_max_abs": encoder_grads},
          "peak_mem_gb": peak_gb})
    return launches


def check_wav(wav, cfg, what):
    import numpy as np

    from multimodal_diffusion_torch.utils.io import latent_shapes_from_config

    L = latent_shapes_from_config(cfg, V2A_CLIPS)["audio"][-1]
    if wav.shape != (V2A_CLIPS, L) or not np.all(np.isfinite(wav)) or np.abs(wav).max() > 1:
        raise AssertionError(f"bad {what} output: shape {wav.shape}, finite "
                             f"{np.all(np.isfinite(wav))}, max |x| {np.abs(wav).max()}")


def spec8_v2a_phases(fa):
    """Flagship sampling through build_components + sample_one_direction,
    unguided (phase spec8_v2a) and sync-guided (phase spec8_v2a_guided) on
    the same model, frames and initial noise."""
    import numpy as np
    import torch

    from multimodal_diffusion_torch.tools.profile_v2a import v2a_workload

    t0 = time.perf_counter()
    cfg, model, run = v2a_workload(V2A_CLIPS, V2A_STEPS, config="specificity8")
    setup_s = time.perf_counter() - t0
    n_layers = cfg["model"]["core"]["n_layers"]
    expected = V2A_STEPS * n_layers

    reset_launch_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wav = run()["audio"]
    first_s = time.perf_counter() - t0
    launches = launch_counts(fa)
    if launches != {"flash_fwd": expected, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}:
        raise AssertionError(f"kernel launches on the flagship v2a path {launches}, expected "
                             f"{expected} forward and no backward")
    check_wav(wav, cfg, "flagship v2a")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    batch_s = statistics.median(times)

    # one full-width denoiser forward with mouth tokens, kernel vs dense (bf16)
    rng = np.random.default_rng(0)
    B2 = 2 * V2A_CLIPS
    mc = model.cfg
    mgrid = model.mouth_grid(48)
    n_mouth = mgrid[0] * mgrid[1] * mgrid[2]
    tok_v = torch.from_numpy(rng.normal(size=(B2, 96, 256)).astype(np.float32)).cuda()
    tok_a = torch.from_numpy(rng.normal(size=(B2, 37, 32)).astype(np.float32)).cuda()
    tok_m = torch.from_numpy(rng.uniform(-0.5, 0.5, size=(B2, n_mouth, mc.token_dim_mouth))
                             .astype(np.float32)).cuda()
    t_v = torch.zeros(B2, dtype=torch.long, device="cuda")
    t_a = torch.from_numpy(rng.integers(0, 1000, B2)).cuda()
    keep = torch.cat([torch.ones(V2A_CLIPS), torch.zeros(V2A_CLIPS)]).cuda()
    with torch.inference_mode():
        a, b = (model.denoise_tokens(tok_v, tok_a, t_v, t_a, (6, 4, 4), keep, None,
                                     use_kernel=use_kernel, tok_m=tok_m, keep_m=keep,
                                     mouth_grid=mgrid) for use_kernel in (True, False))
    if a["h_m"].shape != (B2, 288, 1024):
        raise AssertionError(f"h_m has shape {tuple(a['h_m'].shape)}")
    rel = {key: float((a[key].float() - b[key].float()).abs().max()
                      / b[key].float().abs().max()) for key in SPEC8_DENOISE_REL_TOL}
    if any(rel[key] > tol for key, tol in SPEC8_DENOISE_REL_TOL.items()):
        raise AssertionError(f"flagship denoise_tokens kernel vs dense: {rel} > "
                             f"{SPEC8_DENOISE_REL_TOL}")
    emit({"phase": "spec8_v2a", "config": "mvp+specificity8", "clips": V2A_CLIPS,
          "steps": V2A_STEPS, "tokens": 421, "sampler": "ddim", "compute_dtype": "bfloat16",
          "setup_s": setup_s, "first_batch_s": first_s, "batch_s": times,
          "median_batch_s": batch_s, "clips_per_s": V2A_CLIPS / batch_s,
          "launches": launches, "wav_shape": list(wav.shape),
          "wav_max_abs": float(np.abs(wav).max()),
          "denoise_kernel_vs_dense_rel_err": rel, "rel_tol": SPEC8_DENOISE_REL_TOL,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    # sync-guided: a third, B-sized forward a step and its backward w.r.t. the
    # audio latent, through the three kernels
    guided_launches = {name: 0 for name in launches}
    want = {"flash_fwd": 2 * expected, "flash_bwd_dkdv": expected, "flash_bwd_dq": expected}
    batches = {}
    torch.cuda.reset_peak_memory_stats()
    for sampler in ("ddim", "dpmpp_2m"):
        unguided = wav if sampler == "ddim" else run({"sampler": sampler})["audio"]
        reset_launch_counts(fa)
        t0 = time.perf_counter()
        guided = run({"sampler": sampler, **SYNC_GUIDANCE})["audio"]
        seconds = time.perf_counter() - t0
        got = launch_counts(fa)
        if got != want:
            raise AssertionError(f"kernel launches in a guided {sampler} batch {got}, "
                                 f"expected {want}")
        check_wav(guided, cfg, f"guided {sampler}")
        diff = float(np.abs(guided - unguided).max())
        n_differ = int((guided != unguided).sum())
        if not diff > 0.0:
            raise AssertionError(f"the guided {sampler} batch equals the unguided one")
        if any(p.grad is not None for p in model.parameters()):
            raise AssertionError("sync guidance left a .grad on a parameter")
        for name in guided_launches:
            guided_launches[name] += got[name]
        batches[sampler] = {"batch_s": seconds, "clips_per_s": V2A_CLIPS / seconds,
                            "launches": got, "max_abs_diff_from_unguided": diff,
                            "samples_differing_from_unguided": n_differ,
                            "unguided_max_abs": float(np.abs(unguided).max()),
                            "vs_unguided_median_batch": seconds / batch_s}
    emit({"phase": "spec8_v2a_guided", "config": "mvp+specificity8", "clips": V2A_CLIPS,
          "steps": V2A_STEPS, "sampling": SYNC_GUIDANCE, "compute_dtype": "bfloat16",
          "batches": batches, "launches_expected_per_batch": want,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, guided_launches


def write_cli_corpus(root):
    """512 flagship-sized clips from np.random.default_rng(0) in 4 shards,
    through the port's write_record_shards."""
    from multimodal_diffusion_torch.tools.profile_train import write_corpus

    t0 = time.perf_counter()
    paths = write_corpus(root / "records", CLI_CLIPS, CLI_CLIPS_PER_SHARD, CLI_NO_VIDEO,
                         CLI_NO_AUDIO)
    return root / "records", {"shards": len(paths), "clips": CLI_CLIPS,
                              "bytes": sum(p.stat().st_size for p in paths),
                              "seconds": time.perf_counter() - t0}


def cli_overlay(root, records, resident: bool, last_step: int) -> str:
    import yaml

    run = root / ("resident" if resident else "streamed")
    path = root / f"overlay_{run.name}_{last_step}.yaml"
    path.write_text(yaml.safe_dump({
        "paths": {"out_root": str(run), "ckpt_dir": str(run / "ckpt"),
                  "log_dir": str(run / "logs"), "samples_dir": str(run / "samples")},
        "data": {"records_dir": str(records), "device_resident": resident,
                 "resident_max_clips": CLI_RESIDENT_CLIPS},
        "training": {"log_every": 1, "ckpt_every": last_step}}))
    return str(path)


def run_cli(fa, argv):
    """train_joint.main(argv) in this process, watched: the kernels' launch
    counts, each batch as it reaches the step, the batches copied from the
    host, the restored state, the checkpoint times, the logged metrics and
    the peak memory."""
    from unittest import mock

    import torch

    from multimodal_diffusion_torch.datasets import loader
    from multimodal_diffusion_torch.datasets.records import device_resident_batches
    from multimodal_diffusion_torch.train import checkpoint as TC
    from multimodal_diffusion_torch.train import train_joint
    from multimodal_diffusion_torch.train import trainer as TT

    seen = {"batches": [], "restored": None, "save_s": [], "tree_s": [], "restore_s": [],
            "logs": []}
    to_device, restore, to_tree = TT.batch_to_device, TC.restore_state, TC.state_to_tree

    def watch_batch(batch, device):
        v = batch["video"]
        seen["batches"].append((type(v).__name__, v.device.type, str(v.dtype))
                               if isinstance(v, torch.Tensor) else (type(v).__name__,))
        return to_device(batch, device)

    def watch_restore(state, tree):
        t0 = time.perf_counter()
        restore(state, tree)
        torch.cuda.synchronize()
        seen["restore_s"].append(time.perf_counter() - t0)
        seen["restored"] = to_tree(state)

    def watch_tree(state):
        t0 = time.perf_counter()
        tree = to_tree(state)
        seen["tree_s"].append(time.perf_counter() - t0)
        return tree

    class Manager(TC.CheckpointManager):
        def save(self, step, tree, meta=None, wait=False):
            t0 = time.perf_counter()
            super().save(step, tree, meta=meta, wait=wait)
            seen["save_s"].append(time.perf_counter() - t0)

        def restore(self, step=None):
            t0 = time.perf_counter()
            tree = super().restore(step)
            seen["restore_s"].append(time.perf_counter() - t0)
            return tree

    class Writer(train_joint.MetricWriter):
        def write(self, step, scalars):
            seen["logs"].append((step, dict(scalars)))
            super().write(step, scalars)

    reset_launch_counts(fa)
    copies = loader.copy_to_device.batches
    device_resident_batches.last_upload = None
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(TT, "batch_to_device", watch_batch), \
            mock.patch.object(train_joint, "restore_state", watch_restore), \
            mock.patch.object(train_joint, "state_to_tree", watch_tree), \
            mock.patch.object(train_joint, "CheckpointManager", Manager), \
            mock.patch.object(train_joint, "MetricWriter", Writer):
        state = train_joint.main(argv)
    seen.update(seconds=time.perf_counter() - t0, state=state, launches=launch_counts(fa),
                host_batch_copies=loader.copy_to_device.batches - copies,
                upload=device_resident_batches.last_upload,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return seen


def check_cli_run(run, steps, resident: bool, what: str):
    """The gates every CLI run passes; returns its step seconds (from the
    logged clips_per_sec)."""
    import numpy as np

    n = len(steps)
    want = {name: 16 * n for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}
    if run["launches"] != want:
        raise AssertionError(f"{what}: kernel launches {run['launches']}, expected {want}")
    if [s for s, _ in run["logs"]] != list(steps):
        raise AssertionError(f"{what}: logged steps {[s for s, _ in run['logs']]}")
    for step, m in run["logs"]:
        if not np.isfinite([m["loss"], m["grad_norm"]]).all():
            raise AssertionError(f"{what}: non-finite loss or grad norm at step {step}: {m}")
    if run["batches"] != [("Tensor", "cuda", "torch.uint8")] * n:
        raise AssertionError(f"{what}: batches reached the step as {set(run['batches'])}")
    copies = run["host_batch_copies"]
    if resident and copies != 0:
        raise AssertionError(f"{what}: {copies} batches were copied from the host")
    if not resident and not n <= copies <= n + 3:
        raise AssertionError(f"{what}: {copies} host batch copies for {n} steps")
    return [8.0 / m["clips_per_sec"] for _, m in run["logs"]]


def spec8_cli_phases(fa):
    """The train_joint CLI at the flagship, resident (8 steps, then --resume
    to 12) and streamed (6 steps), on a corpus written here."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from multimodal_diffusion_torch.train.checkpoint import CheckpointManager, state_to_tree

    repo = Path(__file__).resolve().parent
    (repo / "runs").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=repo / "runs"))
    configs = [str(repo / "configs" / "mvp.yaml"), str(repo / "configs" / "specificity8.yaml")]
    try:
        records, corpus = write_cli_corpus(root)
        first = run_cli(fa, ["--config", *configs, cli_overlay(root, records, True, CLI_STEPS),
                             "--max-steps", str(CLI_STEPS)])
        step_s = check_cli_run(first, range(1, CLI_STEPS + 1), True, "resident")
        ckpt = CheckpointManager(root / "resident" / "ckpt")
        if ckpt.latest_step() != CLI_STEPS:
            raise AssertionError(f"latest checkpoint {ckpt.latest_step()}, expected {CLI_STEPS}")
        up = first["upload"]
        if up["clips"] != CLI_RESIDENT_CLIPS:
            raise AssertionError(f"{up['clips']} clips resident, expected {CLI_RESIDENT_CLIPS}")
        tree_8 = state_to_tree(first.pop("state"))
        ema_8 = {k: v.clone() for k, v in tree_8["ema_core"].items()}
        torch.cuda.empty_cache()

        second = run_cli(fa, ["--config", *configs,
                              cli_overlay(root, records, True, CLI_RESUME_STEPS), "--resume",
                              "--max-steps", str(CLI_RESUME_STEPS)])
        step_s_resumed = check_cli_run(second, range(CLI_STEPS + 1, CLI_RESUME_STEPS + 1), True,
                                       "resumed")
        differ = tree_differences(second.pop("restored"), tree_8)
        if differ:
            raise AssertionError(f"the restored state differs from step {CLI_STEPS}'s: "
                                 f"{differ[:5]} ({len(differ)} entries)")
        if ckpt.latest_step() != CLI_RESUME_STEPS:
            raise AssertionError(f"latest checkpoint {ckpt.latest_step()} after the resume")
        if all(torch.equal(v.cpu(), ema_8[k]) for k, v in second.pop("state").ema.items()):
            raise AssertionError("the EMA did not move after the resume")
        del tree_8, ema_8
        shutil.rmtree(root / "resident")
        torch.cuda.empty_cache()

        streamed = run_cli(fa, ["--config", *configs,
                                cli_overlay(root, records, False, CLI_STREAMED_STEPS),
                                "--max-steps", str(CLI_STREAMED_STEPS)])
        streamed.pop("state")
        step_s_streamed = check_cli_run(streamed, range(1, CLI_STREAMED_STEPS + 1), False,
                                        "streamed")
        if CheckpointManager(root / "streamed" / "ckpt").latest_step() != CLI_STREAMED_STEPS:
            raise AssertionError("no final checkpoint of the streamed run")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # warm steps: not a run's first (the step compiles nothing, but its
    # launches meet cold caches) and not a decode step (step 8)
    resident_warm = step_s[1:CLI_STEPS - 1] + step_s_resumed[1:]
    resident_median = statistics.median(resident_warm)
    emit({"phase": "spec8_cli_resident", "config": "mvp+specificity8+overlay", "clips": 8,
          "corpus": corpus, "resident_clips": up["clips"], "resident_bytes": up["bytes"],
          "upload_s": up["seconds"], "upload_mb_per_s": up["bytes"] / 1e6 / up["seconds"],
          "step_s": step_s, "resumed_step_s": step_s_resumed,
          "median_step_s": resident_median, "warm_steps": len(resident_warm),
          "decode_step_s": step_s[CLI_STEPS - 1], "train_clips_per_s": 8 / resident_median,
          "first_run_s": first["seconds"], "resumed_run_s": second["seconds"],
          "save_s": first["save_s"] + second["save_s"],
          "state_to_tree_s": first["tree_s"] + second["tree_s"],
          "restore_s": second["restore_s"], "restored_bit_equal": True,
          "checkpoints": [CLI_STEPS, CLI_RESUME_STEPS],
          "losses": [m["loss"] for _, m in first["logs"] + second["logs"]],
          "grad_norms": [m["grad_norm"] for _, m in first["logs"] + second["logs"]],
          "launches": {k: first["launches"][k] + second["launches"][k]
                       for k in first["launches"]},
          "host_batch_copies": first["host_batch_copies"] + second["host_batch_copies"],
          "peak_mem_gb": max(first["peak_mem_gb"], second["peak_mem_gb"])})
    streamed_median = statistics.median(step_s_streamed[1:])
    emit({"phase": "spec8_cli_streamed", "config": "mvp+specificity8+overlay", "clips": 8,
          "step_s": step_s_streamed, "median_step_s": streamed_median,
          "resident_median_step_s": resident_median,
          "train_clips_per_s": 8 / streamed_median, "run_s": streamed["seconds"],
          "save_s": streamed["save_s"],
          "losses": [m["loss"] for _, m in streamed["logs"]],
          "launches": streamed["launches"], "host_batch_copies": streamed["host_batch_copies"],
          "peak_mem_gb": streamed["peak_mem_gb"]})
    resident_launches = {k: first["launches"][k] + second["launches"][k]
                         for k in first["launches"]}
    return resident_launches, streamed["launches"]


def tree_differences(a, b, path="") -> list:
    """The paths at which two checkpoint trees differ (tensors bit for bit)."""
    import torch

    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [f"{path}: keys {sorted(set(a) ^ set(b))[:3]}"]
        return [d for k in a for d in tree_differences(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())
        return [] if same else [path]
    return [] if a == b else [path]


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
          "forward_bf16_occupancy": fa.forward_occupancy(),
          "backward_bf16_occupancy": fa.backward_occupancy()})

    cases = kernel_phase(fa)
    by_path = {"v2a": {"flash_fwd": v2a_phase(fa)}}
    torch.cuda.empty_cache()
    by_path["train"] = train_phase(fa)
    torch.cuda.empty_cache()
    by_path["spec8_train"] = spec8_train_phase(fa)
    torch.cuda.empty_cache()
    by_path["spec8_v2a"], by_path["spec8_v2a_guided"] = spec8_v2a_phases(fa)
    torch.cuda.empty_cache()
    by_path["spec8_cli_resident"], by_path["spec8_cli_streamed"] = spec8_cli_phases(fa)

    def launches_of(name):
        paths = {path: counts[name] for path, counts in by_path.items() if counts.get(name)}
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    # ms, plain_ms, bound_ms and library_ms are the mvp shapes'; the flagship
    # shapes' stand beside them (the forward at the sampler's [16, 8, 421,
    # 128], the backward pair at the train step's and guided sampler's
    # [8, 8, 421, 128])
    mvp, flag = cases[("mvp", "bfloat16")], cases[("flagship_sample", "bfloat16")]
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "multimodal_diffusion_torch/csrc/flash_fwd.cu",
        "replaces": "multimodal_diffusion_tpu/ops/flash_attention.py:49",
        **launches_of("flash_fwd"),
        "max_abs_err": mvp["max_abs_err_out"], "ms": mvp["ms"], "plain_ms": mvp["plain_ms"],
        "bound_ms": mvp["bound_ms"], "bound_by": mvp["bound_by"],
        "library_ms": mvp["library_ms"],
        "flagship": {"shape": flag["shape"], "max_abs_err": flag["max_abs_err_out"],
                     "ms": flag["ms"], "plain_ms": flag["plain_ms"],
                     "bound_ms": flag["bound_ms"], "bound_by": flag["bound_by"],
                     "library_ms": flag["library_ms"]}}]
    for kernel, line in (("dkdv", 205), ("dq", 276)):
        rec = cases[("mvp_train", "bfloat16", kernel)]
        flag = cases[("flagship", "bfloat16", kernel)]
        name = f"flash_bwd_{kernel}"
        # plain_ms and library_ms time the pair (the plain version and SDPA's
        # backward compute dq, dk and dv together)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "multimodal_diffusion_torch/csrc/flash_bwd.cu",
            "replaces": f"multimodal_diffusion_tpu/ops/flash_attention.py:{line}",
            **launches_of(name),
            "max_abs_err": max(rec["max_abs_err"].values()), "ms": rec["ms"],
            "plain_ms": rec["plain_pair_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_pair_ms"],
            "flagship": {"shape": flag["shape"],
                         "max_abs_err": max(flag["max_abs_err"].values()), "ms": flag["ms"],
                         "plain_ms": flag["plain_pair_ms"], "bound_ms": flag["bound_ms"],
                         "bound_by": flag["bound_by"], "library_ms": flag["library_pair_ms"]}})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
