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
               edge costs); then, bf16 and timed, the text families' shapes
               under their masks (77 text keys with each prompt's pads, the
               target keys, the masked seq_multiple tail): the forward at the
               t2i sampler's [16, 4, 1152, 128], the t2a sampler's
               [16, 6, 397, 64] and the text encoder's [16, 4, 77, 64], the
               forward and the backward pair at the t2i train step's
               [32, 4, 1152, 128] and [32, 4, 77, 64]; last, unmasked and
               bf16, the pixel sampler's forward at [16, 6, 64, 64] and the
               pixel train step's forward and backward pair at
               [128, 6, 64, 64];
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
 11. ref_ckpt — the reference implementation's own trained weights
               (docs/parity/ref_run/step_650.pt, d=256, 4 layers, 4 heads of
               64, its config's fp32 compute) through build_components +
               sample_one_direction, live and EMA: v2a and a2v, B=8, the
               config's 25 sampler steps, exactly 25 x 4 forward launches a
               batch; one denoise_tokens with and without the kernel within
               the mvp phase's tolerance; a finite wav in [-1, 1] and uint8
               frames; the eval scores of each v2a clip against its prompt
               (estimate_av_sync, log-mel statistics), printed, gated on
               finiteness only;
 12. orbax_fixture — the JAX package's committed orbax checkpoint
               (tests/torch_fixtures/orbax_spec8_tiny: the flagship's options
               at d=64, 2 layers, bf16 moments, two JAX train steps) read by
               the port's reader without orbax: every leaf's sha256 equal to
               leaves.json; build_components from it and one B=2 v2a batch;
               create_trainer + restore_jax_state + one train step: a finite
               loss, each kernel's exact launch count, moments and EMA that
               move; then the three kernels at the fixture's own fp32
               operands (2 heads of 32) against their plain versions, at the
               v2a batch's and the train step's shapes, masked and unmasked,
               and on the restored weights one denoise_tokens and one train
               gradient with and without the kernels; the libzstd path and
               version;
 13. spec8_stream — the flagship (N(0, 0.02) weights) through
               infer/stream_infer.py: an 11 s prompt of 176 frames is 9
               windows, two batches of 8 (the second padded), exactly
               2 x 800 forward launches, 176,000 stitched samples, finite, in
               [-1, 1]; the stream's wall seconds beside one spec8_v2a batch.
 14. t2i_512 — configs/t2i_512.yaml at full width (512x512, 4x64x64
               latents, text d=256 4 layers, core d=512 16 layers 4 heads of
               128, 77 + 1024 tokens padded to 1152; bf16) with N(0, 0.02)
               weights written as a checkpoint and restored through the CLI's
               weight path: B=8, 50 ddim steps, guidance 5.0, a real negative
               prompt, exactly 50 x 16 + 2 x 4 = 808 forward launches a batch
               and uint8 [8, 512, 512, 3] images; a warm-up and 3 timed
               batches; images that differ with an empty negative prompt and
               under dpmpp_2m; one denoise with and without the kernel within
               2e-2; then the sample_t2i CLI in this process (8 PNGs);
 15. t2i_train — make_t2i_train_step at the config's width and B=32 (halved
               while it does not fit), the config's AdamW: 2 warm-up steps
               (no move at LR 0, a move after), 4 timed steps of exactly 20
               launches of each kernel (16 core + 4 text layers), finite
               losses; one full-width gradient of 8 samples with and without
               the kernels within 3e-2, reaching the VAE and text encoders
               and not the decoder;
 16. t2a     — Text2AudioConfig() in bf16 (d=384, 6 layers, 6 heads of 64,
               77 + 320 tokens), N(0, 0.02) weights: B=8, 50 ddim steps,
               exactly 50 x 6 + 2 x 4 = 308 forward launches a batch, finite
               mels [8, 1, 80, 256], one clip through Griffin-Lim.
 17. serve_spec8 — the serving runner (serve/runner.py InferenceRunner) on
               configs/mvp.yaml + configs/specificity8.yaml with paths
               emptied (the seeded init), 50 sampler steps, bf16 serving
               weights, max_batch 8: a manifest of 11 v2a requests (48 frames
               of 128x128 as frame directories), 5 a2v requests (3 s wavs),
               one 11 s stream_v2a request (9 windows) and one request whose
               frames are missing. Every good request ok and the bad one
               failing at load; wavs of 48,000 samples, finite, in [-1, 1];
               48 uint8 frames; a stitched stream of 176,000 samples; exactly
               800 forward launches per device batch; the most padded v2a
               batch bit-equal to sample_one_direction on the same padded
               batch; two requests through watch on an inbox, each with its
               result file; no thread left after close. Requests/s, clips/s,
               each batch's latency and queue waits.
 18. int8    — the W8A8 core: int8_linear on the card against its CPU path on
               the same bf16 input at the flagship's and t2i's four hot
               projection shapes (integers, scales and outputs bit-equal on
               256 rows; a 5-row product padded to 17 rows), the int8
               product, the quantize pass and int8_linear timed against bf16
               F.linear with their bounds at the card's int8 and bf16 rates;
               one flagship v2a batch under model.core.quant int8 with bf16
               weights (800 forward launches, finite, in range) and on its
               weights denoise_tokens int8 vs unquantized within 5e-2 (the
               JAX bound) and not equal; the t2i serving row (t2i_512 width,
               int8, dpmpp_2m at 12 steps, B=8, bf16 weights: a warm-up and 3
               timed batches of exactly 12 x 16 + 2 x 4 = 200 forward
               launches, uint8 [8, 512, 512, 3]) beside t2i_512's bf16
               ddim@50 row.
 19. pixel32_train — train/train_pixel.main at configs/pixel32.yaml's width
               (d=384, 12 layers, 6 heads of 64, patch 4: N = 64; B=128;
               bf16) on a folder of 512 32x32 JPEGs written here (decoded
               by the native loader where it builds, else PIL; the line
               says which), paths under a scratch directory: 2 + 16
               steps, exactly 12 launches of each kernel a step, finite
               logged losses, the final checkpoint; step time, images/s,
               the step's MFU against the peak and against calib_tflops(),
               peak memory; one full-width gradient on the checkpoint's
               weights with and without the kernels within GRAD_REL_TOL;
 20. pixel32_sample — infer/sample_pixel.main restoring that checkpoint:
               16 images by the 1000-step ancestral sampler, exactly
               12 x 1000 = 12,000 forward launches a call, 16 PNGs equal to
               the sampler's uint8 images of the same seed; two more calls
               with the same seed give the same bits, finite and within
               [-1, 1] before quantization; s per call, images/s, and one
               call under the profiler (device activity only) for the busy
               time and idle share; one PixelDiT forward with and without
               the kernel within PIXEL_DENOISE_REL_TOL;
 21. spec8_remat — calib_tflops() on a line of its own, then the flagship
               train step (spec8_train's setup: B=8, bf16 moments, core
               dropout 0.1) with parallel.remat_core off and then on, from
               the same seed and batch: 2 + 5 steps each (none with the
               decode), exactly 16 / 16 / 16 launches a step without remat
               and 32 / 16 / 16 with it, each step's loss within
               REMAT_REL_TOL, the logged denoiser_mfu equal to the JAX
               loop's formula and a denoiser_mfu_vs_calib, each run's peak
               memory; on the remat trainer's model one step's forward and
               backward with and without the recompute (the same draws and
               generator state): grads within REMAT_REL_TOL of their
               largest magnitude, the generator left in the same state, and
               a lower peak under remat (the step's own peak is the
               optimizer's update, which remat does not touch).
 22. multi_rank — two ranks on this one card, each its own process, both on
               cuda:0 over gloo (NCCL takes one rank per device; gloo moves
               all but sums and broadcasts through host memory, and the two
               ranks share the SMs: the times are no scaling figures). In one
               spawned pair: the flash ring alone (ops/ring_attention.py,
               impl flash) at [8, 8, 211, 128] a rank, 421 tokens padded to
               422 with the pad key masked, forward and backward against
               flash_attention on the whole [8, 8, 422, 128] here (output
               within 2e-2, grads within GRAD_REL_TOL, both relative to the
               largest magnitude), two calls bit-identical, exactly 2
               launches of each kernel a call, its ms beside the whole call's;
               the kernels alone at a block's shape (rank 0's queries, rank
               1's keys); one flagship train step (B=8 global, bf16, the
               seeded init, shared batch and draws, audio the target) on each
               of data 2, model 2, context 2 (context_flash) and pipe 2 (2
               microbatches, dropout 0 as the JAX package requires) against
               the one-process step on this card (context's with
               seq_multiple 2, so both draw the dropout masks at 422 tokens):
               loss, grad norm and four gradients within SPEC8_GRAD_REL_TOL,
               and exactly MULTI_RANK_LAUNCHES launches of each kernel per
               rank; a 2-step v2a flagship batch with the batch over data 2
               and one under context 2 (spec8_v2a's N(0, 0.02) weights),
               finite, in range and within 2e-2 of one process, and under
               context 2 the sampler's denoiser forward (spec8_denoise)
               within SPEC8_DENOISE_REL_TOL of one process. Under model 2
               each rank holds only its part of the split projections (qkv,
               fc1, attention out, fc2), of their gradients, EMA and bf16
               moments: its state bytes must equal one process's less
               half of the split ones', its parameters and EMA after two
               steps at the constant LR within MULTI_RANK_PARAM_ABS_TOL of
               one process's AdamW on its gathered gradients; both
               ranks' torch.cuda.memory_allocated() read at one moment (a
               multi_rank_shared_card line: two processes hold the one
               card); the checkpoint the ranks gather and rank 0 writes,
               restored in one process here, bit-equal (sha256 of every
               tensor); the kernels at a rank's heads, [8, 4, 421, 128]
               (the model2_block case); a 2-step v2a flagship batch under
               model.core.quant int8 with bf16 serving weights, bit-equal
               to one process's int8 batch, every hot projection's part
               servable by torch._int_mm, exactly 32 forward launches a
               batch. Then tools/dryrun_multichip.py at n = 4 on this card
               (gloo; the shrunk core with 2 heads of 32, the kernels'
               smallest head dim).
 23. mpeg_audio — whether media/mpeg_audio.py finds the bundled libavcodec,
               of a known major; where it does, a .mpg of a tone written by
               tools/make_mpg.py (the bundled mp2 encoder) and read back.
 24. decode_shrink — the flagship's patch VideoVAE (seeded, fp32) decoding
               2 clips to 40x112x120, smaller than its natural 48x128x128
               (the antialiased resize of ops/resize.py): within
               DECODE_SHRINK_REL_TOL of the same decode on the CPU, the
               resize alone within RESIZE_REL_TOL, its ms beside the
               natural decode's.
 25. bench   — tools/bench.py (the root bench.py's counterpart) in this
               process, BENCH_RUNS in order: v2a at mvp with bench.py's
               defaults (B=8, 50 steps, 7 samples of 3 calls), a2v, v2a at
               the flagship (N = 421, the mouth stream zeroed as bench.py
               passes no mouth tokens), t2i at bench.py's 8-layer core and
               with --serving (int8, dpmpp_2m at 12 steps), the train step
               at mvp and at the flagship (the decode step and the plain
               step timed apart and blended); each prints bench.py's line,
               then a bench line with the denoiser's tokens and launches.
               Gates: exactly bench.py's keys, a _cuda metric, value =
               batch / best latency (av), finite, and exactly 400 / 400 /
               800 / 408 / 104 forward launches a batch, 8 / 16 of each
               kernel a train step;
 26. tools   — quant_probe (bf16 / int8 / fp8 rates and numerics),
               mfu_probe (the t2i core forward's MFU, attention alone),
               and on the orbax fixture with 4 synthetic clips written
               under runs/ eval_av_quality and latent_probe: one line
               each, finite, with the JAX tools' keys.
Then a `kernels` line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. The device time by kernel of one v2a batch is
`python -m multimodal_diffusion_torch.tools.profile_v2a`, of one train step
`python -m multimodal_diffusion_torch.tools.profile_train` (each takes
`--config specificity8`), of one t2i batch
`python -m multimodal_diffusion_torch.tools.profile_t2i`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
# the same two checks on the orbax fixture's restored weights, fp32 (TF32
# off) at 2 heads of 32: both paths round only to fp32, which the kernels
# hold to 1e-4 absolute elementwise (TOL, BWD_TOL) and the H100 read ~1e-6
# relative on the reference weights' denoise_tokens (ref_ckpt)
FIXTURE_REL_TOL = 1e-4
# the CLI phases' corpus: flagship-sized clips, a few without video or audio
CLI_CLIPS, CLI_CLIPS_PER_SHARD, CLI_RESIDENT_CLIPS = 512, 128, 384
CLI_NO_VIDEO, CLI_NO_AUDIO = (17, 200, 401), (5, 130, 333, 470)
CLI_STEPS, CLI_RESUME_STEPS, CLI_STREAMED_STEPS = 8, 12, 6
# the text families: configs/t2i_512.yaml sampled at B=8 and trained at its
# batch of 32 (halved while it does not fit), Text2AudioConfig() at B=8
T2I_BATCH, T2I_STEPS = 8, 50
T2I_TRAIN_WARMUP, T2I_TRAIN_STEPS = 2, 4
T2A_BATCH, T2A_STEPS = 8, 50
T2A_PROMPTS = ["a dog barking", "rain on a tin roof", "a church bell", "footsteps on gravel",
               "a violin melody", "wind through trees", "a door slamming", "birdsong at dawn"]
# (name, [B, H, N, Dh], target tokens, backward too): the t2i sampler's core
# (77 text + 1024 image keys, 51 tail keys masked; prompts and negative
# prompts stacked), the t2i train step's core and text encoder, the t2a
# sampler's core (77 + 320 mel keys) and a sampling batch's text encoder
TEXT_FAMILY_CASES = [
    ("t2i_sample", (16, 4, 1152, 128), 1024, False),
    ("t2i_train", (32, 4, 1152, 128), 1024, True),
    ("text_encoder_train", (32, 4, 77, 64), 0, True),
    ("t2a_sample", (16, 6, 397, 64), 320, False),
    ("text_encoder", (16, 4, 77, 64), 0, False),
]
# t2i denoise with and without the kernel, bf16, 16 core layers as the
# flagship's: the flagship's 2e-2; the full-width gradient: its 3e-2
T2I_DENOISE_REL_TOL = 2e-2
T2I_GRAD_REL_TOL = 3e-2
# serving: the runner at flagship width (50 sampler steps, as the other
# flagship phases) on a manifest of SERVE_V2A clip requests, SERVE_A2V 3 s
# wavs, one 11 s stream (9 windows) and one request whose frames are missing;
# then SERVE_WATCH requests through an inbox
SERVE_V2A, SERVE_A2V, SERVE_WATCH, SERVE_MAX_BATCH = 11, 5, 2, 8
# int8 W8A8: the four hot projections' [M, K] x [K, N] at the flagship
# sampler's M = 16 x 421 rows (CFG-doubled B = 8) and the t2i sampler's
# 16 x 1152; the card's int8_linear must equal its CPU path on the same bf16
# input, bit for bit, on the first INT8_CPU_ROWS rows (every row has its own
# scale, so rows are independent; the CPU's int32 matmul of all rows would
# take minutes)
INT8_CASES = [
    ("flagship_qkv", 6736, 1024, 3072), ("flagship_out", 6736, 1024, 1024),
    ("flagship_fc1", 6736, 1024, 4096), ("flagship_fc2", 6736, 4096, 1024),
    ("t2i_qkv", 18432, 512, 1536), ("t2i_out", 18432, 512, 512),
    ("t2i_fc1", 18432, 512, 2048), ("t2i_fc2", 18432, 2048, 512),
]
INT8_CPU_ROWS = 256
# H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12
# int8 vs the unquantized model on the same weights: the JAX package's bound
# (tests/test_quant.py), relative Frobenius norm of the difference
INT8_REL_TOL = 5e-2
# the JAX bench.py --serving row: t2i-512, dpmpp_2m at 12 steps, int8, B = 8
T2I_SERVE_BATCH, T2I_SERVE_STEPS = 8, 12

# the pixel DDPM family at configs/pixel32.yaml width (d=384, 12 layers, 6
# heads of 64, 8x8 patches of 4: N = 64, bf16): the train CLI at its batch of
# 128 on a folder of PIXEL_IMAGES 32x32 JPEGs (the native decode path),
# PIXEL_WARMUP steps then PIXEL_STEPS timed; the sampling CLI restoring that
# checkpoint, 16 images by the 1000-step ancestral sampler
PIXEL_IMAGES, PIXEL_WARMUP, PIXEL_STEPS, PIXEL_SAMPLES = 512, 2, 16, 16
# (name, [B, H, N, Dh], backward too): the pixel sampler's forward and the
# train step's forward and backward pair, unmasked
PIXEL_KERNEL_CASES = [("pixel_sample", (16, 6, 64, 64), False),
                      ("pixel_train", (128, 6, 64, 64), True)]
# PixelDiT's forward with and without the kernel, bf16: 12 layers round
# between mvp's 8 (1.5e-2) and the flagship's 16 (2e-2) times; the latter
PIXEL_DENOISE_REL_TOL = 2e-2
# the flagship train step with parallel.remat_core beside the same step
# without it: REMAT_STEPS timed steps after TRAIN_WARMUP (steps 3..7, none
# with the decode); each step's loss, and one step's grads relative to their
# largest magnitude, within REMAT_REL_TOL (the recompute gives the forward's
# bits: the same kernels on the same inputs, the same dropout masks)
REMAT_STEPS = 5
REMAT_REL_TOL = 1e-6


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


def spec8_denoise(model, **kw):
    """One flagship denoise_tokens of the sampler's CFG-doubled batch (B = 8
    conditional + 8 null rows, mouth tokens) on seeded inputs."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    B2 = 2 * V2A_CLIPS
    mgrid = model.mouth_grid(48)
    n_mouth = mgrid[0] * mgrid[1] * mgrid[2]
    tok_v = torch.from_numpy(rng.normal(size=(B2, 96, 256)).astype(np.float32)).cuda()
    tok_a = torch.from_numpy(rng.normal(size=(B2, 37, 32)).astype(np.float32)).cuda()
    tok_m = torch.from_numpy(rng.uniform(-0.5, 0.5, size=(B2, n_mouth,
                                                         model.cfg.token_dim_mouth))
                             .astype(np.float32)).cuda()
    t_v = torch.zeros(B2, dtype=torch.long, device="cuda")
    t_a = torch.from_numpy(rng.integers(0, 1000, B2)).cuda()
    keep = torch.cat([torch.ones(V2A_CLIPS), torch.zeros(V2A_CLIPS)]).cuda()
    return model.denoise_tokens(tok_v, tok_a, t_v, t_a, (6, 4, 4), keep, None, tok_m=tok_m,
                                keep_m=keep, mouth_grid=mgrid, **kw)


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
    with torch.inference_mode():
        a, b = (spec8_denoise(model, use_kernel=use_kernel) for use_kernel in (True, False))
    if a["h_m"].shape != (2 * V2A_CLIPS, 288, 1024):
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


REPO = Path(__file__).resolve().parent
REF_DIR = "docs/parity/ref_run"
FIXTURE = "tests/torch_fixtures/orbax_spec8_tiny"
STREAM_FRAMES = 176  # 11 s at 16 fps: 9 windows of 3 s every 1 s


def prompt_frames(clips, T, H, W, seed):
    """uint8 frames [clips, T, H, W, 3]: seeded noise with a centre block
    whose brightness follows a per-clip rhythm (a motion envelope with
    structure for the sync score)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 96, (clips, T, H, W, 3)).astype(np.float32)
    t = np.arange(T)[None, :]
    level = 127 + 120 * np.sin(2 * np.pi * t * rng.uniform(0.5, 3.0, (clips, 1)) / 16.0)
    frames[:, :, H // 4:3 * H // 4, W // 4:3 * W // 4, :] = level[:, :, None, None, None]
    return frames.astype(np.uint8)


def eval_scores(frames, wav, sr, fps):
    """Per clip: estimate_av_sync's (lag s, correlation) of the clip against
    its prompt frames, and its log-mel mean and std."""
    import numpy as np

    from multimodal_diffusion_torch.eval.audio_quality import logmel_default
    from multimodal_diffusion_torch.eval.av_sync import estimate_av_sync

    out = []
    for f, w in zip(frames, wav):
        lag, corr = estimate_av_sync(f, w, sr=sr, fps=fps)
        lm = logmel_default(w, sr)
        out.append({"lag_s": lag, "corr": corr, "logmel_mean": float(lm.mean()),
                    "logmel_std": float(lm.std())})
    if not all(np.isfinite(list(d.values())).all() for d in out):
        raise AssertionError(f"non-finite eval scores {out}")
    return out


def ref_ckpt_phase(fa):
    """The reference's trained weights through the public entry points."""
    import numpy as np
    import torch

    from multimodal_diffusion_torch.infer.sample_clip import (build_components,
                                                              config_with_checkpoint,
                                                              sample_one_direction)
    from multimodal_diffusion_torch.utils.io import latent_shapes_from_config, load_config

    cfg = config_with_checkpoint(load_config(REPO / REF_DIR / "config.yaml"),
                                 str(REPO / REF_DIR / "step_650.pt"))
    steps = int(cfg["diffusion"]["audio"]["sampler_steps"])
    n_layers = cfg["model"]["core"]["n_layers"]
    expected = steps * n_layers
    sr, fps = int(cfg["audio"]["sr"]), int(cfg["video"]["fps"])
    _, _, T, H, W = latent_shapes_from_config(cfg, V2A_CLIPS)["video"]
    frames = prompt_frames(V2A_CLIPS, T, H, W, seed=11)
    tt = np.arange(int(round(float(cfg["data"]["clip_seconds"]) * sr))) / sr
    audio = (0.5 * np.sin(2 * np.pi * 220 * tt) * (np.sin(2 * np.pi * 2 * tt) > 0)
             )[None].repeat(V2A_CLIPS, 0).astype(np.float32)
    launches, record = {}, {"phase": "ref_ckpt", "checkpoint": f"{REF_DIR}/step_650.pt",
                            "config": f"{REF_DIR}/config.yaml", "clips": V2A_CLIPS,
                            "steps": steps, "compute_dtype": "float32", "weights": {}}
    for use_ema in (False, True):
        t0 = time.perf_counter()
        model = build_components(cfg, device="cuda", use_ema=use_ema)
        load_s = time.perf_counter() - t0
        if sum(p.numel() for p in model.parameters()) != 5_250_996:
            raise AssertionError("the reference model is not d=256, 4 layers")
        rec = {"load_s": load_s}
        for direction in ("v2a", "a2v"):
            kw = ({"prompt_modality": "video", "prompt_video": frames} if direction == "v2a"
                  else {"prompt_modality": "audio", "prompt_audio": audio})
            times = []
            for rep in range(2):
                reset_launch_counts(fa)
                t0 = time.perf_counter()
                out = sample_one_direction(cfg=cfg, model=model, device="cuda",
                                           generator=torch.Generator().manual_seed(3), **kw)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                got = launch_counts(fa)
                if got != {"flash_fwd": expected, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}:
                    raise AssertionError(f"reference {direction}: launches {got}, expected "
                                         f"{expected} forward")
                launches["flash_fwd"] = launches.get("flash_fwd", 0) + got["flash_fwd"]
            if direction == "v2a":
                wav = out["audio"]
                if wav.shape != (V2A_CLIPS, len(tt)) or not np.all(np.isfinite(wav)) or \
                        np.abs(wav).max() > 1:
                    raise AssertionError(f"bad reference v2a output {wav.shape}")
                rec["v2a"] = {"batch_s": times, "wav_max_abs": float(np.abs(wav).max()),
                              "eval": eval_scores(frames, wav, sr, fps)}
            else:
                vid = out["video"]
                if vid.shape != (V2A_CLIPS, T, H, W, 3) or vid.dtype != np.uint8:
                    raise AssertionError(f"bad reference a2v output {vid.shape} {vid.dtype}")
                rec["a2v"] = {"batch_s": times, "frames_mean": float(vid.mean())}
        # one denoiser forward, kernel vs dense attention, on these weights
        rng = np.random.default_rng(0)
        B2 = 2 * V2A_CLIPS
        tok_v = torch.from_numpy(rng.normal(size=(B2, 96, 256)).astype(np.float32)).cuda()
        tok_a = torch.from_numpy(rng.normal(size=(B2, 37, 32)).astype(np.float32)).cuda()
        t_v = torch.zeros(B2, dtype=torch.long, device="cuda")
        t_a = torch.from_numpy(rng.integers(0, 1000, B2)).cuda()
        keep = torch.cat([torch.ones(V2A_CLIPS), torch.zeros(V2A_CLIPS)]).cuda()
        with torch.inference_mode():
            a, b = (model.denoise_tokens(tok_v, tok_a, t_v, t_a, (6, 4, 4), keep, None,
                                         use_kernel=k) for k in (True, False))
        rel = {key: float((a[key].float() - b[key].float()).abs().max()
                          / b[key].float().abs().max()) for key in ("eps_v", "eps_a")}
        if max(rel.values()) > DENOISE_REL_TOL:
            raise AssertionError(f"reference denoise_tokens kernel vs dense: {rel}")
        rec["denoise_kernel_vs_dense_rel_err"] = rel
        record["weights"]["ema" if use_ema else "live"] = rec
        del model
        torch.cuda.empty_cache()
    record.update(launches_per_batch=expected, rel_tol=DENOISE_REL_TOL,
                  launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(record)
    return launches


def fixture_kernel_checks(fa, cfg, model, bundle, batch, frames):
    """The three kernels at the orbax fixture's own operands (fp32, its
    heads of 32): each against its plain version on seeded operands of the
    v2a batch's and the train step's attention shapes, masked and unmasked;
    then one denoise_tokens on the restored weights as the v2a sampler calls
    it (CFG-doubled, mouth tokens) and one gradient of the restored train
    step's loss, each with and without the kernels."""
    import numpy as np
    import torch

    from multimodal_diffusion_torch.train import trainer as TT

    dev = torch.device("cuda")
    B = frames.shape[0]
    mc = model.cfg
    rng = np.random.default_rng(16)
    Ca, Fa = (int(cfg["audio"]["latent"][k]) for k in ("channels", "frames_per_clip"))
    with torch.inference_mode():
        video = torch.as_tensor(frames).to(dev, torch.float32).permute(0, 4, 1, 2, 3) / 255.0
        z_v = model.encode_video(video)
        tok_v = model.tokenize_video(z_v)
        tok_a = model.tokenize_audio(torch.from_numpy(
            rng.normal(size=(B, Ca, Fa)).astype(np.float32)).to(dev))
        tok_m = model.mouth_tokens(video)
        mgrid = model.mouth_grid(z_v.shape[2] * mc.vae.t_down)
        keep = torch.cat([torch.ones(B), torch.zeros(B)]).to(dev)
        t_v = torch.zeros(2 * B, dtype=torch.long, device=dev)
        t_a = torch.from_numpy(rng.integers(0, 1000, 2 * B)).to(dev)
        a, b = (model.denoise_tokens(
            torch.cat([tok_v, tok_v]), torch.cat([tok_a, tok_a]), t_v, t_a,
            model.video_grid(z_v.shape), keep, None, use_kernel=use_kernel,
            tok_m=torch.cat([tok_m, tok_m]), keep_m=keep, mouth_grid=mgrid)
            for use_kernel in (True, False))
    dtype = a["h_v"].dtype
    N = tok_v.shape[1] + tok_a.shape[1] + tok_m.shape[1]
    H = mc.core.n_heads
    Dh = mc.core.d_model // H
    denoise_rel = {key: float((a[key] - b[key]).abs().max() / b[key].abs().max())
                   for key in ("eps_v", "eps_a", "h_m")}
    if dtype != torch.float32 or max(denoise_rel.values()) > FIXTURE_REL_TOL:
        raise AssertionError(f"fixture denoise_tokens kernel vs dense ({dtype}): "
                             f"{denoise_rel} (tol {FIXTURE_REL_TOL})")

    cases = {}
    for name, shape in (("fixture_v2a", (2 * B, H, N, Dh)), ("fixture_train", (B, H, N, Dh))):
        for n_masked in (0, 5):
            g = torch.Generator(device=dev).manual_seed(80 + shape[0] + n_masked)
            q, k, v, dout = (torch.randn(shape, generator=g, device=dev) for _ in range(4))
            valid, n_valid = None, [N] * shape[0]
            if n_masked:
                valid = torch.ones((shape[0], N), dtype=torch.bool, device=dev)
                valid[0, N - n_masked:] = False
                n_valid[0] = N - n_masked
            out, lse, err_out, err_lse = forward_check(fa, name, q, k, v, valid, n_valid)
            errs, rel = backward_check(fa, name, q, k, v, valid, out, lse, dout, n_valid)
            cases[f"{name}_masked{n_masked}"] = {
                "shape": list(shape), "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
                "bwd_max_abs_err": errs, "bwd_rel_err": rel}

    grads, n_qkv, qkv_rel, norms = kernel_vs_dense_grads(TT, bundle, batch)
    del grads
    norm_rel = abs(norms[True] - norms[False]) / norms[False]
    if n_qkv != cfg["model"]["core"]["n_layers"] or max(qkv_rel, norm_rel) > FIXTURE_REL_TOL:
        raise AssertionError(f"fixture train grads with the kernels vs dense: qkv {qkv_rel}, "
                             f"norm {norm_rel} (tol {FIXTURE_REL_TOL}, {n_qkv} qkv grads)")
    return {"dtype": "float32", "tokens": N, "heads": H, "head_dim": Dh, "kernels": cases,
            "tol": {"out": TOL["float32"], "bwd": BWD_TOL["float32"],
                    "kernel_vs_dense_rel": FIXTURE_REL_TOL},
            "denoise_kernel_vs_dense_rel_err": denoise_rel,
            "grad_check": {"qkv_weight_rel_err": qkv_rel, "grad_norm_rel_err": norm_rel}}


def orbax_fixture_phase(fa):
    """The JAX package's committed orbax checkpoint, read and used by the
    port on the card."""
    import hashlib

    import numpy as np
    import torch

    from multimodal_diffusion_torch.infer.sample_clip import (build_components,
                                                              config_with_checkpoint,
                                                              sample_one_direction)
    from multimodal_diffusion_torch.train import orbax_reader as R
    from multimodal_diffusion_torch.train.checkpoint import restore_jax_state
    from multimodal_diffusion_torch.train.trainer import create_trainer
    from multimodal_diffusion_torch.utils import zstd
    from multimodal_diffusion_torch.utils.io import latent_shapes_from_config, load_config

    root = REPO / FIXTURE
    files = sum(p.stat().st_size for p in (root / "ckpt").rglob("*") if p.is_file())
    t0 = time.perf_counter()
    step, tree = R.read_orbax_checkpoint(root / "ckpt")
    read_s = time.perf_counter() - t0
    leaves = {"/".join(path): t for path, t in R.tree_leaves(tree)}
    records = {r["path"]: r for r in json.loads((root / "leaves.json").read_text())}
    if leaves.keys() != records.keys():
        raise AssertionError(f"leaves differ from leaves.json: "
                             f"{sorted(set(leaves) ^ set(records))[:5]}")
    for path, t in leaves.items():
        bits = t.view(torch.uint16) if t.dtype == torch.bfloat16 else t
        if hashlib.sha256(bits.numpy().tobytes()).hexdigest() != records[path]["sha256"]:
            raise AssertionError(f"leaf {path}: sha256 differs from leaves.json")
    leaf_bytes = sum(t.numel() * t.element_size() for t in leaves.values())

    cfg = load_config(root / "config.yaml")
    n_layers = cfg["model"]["core"]["n_layers"]
    steps = int(cfg["diffusion"]["audio"]["sampler_steps"])
    model = build_components(config_with_checkpoint(cfg, str(root / "ckpt")), device="cuda",
                             use_ema=True)
    shapes = latent_shapes_from_config(cfg, 2)
    _, _, T, H, W = shapes["video"]
    frames = prompt_frames(2, T, H, W, seed=12)
    reset_launch_counts(fa)
    wav = sample_one_direction(cfg=cfg, model=model, prompt_modality="video",
                               prompt_video=frames, device="cuda")["audio"]
    v2a_launches = launch_counts(fa)
    if v2a_launches != {"flash_fwd": steps * n_layers, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}:
        raise AssertionError(f"fixture v2a launches {v2a_launches}")
    if not np.all(np.isfinite(wav)) or np.abs(wav).max() > 1:
        raise AssertionError("bad fixture v2a output")

    bundle = create_trainer(cfg, device="cuda")
    t0 = time.perf_counter()
    restore_jax_state(bundle.state, tree)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    state = bundle.state
    if state.step != step:
        raise AssertionError(f"restored step {state.step}, expected {step}")
    before = {"mu": [m.clone() for m in state.optimizer.mu],
              "nu": [v.clone() for v in state.optimizer.nu],
              "ema": {k: v.clone() for k, v in state.ema.items()}}
    rng = np.random.default_rng(13)
    batch = {"video": prompt_frames(2, T, H, W, seed=14),
             "audio": rng.uniform(-1, 1, shapes["audio"]).astype(np.float32),
             "has_video": np.ones(2, bool), "has_audio": np.ones(2, bool)}
    reset_launch_counts(fa)
    metrics = bundle.train_step(state, batch, 0.0)
    train_launches = launch_counts(fa)
    loss = float(metrics["loss"])
    if train_launches != {name: n_layers for name in train_launches}:
        raise AssertionError(f"restored train step launches {train_launches}")
    if not np.isfinite(loss) or state.step != step + 1:
        raise AssertionError(f"restored train step: loss {loss}, step {state.step}")
    moved = {"mu": any(not torch.equal(a, b) for a, b in zip(state.optimizer.mu, before["mu"])),
             "nu": any(not torch.equal(a, b) for a, b in zip(state.optimizer.nu, before["nu"])),
             "ema": any(not torch.equal(v, before["ema"][k]) for k, v in state.ema.items())}
    if not all(moved.values()):
        raise AssertionError(f"did not move after the restored step: {moved}")
    checks = fixture_kernel_checks(fa, cfg, model, bundle, batch, frames)
    lib = zstd.library()
    emit({"phase": "orbax_fixture", "fixture": FIXTURE, "step": step, "leaves": len(leaves),
          "leaf_bytes": leaf_bytes, "file_bytes": files, "read_s": read_s,
          "read_mb_per_s": leaf_bytes / 1e6 / read_s, "sha256_equal_leaves_json": True,
          "v2a_launches": v2a_launches, "wav_shape": list(wav.shape),
          "restore_s": restore_s, "train_loss": loss, "train_launches": train_launches,
          "moved": moved, "moments_dtype": str(state.optimizer.mv_dtype),
          "kernel_checks": checks, "libzstd": {"path": lib.path, "version": zstd.version()}})
    return {k: v2a_launches[k] + train_launches[k] for k in train_launches}


def spec8_stream_phase(fa):
    """The flagship through sliding-window streaming."""
    import numpy as np
    import torch

    from multimodal_diffusion_torch.infer.stream_infer import (split_frames_into_windows,
                                                               stream_config,
                                                               stream_video_to_audio)
    from multimodal_diffusion_torch.tools.profile_v2a import v2a_workload

    cfg, model, run = v2a_workload(V2A_CLIPS, V2A_STEPS, config="specificity8")
    win_s, hop_s, _, max_batch = stream_config(cfg)
    fps, sr = int(cfg["video"]["fps"]), int(cfg["audio"]["sr"])
    H, W = cfg["video"]["size"]
    frames = prompt_frames(1, STREAM_FRAMES, H, W, seed=15)[0]
    windows = split_frames_into_windows(frames, fps, win_s, hop_s)[0].shape[0]
    batches = -(-windows // max_batch)
    if (windows, max_batch, batches) != (9, 8, 2):
        raise AssertionError(f"{windows} windows in batches of {max_batch}")
    run()  # warm: the same shapes as a stream batch
    t0 = time.perf_counter()
    run()
    batch_s = time.perf_counter() - t0
    reset_launch_counts(fa)
    t0 = time.perf_counter()
    wav = stream_video_to_audio(frames, cfg=cfg, model=model, device="cuda")
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = launch_counts(fa)
    n_layers = cfg["model"]["core"]["n_layers"]
    want = {"flash_fwd": batches * V2A_STEPS * n_layers, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    if launches != want:
        raise AssertionError(f"stream launches {launches}, expected {want}")
    samples = (windows - 1) * int(round(sr * hop_s)) + int(round(sr * win_s))
    if wav.shape != (samples,) or samples != 176_000 or not np.all(np.isfinite(wav)) or \
            np.abs(wav).max() > 1:
        raise AssertionError(f"bad stitched audio: {wav.shape}, max {np.abs(wav).max()}")
    emit({"phase": "spec8_stream", "config": "mvp+specificity8", "prompt_frames": STREAM_FRAMES,
          "windows": windows, "max_batch_windows": max_batch, "batches": batches,
          "steps": V2A_STEPS, "stream_s": stream_s, "spec8_v2a_batch_s": batch_s,
          "stream_vs_batch": stream_s / batch_s, "audio_samples": int(wav.shape[0]),
          "audio_seconds": wav.shape[0] / sr, "wav_max_abs": float(np.abs(wav).max()),
          "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def text_family_valid(prompts, N: int, n_target: int):
    """[len(prompts), N] key validity of a text family's attention: each
    prompt's 77 text positions (BOS, bytes and EOS valid, pads masked), then
    n_target valid target tokens, then the masked tail the core pads to
    seq_multiple."""
    import torch

    from multimodal_diffusion_torch.models.text_encoder import PAD_ID, tokenize_text

    ids = torch.from_numpy(tokenize_text(prompts, 77))
    valid = torch.zeros((len(prompts), N), dtype=torch.bool)
    valid[:, :77] = ids != PAD_ID
    valid[:, 77:77 + n_target] = True
    return valid


def text_family_kernel_cases(fa, cycles_per_s):
    """bf16, the kernels at the text families' shapes and masks, each against
    its plain version, timed beside it, SDPA and the bound: the t2i sampler's
    core (cond and negative prompts stacked, 1024 image keys, 51 tail keys
    masked), the t2i train step's core and text encoder (the backward pair
    too), the t2a sampler's core and a sampling batch's text encoder."""
    import torch

    from multimodal_diffusion_torch.tools.profile_t2i import NEGATIVE, PROMPTS

    dev = torch.device("cuda")
    results = {}
    for name, shape, n_target, backward in TEXT_FAMILY_CASES:
        B, H, N, Dh = shape
        half = B // 2
        prompts = (PROMPTS * B)[:B] if backward else \
            (PROMPTS * B)[:half] + [NEGATIVE] * (B - half)
        valid = text_family_valid(prompts, N, n_target).to(dev)
        n_valid = [int(x) for x in valid.sum(dim=1).tolist()]
        g = torch.Generator(device=dev).manual_seed(80 + N)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        out, lse, rec = forward_case(fa, name, q, k, v, valid, n_valid, cycles_per_s)
        results[name] = {"fwd": rec}
        if backward:
            dout = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
            results[name].update(backward_case(fa, name, q, k, v, valid, out, lse, dout,
                                               n_valid, cycles_per_s))
        del q, k, v, out, lse
    torch.cuda.empty_cache()
    return results


def t2i_denoise_check(model, batch: int) -> float:
    """One full-width t2i denoise of the CFG-doubled batch (the prompts and
    the negative prompt, noisy latents, mixed timesteps) with and without
    the kernel: max |diff| / max |dense|."""
    import numpy as np
    import torch

    from multimodal_diffusion_torch.models.latent_text2image import encode_prompts
    from multimodal_diffusion_torch.models.text_encoder import tokenize_text
    from multimodal_diffusion_torch.tools.profile_t2i import NEGATIVE, PROMPTS

    c = model.cfg
    rng = np.random.default_rng(0)
    ids = tokenize_text((PROMPTS * batch)[:batch], c.text.max_len)
    neg = tokenize_text([NEGATIVE] * batch, c.text.max_len)
    z = torch.from_numpy(rng.normal(size=(2 * batch,) + c.latent_shape).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, c.steps, 2 * batch))
    with torch.inference_mode():
        text2, pad2 = encode_prompts(model, ids, neg)
        a, b = (model.denoise(z.cuda(), t.cuda(), text2, pad2, use_kernel=k)
                for k in (True, False))
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def t2i_512_phase(fa, work_dir):
    """configs/t2i_512.yaml at full width through sample_images and the CLI's
    weight path (a port checkpoint of N(0, 0.02) weights under
    paths.ckpt_dir, restored by sample_t2i.build_t2i), then the CLI itself."""
    import numpy as np
    import torch
    from PIL import Image

    from multimodal_diffusion_torch.infer import sample_t2i
    from multimodal_diffusion_torch.tools.profile_t2i import (CONFIG, NEGATIVE, PROMPTS,
                                                              t2i_workload)

    ckpt_dir = work_dir / "t2i_ckpt"
    t0 = time.perf_counter()
    cfg, model, run = t2i_workload(T2I_BATCH, T2I_STEPS, ckpt_dir=ckpt_dir)
    setup_s = time.perf_counter() - t0
    c = model.cfg
    n_core, n_text = c.core.n_layers, c.text.core.n_layers
    # 50 steps x 16 core layers, and the text encoder's 4 layers once for the
    # prompts and once for the negative prompts (two calls, as the JAX sampler)
    expected = T2I_STEPS * n_core + 2 * n_text
    want = {"flash_fwd": expected, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    shape = (T2I_BATCH, c.image_size, c.image_size, 3)
    launches = {"flash_fwd": 0}

    def batch(**kw):
        reset_launch_counts(fa)
        t0 = time.perf_counter()
        imgs = run(**kw)
        wall = time.perf_counter() - t0
        got = launch_counts(fa)
        if got != want:
            raise AssertionError(f"t2i batch {kw}: launches {got}, expected {want}")
        if imgs.shape != shape or imgs.dtype != np.uint8:
            raise AssertionError(f"t2i images {imgs.shape} {imgs.dtype}, expected {shape} uint8")
        launches["flash_fwd"] += got["flash_fwd"]
        return imgs, wall

    torch.cuda.reset_peak_memory_stats()
    first, first_s = batch()
    times = [batch()[1] for _ in range(3)]
    median_s = statistics.median(times)
    empty_neg, _ = batch(negative=None)
    if np.array_equal(first, empty_neg):
        raise AssertionError("the negative prompt did not change the images")
    dpm, dpm_s = batch(sampler="dpmpp_2m")
    if np.array_equal(first, dpm):
        raise AssertionError("dpmpp_2m gave the ddim images")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rel = t2i_denoise_check(model, T2I_BATCH)
    if not rel <= T2I_DENOISE_REL_TOL:
        raise AssertionError(f"t2i denoise kernel vs dense: {rel} > {T2I_DENOISE_REL_TOL}")
    del model
    torch.cuda.empty_cache()

    # the CLI in this process, on the same checkpoint and seed
    overlay = work_dir / "t2i_overlay.yaml"
    overlay.write_text(f"paths:\n  ckpt_dir: {json.dumps(str(ckpt_dir))}\n")
    reset_launch_counts(fa)
    t0 = time.perf_counter()
    pngs = sample_t2i.main(["--config", str(CONFIG), str(overlay), "--prompt", *PROMPTS,
                            "--negative", *[NEGATIVE] * T2I_BATCH, "--seed", "1",
                            "--out-dir", str(work_dir / "t2i_png")])
    cli_s = time.perf_counter() - t0
    got = launch_counts(fa)
    if got != want:
        raise AssertionError(f"t2i CLI launches {got}, expected {want}")
    launches["flash_fwd"] += got["flash_fwd"]
    cli_imgs = []
    for p in pngs:
        with Image.open(p) as im:
            cli_imgs.append(np.asarray(im.convert("RGB")))
    if len(cli_imgs) != T2I_BATCH or any(im.shape != shape[1:] for im in cli_imgs):
        raise AssertionError(f"the CLI wrote {len(cli_imgs)} images")
    emit({"phase": "t2i_512", "config": "configs/t2i_512.yaml", "batch": T2I_BATCH,
          "steps": T2I_STEPS, "guidance": float(cfg["sampling"]["guidance_scale"]),
          "negative": NEGATIVE, "compute_dtype": "bfloat16",
          "core": {"d_model": c.core.d_model, "n_layers": n_core, "n_heads": c.core.n_heads,
                   "tokens": 77 + c.n_img_tokens, "seq_multiple": c.core.seq_multiple},
          "setup_s": setup_s, "first_batch_s": first_s, "batch_s": times,
          "median_batch_s": median_s, "images_per_s": T2I_BATCH / median_s,
          "dpmpp_2m_batch_s": dpm_s, "cli_s": cli_s,
          "cli_images_equal_first_batch": bool(np.array_equal(np.stack(cli_imgs), first)),
          "flash_fwd_per_batch": expected, "denoise_kernel_vs_dense_rel_err": rel,
          "rel_tol": T2I_DENOISE_REL_TOL, "images_mean": float(first.mean()),
          "peak_mem_gb": peak_gb})
    return launches, {"sampler": "ddim", "steps": T2I_STEPS, "batch": T2I_BATCH,
                      "median_batch_s": median_s, "images_per_s": T2I_BATCH / median_s}


def t2i_train_phase(fa):
    """make_t2i_train_step at configs/t2i_512.yaml's width and batch (halved
    while it does not fit), the config's AdamW (warmup-cosine, clip 1.0),
    seeded random init."""
    import numpy as np
    import torch

    from multimodal_diffusion_torch.infer.sample_t2i import build_t2i
    from multimodal_diffusion_torch.models import latent_text2image as TL
    from multimodal_diffusion_torch.models.text_encoder import tokenize_text
    from multimodal_diffusion_torch.tools.profile_t2i import CONFIG, PROMPTS
    from multimodal_diffusion_torch.train.trainer import global_norm, make_optimizer
    from multimodal_diffusion_torch.utils.io import load_config

    cfg = load_config(CONFIG)
    cfg["paths"]["ckpt_dir"] = str(REPO / "runs" / "chip_smoke_no_t2i_checkpoint")
    model = build_t2i(cfg, device="cuda").train()
    c = model.cfg
    named = list(model.named_parameters())
    params = [p for _, p in named]
    B = int(cfg["data"]["batch_size"])
    rng = np.random.default_rng(0)
    while True:
        try:
            images = torch.from_numpy(rng.uniform(-1, 1, (B, 3, c.image_size, c.image_size))
                                      .astype(np.float32)).cuda()
            ids = tokenize_text((PROMPTS * B)[:B], c.text.max_len)
            opt = make_optimizer(cfg, named)
            step = TL.make_t2i_train_step(model, opt, float(cfg["training"]["cfg_drop_prob"]),
                                          torch.Generator(device="cuda").manual_seed(0))
            before = [p.detach().clone() for p in params]
            t0 = time.perf_counter()
            losses = [float(step(images, ids))]  # LR(0) = 0 in warmup
            break
        except torch.cuda.OutOfMemoryError:
            images = opt = step = before = None
            torch.cuda.empty_cache()
            B //= 2
            if B < 1:
                raise
    if any(not torch.equal(p, b) for p, b in zip(params, before)):
        raise AssertionError("a t2i parameter moved in the first step, at LR 0")
    for _ in range(T2I_TRAIN_WARMUP - 1):
        losses.append(float(step(images, ids)))
    warmup_s = time.perf_counter() - t0
    if all(torch.equal(p, b) for p, b in zip(params, before)):
        raise AssertionError("no t2i parameter moved after a step with a nonzero LR")
    del before
    torch.cuda.reset_peak_memory_stats()
    step_s, per_step = [], []
    for _ in range(T2I_TRAIN_STEPS):
        reset_launch_counts(fa)
        t0 = time.perf_counter()
        losses.append(float(step(images, ids)))
        step_s.append(time.perf_counter() - t0)
        per_step.append(launch_counts(fa))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # 16 core layers and the text encoder's 4, each kernel once a layer
    expected = c.core.n_layers + c.text.core.n_layers
    if any(n != expected for counts in per_step for n in counts.values()):
        raise AssertionError(f"t2i train launches {per_step}, expected {expected} of each")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite t2i losses {losses}")

    # one full-width gradient with the kernels and with dense attention, on
    # 8 samples of the batch and fixed draws
    n = min(B, 8)
    draws = TL.draw_t2i_randomness(torch.Generator(device="cuda").manual_seed(7), c, n)
    abar = torch.as_tensor(TL.alpha_bar(c), device="cuda")
    ids_n = torch.as_tensor(ids[:n], device="cuda")
    grads = {}
    for use_kernel in (True, False):
        loss = TL.t2i_loss(model, images[:n], ids_n, draws, abar, use_kernel)
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        grads[use_kernel] = {k: g for (k, _), g in zip(named, gs) if g is not None}
    qkv = [k for k in grads[False] if k.endswith("attn.qkv.weight")]
    qkv_rel = max(float((grads[True][k] - grads[False][k]).abs().max())
                  / float(grads[False][k].abs().max()) for k in qkv)
    norms = {k: float(global_norm(list(g.values()))) for k, g in grads.items()}
    norm_rel = abs(norms[True] - norms[False]) / norms[False]
    reached = {part: any(k.startswith(part) for k in grads[True])
               for part in ("vae.enc_", "text_encoder.", "vae.dec")}
    if len(qkv) != expected or max(qkv_rel, norm_rel) > T2I_GRAD_REL_TOL:
        raise AssertionError(f"t2i grads with the kernels vs dense: qkv {qkv_rel}, norm "
                             f"{norm_rel} (tol {T2I_GRAD_REL_TOL}, {len(qkv)} qkv grads)")
    if reached != {"vae.enc_": True, "text_encoder.": True, "vae.dec": False}:
        raise AssertionError(f"t2i grads reach {reached}")
    emit({"phase": "t2i_train", "config": "configs/t2i_512.yaml", "batch": B,
          "config_batch": int(cfg["data"]["batch_size"]), "compute_dtype": "bfloat16",
          "warmup_steps": T2I_TRAIN_WARMUP, "warmup_s": warmup_s, "step_s": step_s,
          "median_step_s": statistics.median(step_s),
          "train_images_per_s": B / statistics.median(step_s), "losses": losses,
          "launches_per_step": per_step[0], "launches_expected": expected,
          "grad_check": {"batch": n, "qkv_weight_rel_err": qkv_rel,
                         "grad_norm_rel_err": norm_rel, "grad_norm_kernel": norms[True],
                         "grad_norm_dense": norms[False], "rel_tol": T2I_GRAD_REL_TOL,
                         "reached": reached},
          "peak_mem_gb": peak_gb})
    return {k: sum(counts[k] for counts in per_step) for k in per_step[0]}


def t2a_phase(fa):
    """Text2AudioConfig() in bf16 with N(0, 0.02) weights: B=8, 50 DDIM
    steps with batched CFG (guidance 3.0, empty negative prompts), and one
    clip through Griffin-Lim."""
    import numpy as np
    import torch

    from multimodal_diffusion_torch.models.text2audio_mel import (Text2AudioConfig,
                                                                  Text2AudioModel,
                                                                  make_t2a_sampler,
                                                                  mel_to_waveform)
    from multimodal_diffusion_torch.models.text_encoder import tokenize_text

    bf16 = torch.bfloat16
    base = Text2AudioConfig()
    c = dataclasses.replace(
        base, dtype=bf16, core=dataclasses.replace(base.core, dtype=bf16),
        text=dataclasses.replace(base.text, dtype=bf16,
                                 core=dataclasses.replace(base.text.core, dtype=bf16)))
    model = Text2AudioModel(c)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    model = model.cuda().eval()
    ids = tokenize_text(T2A_PROMPTS[:T2A_BATCH], c.text.max_len)
    neg = tokenize_text([""] * T2A_BATCH, c.text.max_len)
    sample = make_t2a_sampler(model, T2A_STEPS)
    expected = T2A_STEPS * c.core.n_layers + 2 * c.text.core.n_layers
    want = {"flash_fwd": expected, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    times, launches = [], {"flash_fwd": 0}
    for _ in range(3):
        reset_launch_counts(fa)
        t0 = time.perf_counter()
        mel = sample(ids, neg, generator=torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = launch_counts(fa)
        if got != want:
            raise AssertionError(f"t2a launches {got}, expected {want}")
        launches["flash_fwd"] += got["flash_fwd"]
    mel = mel.float().cpu().numpy()
    if mel.shape != (T2A_BATCH, 1, c.n_mels, c.frames) or not np.all(np.isfinite(mel)):
        raise AssertionError(f"bad mels {mel.shape}")
    t0 = time.perf_counter()
    wav = mel_to_waveform(c, mel[0])
    gl_s = time.perf_counter() - t0
    if wav.ndim != 1 or len(wav) < (c.frames - 1) * c.hop or not np.all(np.isfinite(wav)):
        raise AssertionError(f"bad Griffin-Lim waveform {wav.shape}")
    emit({"phase": "t2a", "config": "Text2AudioConfig()", "batch": T2A_BATCH,
          "steps": T2A_STEPS, "compute_dtype": "bfloat16", "tokens": 77 + c.n_tokens,
          "first_batch_s": times[0], "batch_s": times[1:],
          "median_batch_s": statistics.median(times[1:]),
          "clips_per_s": T2A_BATCH / statistics.median(times[1:]),
          "flash_fwd_per_batch": expected, "mel_shape": list(mel.shape),
          "mel_abs_max": float(np.abs(mel).max()), "griffin_lim_s": gl_s,
          "wav_samples": int(wav.shape[0]), "wav_abs_max": float(np.abs(wav).max())})
    return launches


def text_family_phases(fa):
    """t2i_512, t2i_train and t2a, in a scratch directory under runs/
    (deleted at the end): ({phase: launches}, the t2i_512 batch's row)."""
    import shutil
    import tempfile

    import torch

    (REPO / "runs").mkdir(exist_ok=True)
    work_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_t2i_", dir=REPO / "runs"))
    try:
        t2i_launches, t2i_row = t2i_512_phase(fa, work_dir)
        by_path = {"t2i_512": t2i_launches}
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    by_path["t2i_train"] = t2i_train_phase(fa)
    torch.cuda.empty_cache()
    by_path["t2a"] = t2a_phase(fa)
    torch.cuda.empty_cache()
    return by_path, t2i_row


def serve_spec8_phase(fa):
    """The serving runner (serve/runner.py) at flagship width: InferenceRunner
    on configs/mvp.yaml + configs/specificity8.yaml with paths emptied (the
    seeded init), bf16 serving weights, max_batch 8; a manifest, then two
    requests through an inbox."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from multimodal_diffusion_torch.infer.sample_clip import sample_one_direction
    from multimodal_diffusion_torch.media.audio_io import read_wav, write_wav
    from multimodal_diffusion_torch.media.video_io import load_frames_dir, write_frames
    from multimodal_diffusion_torch.serve.runner import InferenceRunner, Request, pad_batch
    from multimodal_diffusion_torch.utils.io import specificity8_config

    cfg = specificity8_config()
    cfg["paths"] = {}
    for mod in ("audio", "video"):
        cfg["diffusion"][mod]["sampler_steps"] = V2A_STEPS
    fps, sr = int(cfg["video"]["fps"]), int(cfg["audio"]["sr"])
    H, W = cfg["video"]["size"]
    T = int(round(fps * float(cfg["data"]["clip_seconds"])))
    L = int(round(sr * float(cfg["data"]["clip_seconds"])))
    per_batch = V2A_STEPS * cfg["model"]["core"]["n_layers"]
    (REPO / "runs").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=REPO / "runs"))
    runner = None
    try:
        t0 = time.perf_counter()
        runner = InferenceRunner(cfg, bf16_params=True, max_batch=SERVE_MAX_BATCH,
                                 device="cuda")
        setup_s = time.perf_counter() - t0
        dtypes = sorted({str(p.dtype) for p in runner.model.parameters()})
        if dtypes != ["torch.bfloat16"]:
            raise AssertionError(f"serving weights are {dtypes}, not bf16")
        reqs = []
        for i, f in enumerate(prompt_frames(SERVE_V2A, T, H, W, seed=17)):
            write_frames(f, work / f"v2a_{i}")
            reqs.append({"id": f"v2a_{i}", "direction": "v2a", "input": str(work / f"v2a_{i}"),
                         "output": str(work / f"v2a_{i}.wav")})
        rng = np.random.default_rng(18)
        t = np.arange(L) / sr
        for i in range(SERVE_A2V):
            y = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 800) * t) + rng.normal(0, 0.05, L)
            write_wav(work / f"a2v_{i}.wav", y.astype(np.float32), sr)
            reqs.append({"id": f"a2v_{i}", "direction": "a2v", "input": str(work / f"a2v_{i}.wav"),
                         "output": str(work / f"a2v_{i}")})
        write_frames(prompt_frames(1, STREAM_FRAMES, H, W, seed=19)[0], work / "stream")
        reqs.append({"id": "stream", "direction": "stream_v2a", "input": str(work / "stream"),
                     "output": str(work / "stream.wav")})
        reqs.append({"id": "bad", "direction": "v2a", "input": str(work / "missing"),
                     "output": str(work / "bad.wav")})
        (work / "requests.json").write_text(json.dumps({"requests": reqs}))
        # one request first, so the manifest's batches run warm (cuDNN plans,
        # the allocator); it counts as set-up
        t0 = time.perf_counter()
        warm = runner.submit(Request(id="warm", direction="v2a", input_path=reqs[0]["input"],
                                     output_path=str(work / "warm.wav")))
        if not warm.done.wait(timeout=600) or warm.error:
            raise AssertionError(f"the warm-up request failed: {warm.error}")
        warm_s = time.perf_counter() - t0
        warm_batches = runner.scheduler.batches_run

        reset_launch_counts(fa)
        t0 = time.perf_counter()
        done = runner.process_manifest(work / "requests.json")
        wall_s = time.perf_counter() - t0
        launches = launch_counts(fa)
        batches = runner.scheduler.batches_run - warm_batches
        want = {"flash_fwd": batches * per_batch, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
        if launches != want:
            raise AssertionError(f"serving launches {launches} in {batches} batches, "
                                 f"expected {want}")
        errors = {r.id: r.error for r in done if r.error}
        if set(errors) != {"bad"} or not errors["bad"].startswith("load:"):
            raise AssertionError(f"request errors {errors}: only 'bad' should fail, at load")
        for i in range(SERVE_V2A):
            wav, got_sr = read_wav(work / f"v2a_{i}.wav")
            if wav.shape != (L,) or got_sr != sr or not np.all(np.isfinite(wav)) or \
                    np.abs(wav).max() > 1:
                raise AssertionError(f"served v2a_{i}: {wav.shape} at {got_sr} Hz")
        for i in range(SERVE_A2V):
            frames = load_frames_dir(work / f"a2v_{i}")
            if frames.shape != (T, H, W, 3) or frames.dtype != np.uint8:
                raise AssertionError(f"served a2v_{i}: frames {frames.shape} {frames.dtype}")
        stream, _ = read_wav(work / "stream.wav")
        if stream.shape != (176_000,) or not np.all(np.isfinite(stream)) or \
                np.abs(stream).max() > 1:
            raise AssertionError(f"served stream: {stream.shape}")
        records = list(runner.scheduler.records)[warm_batches:]
        by_seq = {it.seq: it for r in done for it in r.items}
        n_clips = len(by_seq)
        if n_clips != SERVE_V2A + SERVE_A2V + 9 or sum(len(r.seqs) for r in records) != n_clips:
            raise AssertionError(f"{n_clips} work items served in {len(records)} batches")

        # the most padded v2a batch again, straight through sample_one_direction
        rec = min((r for r in records if r.key[0] == "v2a"), key=lambda r: len(r.seqs))
        items = [by_seq[q] for q in rec.seqs]
        direct = sample_one_direction(
            cfg=cfg, model=runner.model, prompt_modality="video",
            prompt_video=pad_batch([it.prompt for it in items], SERVE_MAX_BATCH),
            device="cuda")["audio"]
        if not all(np.array_equal(it.out, direct[i]) for i, it in enumerate(items)):
            raise AssertionError("a served v2a output differs from sample_one_direction "
                                 "on the same padded batch")

        # two requests through an inbox, each answered by its result file
        inbox = work / "inbox"
        inbox.mkdir()
        for i in range(SERVE_WATCH):
            (inbox / f"req_{i}.json").write_text(json.dumps({
                "id": f"w{i}", "direction": "v2a", "input": str(work / f"v2a_{i}"),
                "output": str(work / f"watch_{i}.wav")}))
        before = runner.scheduler.batches_run
        stop = threading.Event()
        reset_launch_counts(fa)
        t0 = time.perf_counter()
        watcher = threading.Thread(target=runner.watch, args=(inbox,),
                                   kwargs={"poll_s": 0.05, "stop_event": stop}, daemon=True)
        watcher.start()
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and \
                len(list(inbox.glob("*.result.json"))) < SERVE_WATCH:
            time.sleep(0.05)
        watch_s = time.perf_counter() - t0
        (inbox / "STOP").touch()
        watcher.join(timeout=60)
        stop.set()
        if watcher.is_alive():
            raise AssertionError("the watch loop did not stop on the STOP file")
        results = [json.loads(p.read_text()) for p in sorted(inbox.glob("*.result.json"))]
        if len(results) != SERVE_WATCH or not all(r["ok"] for r in results):
            raise AssertionError(f"watch results {results}")
        watch_batches = runner.scheduler.batches_run - before
        got = launch_counts(fa)
        if got["flash_fwd"] != watch_batches * per_batch:
            raise AssertionError(f"watch launches {got} in {watch_batches} batches")
        launches["flash_fwd"] += got["flash_fwd"]
        for i in range(SERVE_WATCH):
            wav, _ = read_wav(work / f"watch_{i}.wav")
            if wav.shape != (L,) or not np.all(np.isfinite(wav)):
                raise AssertionError(f"watch request {i}: {wav.shape}")
        manifest_records = records
    finally:
        if runner is not None:
            runner.close()
        shutil.rmtree(work, ignore_errors=True)
    if runner.scheduler._thread.is_alive() or runner._finalizers:
        raise AssertionError("a serving thread outlived close()")
    batch_s = [r.seconds for r in manifest_records]
    emit({"phase": "serve_spec8", "config": "mvp+specificity8", "steps": V2A_STEPS,
          "bf16_params": True, "max_batch": SERVE_MAX_BATCH, "setup_s": setup_s,
          "warm_request_s": warm_s,
          "requests": len(reqs), "requests_ok": len(reqs) - 1, "work_items": n_clips,
          "manifest_s": wall_s, "requests_per_s": (len(reqs) - 1) / wall_s,
          "clips_per_s": n_clips / wall_s,
          "batches": [{"key": [r.key[0], list(r.key[1])], "items": len(r.seqs),
                       "seconds": r.seconds, "queue_wait_s_max": max(r.queue_wait_s),
                       "queue_wait_s_median": statistics.median(r.queue_wait_s)}
                      for r in manifest_records],
          "median_batch_s": statistics.median(batch_s),
          "flash_fwd_per_batch": per_batch, "batches_run": batches,
          "served_equals_direct_items": len(items), "watch_s": watch_s,
          "watch_batches": watch_batches, "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def int8_product_cases(cycles_per_s):
    """int8_linear on the card against its CPU path (bit for bit) and timed
    against bf16 F.linear at the hot projections' shapes."""
    import torch
    import torch.nn.functional as F

    from multimodal_diffusion_torch.ops import quant as Q

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(20)
    out = []
    for name, M, K, N in INT8_CASES:
        x = torch.randn(M, K, device="cuda", generator=gen).to(bf16)
        w = (torch.randn(N, K, device="cuda", generator=gen) / K ** 0.5).to(bf16)
        b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(bf16)
        a8, s_a = Q.quantize_rowwise(x)
        qw = Q.quantize_weight(w, bf16)
        y32 = Q.int8_matmul(a8, qw[0])
        y = Q.int8_linear(x, w, b, bf16, qw)
        short = Q.int8_matmul(a8[:5], qw[0])  # padded to 17 rows inside
        torch.cuda.synchronize()
        rows = slice(0, INT8_CPU_ROWS)
        xc, wc, bc = x[rows].cpu(), w.cpu(), b.cpu()
        ca8, cs_a = Q.quantize_rowwise(xc)
        cqw = Q.quantize_weight(wc, bf16)
        pairs = {"a8": (a8[rows], ca8), "s_a": (s_a[rows], cs_a), "w8": (qw[0], cqw[0]),
                 "s_w": (qw[1], cqw[1]), "int32": (y32[rows], Q.int8_matmul(ca8, cqw[0])),
                 "out": (y[rows], Q.int8_linear(xc, wc, bc, bf16, cqw)),
                 "short_int32": (short, y32[:5].cpu())}
        differ = [k for k, (g, c) in pairs.items() if not torch.equal(g.cpu(), c)]
        if differ:
            raise AssertionError(f"int8 {name}: the card differs from the CPU path in {differ}")
        ref = F.linear(x, w, b).float()
        rel = float((y.float() - ref).norm() / ref.norm())
        if not rel < INT8_REL_TOL:
            raise AssertionError(f"int8 {name}: {rel} from bf16 F.linear")
        ms = {"quantize_ms": cuda_median_ms(lambda: Q.quantize_rowwise(x), cycles_per_s),
              "int_mm_ms": cuda_median_ms(lambda: Q.int8_matmul(a8, qw[0]), cycles_per_s),
              "int8_linear_ms": cuda_median_ms(lambda: Q.int8_linear(x, w, b, bf16, qw),
                                               cycles_per_s),
              "bf16_linear_ms": cuda_median_ms(lambda: F.linear(x, w, b), cycles_per_s)}
        ops = 2.0 * M * K * N
        t_mm = ((M * K + N * K + 4 * M * N) / HBM_BYTES_PER_S, ops / PEAK_INT8_OPS)
        t_lin = ((2 * M * K + N * K + 6 * N + 2 * M * N) / HBM_BYTES_PER_S, ops / PEAK_INT8_OPS)
        t_bf = ((2 * M * K + 2 * N * K + 2 * N + 2 * M * N) / HBM_BYTES_PER_S,
                ops / PEAK_FLOPS["bfloat16"])
        bound = {"quantize_bound_ms": (3 * M * K + 4 * M) / HBM_BYTES_PER_S * 1e3}
        for key, (tb, to) in (("int_mm", t_mm), ("int8_linear", t_lin), ("bf16_linear", t_bf)):
            bound[f"{key}_bound_ms"] = max(tb, to) * 1e3
            bound[f"{key}_bound_by"] = "bytes" if tb >= to else "operations"
        out.append({"name": name, "shape_mkn": [M, K, N], "bit_equal_rows": INT8_CPU_ROWS,
                    "rel_err_vs_bf16_linear": rel, **ms, **bound})
        del x, w, b, a8, s_a, qw, y32, y, ref
    torch.cuda.empty_cache()
    return out


def int8_phases(fa, t2i_bf16):
    """The W8A8 core on the card: the products (int8_product_cases), one
    flagship v2a batch under model.core.quant int8 (what configs/int8.yaml
    sets) with bf16 serving weights and its denoise_tokens against the same
    weights unquantized, then the t2i serving row (configs/t2i_512.yaml,
    int8, dpmpp_2m at 12 steps, B = 8, bf16 weights) beside `t2i_bf16`, the
    t2i_512 phase's bf16 ddim@50 row. {path: launches}."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from multimodal_diffusion_torch.models.diffusion import AVDiffusionModel
    from multimodal_diffusion_torch.tools.profile_t2i import t2i_workload
    from multimodal_diffusion_torch.tools.profile_v2a import v2a_workload

    products = int8_product_cases(spin_cycles_per_s())

    cfg, model, run = v2a_workload(V2A_CLIPS, V2A_STEPS, config="specificity8", quant="int8",
                                   bf16_params=True)
    per_batch = V2A_STEPS * cfg["model"]["core"]["n_layers"]
    want = {"flash_fwd": per_batch, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    reset_launch_counts(fa)
    t0 = time.perf_counter()
    wav = run()["audio"]
    first_s = time.perf_counter() - t0
    spec8 = launch_counts(fa)
    if spec8 != want:
        raise AssertionError(f"int8 flagship v2a launches {spec8}, expected {want}")
    check_wav(wav, cfg, "int8 flagship v2a")
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    # the same weights with the core unquantized (tensors shared, not copied)
    c = model.cfg
    with torch.device("meta"):
        plain = AVDiffusionModel(dataclasses.replace(
            c, core=dataclasses.replace(c.core, quant="none")))
    plain.load_state_dict(model.state_dict(), assign=True)
    plain.eval()
    with torch.inference_mode():
        q, ref = spec8_denoise(model), spec8_denoise(plain)
    denoise = {}
    for key in ("eps_v", "eps_a"):
        a, b = q[key].float(), ref[key].float()
        denoise[key] = float((a - b).norm() / b.norm())
        if not (denoise[key] < INT8_REL_TOL and not torch.equal(a, b)):
            raise AssertionError(f"int8 flagship denoise_tokens {key}: {denoise[key]} from the "
                                 f"unquantized core (bound {INT8_REL_TOL}, must differ)")
    del model, plain, run, q, ref
    torch.cuda.empty_cache()

    (REPO / "runs").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_t2i_int8_", dir=REPO / "runs"))
    try:
        t2i_cfg, t2i, sample = t2i_workload(T2I_SERVE_BATCH, T2I_SERVE_STEPS,
                                            ckpt_dir=work / "ckpt", quant="int8",
                                            bf16_params=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tc = t2i.cfg
    expected = T2I_SERVE_STEPS * tc.core.n_layers + 2 * tc.text.core.n_layers
    want = {"flash_fwd": expected, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    t2i_launches, t2i_times = {"flash_fwd": 0}, []
    for i in range(4):  # a warm-up, then 3 timed batches
        reset_launch_counts(fa)
        t0 = time.perf_counter()
        imgs = sample(sampler="dpmpp_2m")
        t2i_times.append(time.perf_counter() - t0)
        got = launch_counts(fa)
        if got != want:
            raise AssertionError(f"int8 t2i serving batch launches {got}, expected {want}")
        shape = (T2I_SERVE_BATCH, tc.image_size, tc.image_size, 3)
        if imgs.shape != shape or imgs.dtype != np.uint8:
            raise AssertionError(f"int8 t2i images {imgs.shape} {imgs.dtype}")
        t2i_launches["flash_fwd"] += got["flash_fwd"]
    median_s = statistics.median(t2i_times[1:])
    emit({"phase": "int8", "compute_dtype": "bfloat16", "products": products,
          "spec8_v2a": {"config": "mvp+specificity8 + model.core.quant int8", "clips": V2A_CLIPS,
                        "steps": V2A_STEPS, "bf16_params": True, "launches": spec8,
                        "first_batch_s": first_s, "batch_s": times,
                        "clips_per_s": V2A_CLIPS / statistics.median(times),
                        "wav_max_abs": float(np.abs(wav).max()),
                        "denoise_rel_err_vs_unquantized": denoise, "rel_tol": INT8_REL_TOL},
          "t2i_serving": {"config": "configs/t2i_512.yaml + model.core.quant int8",
                          "batch": T2I_SERVE_BATCH, "steps": T2I_SERVE_STEPS,
                          "sampler": "dpmpp_2m", "bf16_params": True,
                          "flash_fwd_per_batch": expected, "first_batch_s": t2i_times[0],
                          "batch_s": t2i_times[1:], "median_batch_s": median_s,
                          "images_per_s": T2I_SERVE_BATCH / median_s,
                          "images_mean": float(imgs.mean())},
          "t2i_bf16_ddim50": t2i_bf16,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del t2i, sample
    torch.cuda.empty_cache()
    return {"int8_spec8_v2a": spec8, "int8_t2i_serving": t2i_launches}


def pixel_kernel_cases(fa, cycles_per_s):
    """bf16, unmasked: the forward at the pixel sampler's [16, 6, 64, 64] and
    the forward and backward pair at the train step's [128, 6, 64, 64], each
    against its plain version, timed beside it, SDPA and the bound."""
    import torch

    dev = torch.device("cuda")
    results = {}
    for name, shape, backward in PIXEL_KERNEL_CASES:
        B, H, N, Dh = shape
        g = torch.Generator(device=dev).manual_seed(90 + B)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        out, lse, rec = forward_case(fa, name, q, k, v, None, [N] * B, cycles_per_s)
        results[name] = {"fwd": rec}
        if backward:
            dout = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
            results[name].update(backward_case(fa, name, q, k, v, None, out, lse, dout,
                                               [N] * B, cycles_per_s))
    return results


def pixel_config(work_dir):
    """configs/pixel32.yaml with its paths and images under `work_dir`, a
    log line every step and no checkpoint before the last: (the config,
    the CLI's --config arguments)."""
    from multimodal_diffusion_torch.utils.io import load_config

    overlay = work_dir / "pixel_overlay.yaml"
    overlay.write_text(json.dumps({
        "paths": {"out_root": str(work_dir), "ckpt_dir": str(work_dir / "ckpt"),
                  "log_dir": str(work_dir / "logs"), "samples_dir": str(work_dir / "samples")},
        "data": {"train_images": str(work_dir / "images")},
        "training": {"log_every": 1, "ckpt_every": 100000}}))
    args = [str(REPO / "configs" / "pixel32.yaml"), str(overlay)]
    return load_config(*args), args


def pixel_train_phase(fa, work_dir):
    """train/train_pixel.main at configs/pixel32.yaml's width and batch on a
    folder of 32x32 JPEGs written here, then one full-width gradient with
    the kernels and with dense attention."""
    import numpy as np
    import torch
    from PIL import Image

    from multimodal_diffusion_torch.datasets import native_loader
    from multimodal_diffusion_torch.infer.sample_pixel import build_pixel
    from multimodal_diffusion_torch.models.image_diffusion import (draw_pixel_randomness,
                                                                   pixel_loss, pixel_schedule)
    from multimodal_diffusion_torch.train import train_pixel
    from multimodal_diffusion_torch.train.trainer import global_norm
    from multimodal_diffusion_torch.utils.profiling import calib_tflops, flops_mmdit_forward, mfu

    images = work_dir / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:32, 0:32]
    for i in range(PIXEL_IMAGES):  # smooth colour ramps and a little noise
        base = rng.uniform(0, 255, 3) + rng.uniform(-3, 3, 3) * (xx[..., None] + yy[..., None])
        img = np.clip(base + rng.normal(0, 8, (32, 32, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(images / f"img_{i:04d}.jpg", quality=95)
    # iter_image_batches decodes a folder of JPEGs with the native loader
    # when it builds (g++ and libjpeg's headers), else with PIL
    decode = "native" if native_loader.available() else "PIL"
    cfg, args = pixel_config(work_dir)
    B = int(cfg["data"]["batch_size"])
    n_layers = int(cfg["model"]["core"]["n_layers"])
    steps = PIXEL_WARMUP + PIXEL_STEPS
    reset_launch_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = train_pixel.main(["--config", *args, "--max-steps", str(steps)])
    cli_s = time.perf_counter() - t0
    launches = launch_counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if done != steps or any(n != n_layers * steps for n in launches.values()):
        raise AssertionError(f"pixel train: {done} steps, launches {launches}, expected "
                             f"{n_layers} of each kernel a step")
    logs = [json.loads(line) for line in (work_dir / "logs" / "metrics.jsonl").open()]
    if [m["step"] for m in logs] != list(range(1, steps + 1)) or \
            not all(np.isfinite(m["loss"]) for m in logs):
        raise AssertionError(f"pixel train logs {logs}")
    if not (work_dir / "ckpt" / str(steps) / "params.pt").is_file():
        raise AssertionError("pixel train wrote no final checkpoint")
    step_s = [1.0 / m["steps_per_sec"] for m in logs[PIXEL_WARMUP:]]
    median_s = statistics.median(step_s)
    flops = 3.0 * B * flops_mmdit_forward(64, int(cfg["model"]["core"]["d_model"]), n_layers,
                                          float(cfg["model"]["core"]["mlp_ratio"]))
    calib = calib_tflops()
    # the host's share of a step: one batch of iter_image_batches alone
    batches = train_pixel.iter_image_batches(images, int(cfg["image"]["size"]), B)
    next(batches)
    t0 = time.perf_counter()
    for _ in range(8):
        next(batches)
    decode_s = (time.perf_counter() - t0) / 8

    # one full-width gradient with the kernels and with dense attention, on
    # the checkpoint's weights, the first batch and fixed draws
    model = build_pixel(cfg, "cuda")
    c = model.cfg
    batch = torch.from_numpy(next(train_pixel.iter_image_batches(images, c.image_size, B)))
    draws = draw_pixel_randomness(torch.Generator(device="cuda").manual_seed(7), c, B)
    abar = torch.as_tensor(pixel_schedule(c)[1], device="cuda")
    named = list(model.named_parameters())
    grads = {}
    for use_kernel in (True, False):
        loss = pixel_loss(model, batch.cuda(), draws, abar, use_kernel)
        gs = torch.autograd.grad(loss, [p for _, p in named])
        grads[use_kernel] = {k: g for (k, _), g in zip(named, gs)}
    qkv = [k for k in grads[False] if k.endswith("attn.qkv.weight")]
    qkv_rel = max(float((grads[True][k] - grads[False][k]).abs().max())
                  / float(grads[False][k].abs().max()) for k in qkv)
    norms = {k: float(global_norm(list(g.values()))) for k, g in grads.items()}
    norm_rel = abs(norms[True] - norms[False]) / norms[False]
    if len(qkv) != n_layers or max(qkv_rel, norm_rel) > GRAD_REL_TOL:
        raise AssertionError(f"pixel grads with the kernels vs dense: qkv {qkv_rel}, norm "
                             f"{norm_rel} (tol {GRAD_REL_TOL}, {len(qkv)} qkv grads)")
    del model, grads
    torch.cuda.empty_cache()
    emit({"phase": "pixel32_train", "config": "configs/pixel32.yaml", "batch": B,
          "images": PIXEL_IMAGES, "decode": decode, "compute_dtype": "bfloat16",
          "core": {"d_model": c.core.d_model, "n_layers": n_layers, "n_heads": c.core.n_heads,
                   "tokens": c.n_tokens},
          "warmup_steps": PIXEL_WARMUP, "cli_s": cli_s, "step_s": step_s,
          "median_step_s": median_s, "train_images_per_s": B / median_s,
          "decode_s_per_batch": decode_s,
          "losses": [m["loss"] for m in logs], "launches": launches,
          "launches_per_step": n_layers,
          "denoiser_mfu": mfu(flops / median_s), "calib_tflops": calib,
          "denoiser_mfu_vs_calib": flops / median_s / 1e12 / calib,
          "grad_check": {"qkv_weight_rel_err": qkv_rel, "grad_norm_rel_err": norm_rel,
                         "grad_norm_kernel": norms[True], "grad_norm_dense": norms[False],
                         "rel_tol": GRAD_REL_TOL},
          "peak_mem_gb": peak_gb})
    return launches


def pixel_sample_phase(fa, work_dir):
    """infer/sample_pixel.main restoring pixel32_train's checkpoint: 16
    images by the 1000-step ancestral sampler; then two calls of the same
    seed (the same bits), one profiled (the idle share), and one PixelDiT
    forward with and without the kernel."""
    import numpy as np
    import torch
    from PIL import Image

    from multimodal_diffusion_torch.infer import sample_pixel

    cfg, args = pixel_config(work_dir)
    n_layers = int(cfg["model"]["core"]["n_layers"])
    T = int(cfg["diffusion"]["image"]["steps"])
    want = {"flash_fwd": T * n_layers, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    reset_launch_counts(fa)
    t0 = time.perf_counter()
    pngs = sample_pixel.main(["--config", *args, "--num", str(PIXEL_SAMPLES),
                              "--out-dir", str(work_dir / "png"), "--seed", "1"])
    cli_s = time.perf_counter() - t0
    if launch_counts(fa) != want:
        raise AssertionError(f"pixel sampler CLI launches {launch_counts(fa)}, expected {want}")
    shape = (PIXEL_SAMPLES, cfg["image"]["size"], cfg["image"]["size"], 3)
    pixels = []
    for p in pngs:
        with Image.open(p) as im:
            pixels.append(np.asarray(im))
    if len(pixels) != PIXEL_SAMPLES or np.stack(pixels).shape != shape:
        raise AssertionError(f"the sampling CLI wrote {len(pixels)} images")
    launches = {"flash_fwd": want["flash_fwd"]}

    # the same seed twice: the first call timed, the second under the
    # profiler (device activity only: a call makes ~5 x 10^5 launches) for
    # the device's busy time and idle share
    from torch.profiler import ProfilerActivity, profile

    model = sample_pixel.build_pixel(cfg, "cuda")
    calls = []
    for profiled in (False, True):
        reset_launch_counts(fa)
        with profile(activities=[ProfilerActivity.CUDA]) if profiled else \
                contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            calls.append(sample_pixel.sample_pixel_images(model, PIXEL_SAMPLES, seed=1))
            call_s = time.perf_counter() - t0
        if launch_counts(fa) != want:
            raise AssertionError(f"pixel sampler launches {launch_counts(fa)}, expected {want}")
        launches["flash_fwd"] += want["flash_fwd"]
        if profiled:
            profiled_s = call_s
        else:
            per_call = call_s
    # the raw device records (key_averages() would build ~5 x 10^5
    # FunctionEvents first: a minute on the card's host)
    t0 = time.perf_counter()
    events = [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation()]
    profile_read_s = time.perf_counter() - t0
    busy_s = sum(ns for _, ns in events) / 1e9
    flash_s = sum(ns for name, ns in events if "flash_" in name) / 1e9
    imgs = calls[0][0]
    if imgs.shape != (PIXEL_SAMPLES,) + model.cfg.image_shape or not np.all(np.isfinite(imgs)) \
            or imgs.min() < -1.0 or imgs.max() > 1.0:
        raise AssertionError(f"pixel samples {imgs.shape}, range [{imgs.min()}, {imgs.max()}]")
    repeat_equal = bool(np.array_equal(calls[0][0], calls[1][0]))
    if not repeat_equal:
        raise AssertionError("two sampler calls of the same seed differ")
    if not np.array_equal(calls[0][1], np.stack(pixels)):
        raise AssertionError("the CLI's PNGs are not the sampler's images of the same seed")

    # one forward of the sampler's batch with and without the kernel
    reset_launch_counts(fa)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((PIXEL_SAMPLES,) + model.cfg.image_shape, generator=g, device="cuda")
    t = torch.randint(0, T, (PIXEL_SAMPLES,), generator=g, device="cuda")
    with torch.inference_mode():
        a, b = (model(x, t, use_kernel=k) for k in (True, False))
    launches["flash_fwd"] += launch_counts(fa)["flash_fwd"]
    rel = float((a.float() - b.float()).abs().max() / b.float().abs().max())
    if not rel <= PIXEL_DENOISE_REL_TOL:
        raise AssertionError(f"PixelDiT kernel vs dense: {rel} > {PIXEL_DENOISE_REL_TOL}")
    emit({"phase": "pixel32_sample", "config": "configs/pixel32.yaml", "num": PIXEL_SAMPLES,
          "steps": T, "compute_dtype": "bfloat16", "cli_s": cli_s, "s_per_call": per_call,
          "images_per_s": PIXEL_SAMPLES / per_call,
          "step_ms": per_call / T * 1e3, "flash_fwd_per_call": want["flash_fwd"],
          "repeat_bit_identical": repeat_equal, "cli_pngs_equal_sampler": True,
          "sample_range": [float(imgs.min()), float(imgs.max())],
          "profiled_call_s": profiled_s, "profile_read_s": profile_read_s,
          "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / profiled_s,
          "device_idle_share_unprofiled": 1.0 - busy_s / per_call,
          "device_records": len(events), "flash_fwd_device_s": flash_s,
          "forward_kernel_vs_dense_rel_err": rel, "rel_tol": PIXEL_DENOISE_REL_TOL})
    del model
    torch.cuda.empty_cache()
    return launches


def pixel_phases(fa):
    """pixel32_train then pixel32_sample, in a scratch directory under runs/
    (deleted at the end)."""
    import shutil
    import tempfile

    import torch

    (REPO / "runs").mkdir(exist_ok=True)
    work_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_pixel_", dir=REPO / "runs"))
    try:
        by_path = {"pixel32_train": pixel_train_phase(fa, work_dir)}
        torch.cuda.empty_cache()
        by_path["pixel32_sample"] = pixel_sample_phase(fa, work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return by_path


def spec8_remat_phase(fa, smi):
    """The flagship train step (spec8_train's setup: B=8, bf16 moments, core
    dropout 0.1) with parallel.remat_core off, then on, from the same seed
    and batch: the same loss each step, 2 x 16 forward launches a step under
    remat, a lower peak; then, on the remat trainer's model, one step's
    grads with the recompute and without it from the same draws and
    generator state. Prints calib_tflops() on a line of its own."""
    import numpy as np
    import torch

    from multimodal_diffusion_torch.ops.tokenize import num_chunks
    from multimodal_diffusion_torch.tools.profile_train import train_workload
    from multimodal_diffusion_torch.train import trainer as TT
    from multimodal_diffusion_torch.utils.profiling import calib_tflops, flops_mmdit_forward, mfu

    calib = calib_tflops()
    emit({"phase": "calib", "calib_tflops": calib, "nvidia_smi": smi})
    runs = {}
    for remat in (False, True):
        cfg, bundle, batch, run = train_workload(TRAIN_CLIPS, config="specificity8",
                                                 remat=remat)
        n_layers = cfg["model"]["core"]["n_layers"]
        if bundle.model.core.cfg.remat is not remat or bundle.model.core.cfg.dropout != 0.1:
            raise AssertionError(f"not the flagship core with remat {remat}")
        run(TRAIN_WARMUP)
        torch.cuda.reset_peak_memory_stats()
        logs = []
        reset_launch_counts(fa)
        run(REMAT_STEPS, log_fn=lambda step, m: logs.append(m))
        launches = launch_counts(fa)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {"flash_fwd": (2 if remat else 1) * n_layers, "flash_bwd_dkdv": n_layers,
                "flash_bwd_dq": n_layers}
        if launches != {k: REMAT_STEPS * n for k, n in want.items()}:
            raise AssertionError(f"remat {remat}: launches {launches} in {REMAT_STEPS} steps, "
                                 f"expected {want} a step")
        if len(logs) != REMAT_STEPS or any(m["loss_recon"] != 0.0 for m in logs):
            raise AssertionError(f"remat {remat}: {len(logs)} logged steps, or a decode step")
        runs[remat] = {"logs": logs, "peak_gb": peak_gb, "launches": launches, "want": want}
        if not remat:
            del bundle, run
            torch.cuda.empty_cache()

    # one step's grads on the remat trainer's model, with the recompute and
    # without it: the same draws, the generator set to the same state
    model, sc, shapes = bundle.model.train(), bundle.step_config, bundle.latent_shapes
    gen = bundle.state.generator
    draws = TT.draw_step_randomness(gen, sc)
    state = gen.get_state()
    dev_batch = TT.batch_to_device(batch, bundle.device)
    # The peak of this forward + backward is what the recompute lowers (the
    # step's own peak is the optimizer's update, after the activations are
    # freed); each pass's grads go to the host before the next pass starts
    named = list(model.named_parameters())
    grads, grad_peak_gb = {}, {}
    for remat in (True, False):
        model.core.cfg = dataclasses.replace(model.core.cfg, remat=remat)
        gen.set_state(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = TT.train_loss(model, sc, bundle.abar_v, bundle.abar_a, dev_batch, 0.0,
                                draws, False)
        gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        torch.cuda.synchronize()
        grad_peak_gb[remat] = torch.cuda.max_memory_allocated() / 1e9
        grads[remat] = ({k: g.cpu() for (k, _), g in zip(named, gs) if g is not None},
                        float(loss.detach()), gen.get_state())
        del loss, gs
    model.core.cfg = dataclasses.replace(model.core.cfg, remat=True)
    top = max(float(g.abs().max()) for g in grads[False][0].values())
    grad_rel = max(float((grads[True][0][k] - g).abs().max()) for k, g in
                   grads[False][0].items()) / top
    grads_bit_equal = all(torch.equal(grads[True][0][k], g) for k, g in grads[False][0].items())
    generator_equal = bool(torch.equal(grads[True][2], grads[False][2]))
    del grads, bundle, run, model, dev_batch
    torch.cuda.empty_cache()

    losses = {r: [m["loss"] for m in runs[r]["logs"]] for r in runs}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses[True], losses[False]))
    if not (loss_rel <= REMAT_REL_TOL and grad_rel <= REMAT_REL_TOL and generator_equal):
        raise AssertionError(f"remat vs not: losses {losses}, grads {grad_rel}, generator "
                             f"equal {generator_equal} (tol {REMAT_REL_TOL})")
    if not grad_peak_gb[True] < grad_peak_gb[False]:
        raise AssertionError(f"the forward + backward's peak under remat, {grad_peak_gb[True]} "
                             f"GB, is not below {grad_peak_gb[False]} GB without it")
    # the logged MFU is the JAX loop's: 3 B flops_mmdit_forward(nv + na), the
    # video and audio tokens (96 + 37 at the flagship) without the mouth's
    zv, za = shapes["z_video"], shapes["z_audio"]
    tube, chunk = cfg["tokenizer"]["video"]["tube"], cfg["tokenizer"]["audio"]["chunk"]
    nv = (zv[2] // tube["t"]) * (zv[3] // tube["h"]) * (zv[4] // tube["w"])
    na = num_chunks(za[2], chunk["length"], chunk["stride"])
    core = cfg["model"]["core"]
    flops = 3.0 * TRAIN_CLIPS * flops_mmdit_forward(nv + na, core["d_model"], n_layers,
                                                    core["mlp_ratio"])
    for r in runs:
        for m in runs[r]["logs"]:
            want_mfu = mfu(flops * m["steps_per_sec"])
            if not (abs(m["denoiser_mfu"] - want_mfu) <= 1e-9 * want_mfu
                    and np.isfinite(m.get("denoiser_mfu_vs_calib", np.nan))):
                raise AssertionError(f"logged MFU {m} against {want_mfu}")
    out = {"phase": "spec8_remat", "config": "mvp+specificity8", "clips": TRAIN_CLIPS,
           "core_dropout": 0.1, "tokens_in_mfu": nv + na, "warmup_steps": TRAIN_WARMUP,
           "steps": REMAT_STEPS,
           "losses_bit_equal": losses[True] == losses[False], "loss_rel_err": loss_rel,
           "grad_rel_err": grad_rel, "grads_bit_equal": grads_bit_equal,
           "generator_equal": generator_equal, "rel_tol": REMAT_REL_TOL,
           "fwd_bwd_peak_mem_gb": {"remat": grad_peak_gb[True], "no_remat": grad_peak_gb[False]},
           "calib_tflops": calib}
    for r in (False, True):
        logs = runs[r]["logs"]
        step_s = [1.0 / m["steps_per_sec"] for m in logs]
        out["remat" if r else "no_remat"] = {
            "step_s": step_s, "median_step_s": statistics.median(step_s),
            "train_clips_per_s": TRAIN_CLIPS / statistics.median(step_s),
            "losses": losses[r], "launches_per_step": runs[r]["want"],
            "denoiser_mfu": [m["denoiser_mfu"] for m in logs],
            "denoiser_mfu_vs_calib": [m["denoiser_mfu_vs_calib"] for m in logs],
            "step_peak_mem_gb": runs[r]["peak_gb"]}
    emit(out)
    return {k: runs[True]["launches"][k] + runs[False]["launches"][k]
            for k in runs[True]["launches"]}


# ---------------------------------------------------------------------------
# multi_rank: the layouts over ranks, two ranks sharing this one card
# ---------------------------------------------------------------------------

# two ranks on the one card, both on cuda:0, over gloo: NCCL takes one rank
# per device (see PERF.md for its error), and gloo moves the bytes of every
# transfer but a sum or a broadcast through host memory. Both ranks share the
# card's SMs, so the phase's times are no scaling figures.
MULTI_RANK_WORLD, MULTI_RANK_BACKEND = 2, "gloo"
MULTI_RANK_CLIPS, MULTI_RANK_SAMPLE_STEPS = 8, 2
# the flash ring alone: the flagship train step's attention, [8, 8, 422, 128]
# (421 tokens padded to 422 by lcm(seq_multiple, 2), the pad key masked),
# [8, 8, 211, 128] a rank
RING_SHAPE = (8, 8, 422, 128)
# (layout, the config overlay of the layout and of its one-process
# reference): context pads N to 422, so its reference pads too
# (seq_multiple 2: the same global dropout draws); pipelined training needs
# dropout 0, as the JAX package's; model 2 steps at the constant LR (3e-4,
# scheduler none) so that its parameters after the steps show its sharded
# AdamW (the warmup's LR is 0, then 3e-7)
MULTI_RANK_LAYOUTS = {
    "data2": ({"data": 2}, {}),
    "model2": ({"data": 1, "model": 2}, {"training": {"scheduler": {"name": "none"}}}),
    "context2": ({"data": 1, "context": 2, "context_flash": True},
                 {"model": {"core": {"seq_multiple": 2}}}),
    "pipe2": ({"data": 1, "pipe": 2, "pipe_microbatches": 2},
              {"model": {"core": {"dropout": 0.0}}}),
}
# the exact launches of one flagship step (16 layers, no remat, no decode)
# for each of the three kernels, per rank: data 2 and model 2 launch what
# one process does (each rank its rows or its heads, one call per layer);
# context 2 runs the ring's 2 steps per layer, forward and backward; pipe 2
# runs each rank's 16 / 2 = 8 blocks on each of 2 microbatches
MULTI_RANK_LAUNCHES = {"data2": 16, "model2": 16, "context2": 32, "pipe2": 16}
# the sampled wav over data 2 and under context 2 against one process, max
# |diff| / max |ref|: the flagship forward's 2e-2, on spec8_v2a's N(0, 0.02)
# weights. Under context 2 the core's arithmetic differs from one process's
# as dense attention's from the kernel's (other sums, the ring's merge), so
# its denoiser forward (spec8_denoise) is also held to SPEC8_DENOISE_REL_TOL.
# On the trainer's init weights the sampler's CFG amplified such a
# difference to 0.31 of the wav (see PERF.md): those weights are not the
# ones these tolerances were set on.
MULTI_RANK_SAMPLE_REL_TOL = 2e-2
# the names whose gradients the ranks hand back for the check (all qkv
# weights would be 200 MB a layout)
MULTI_RANK_GRADS = ("core.blocks.0.attn.qkv.weight", "core.blocks.15.attn.qkv.weight",
                    "core.blocks.7.mlp.fc1.weight", "adapt_v.proj.weight")
# model 2's parameters and EMA after two steps at LR 3e-4 (an Adam step moves
# a parameter by up to ~3e-4) against one process's AdamW (trainer.AdamW
# without a group) and EMA update on the layout's gathered gradients,
# clipped by the layout's norm (held to one process's separately), from the
# gathered start: the standing AdamW tolerance
MULTI_RANK_PARAM_ABS_TOL = 1e-6
# a rank's attention under model 2: its 4 of the flagship's 8 heads
TP_BLOCK_SHAPE = (8, 4, 421, 128)
# where model 2's ranks write their checkpoint for one process to restore
TP_CKPT_DIR = REPO / "runs" / "chip_smoke_tp_ckpt"
# the state (parameters, gradients, EMA, Adam moments) a rank holds, by
# bytes per element: fp32, and bf16 moments (specificity8's mv_dtype)
STATE_ITEMSIZE = {"params": 4, "grads": 4, "ema": 4, "mu": 2, "nu": 2}


def multi_rank_config(layout: dict, overlay: dict) -> dict:
    from multimodal_diffusion_torch.utils.io import deep_update, specificity8_config

    cfg = deep_update(specificity8_config(), overlay)
    cfg["parallel"] = {**cfg.get("parallel", {}), **layout}
    return cfg


def multi_rank_inputs():
    """The global batch, step draws and prompt frames every run of the
    phase shares (numpy, from seeds)."""
    import numpy as np

    from multimodal_diffusion_torch.utils.io import latent_shapes_from_config

    cfg = multi_rank_config({}, {})
    s = latent_shapes_from_config(cfg, MULTI_RANK_CLIPS)
    rng = np.random.default_rng(11)
    B = MULTI_RANK_CLIPS
    batch = {"video": rng.uniform(0, 1, s["video"]).astype(np.float32),
             "audio": rng.uniform(-1, 1, s["audio"]).astype(np.float32),
             "has_video": np.ones(B, bool), "has_audio": np.ones(B, bool)}
    draws = {"t_v": rng.integers(0, 1000, B), "t_a": rng.integers(0, 1000, B),
             "noise_v": rng.standard_normal(s["z_video"]).astype(np.float32),
             "noise_a": rng.standard_normal(s["z_audio"]).astype(np.float32),
             "cfg_u": rng.uniform(0, 1, B).astype(np.float32),
             "clean_u": rng.uniform(0, 1, B).astype(np.float32)}
    T, H, W = s["video"][2:]
    frames = rng.integers(0, 256, (B, T, H, W, 3), dtype=np.uint8)
    return batch, draws, frames


def tree_digest(tree, prefix: str = "") -> dict:
    """{path: sha256 of its bytes} of a checkpoint tree (tensors of any
    dtype, ints)."""
    import hashlib

    import torch

    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(tree_digest(v, path))
        elif isinstance(v, torch.Tensor):
            raw = v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
            out[path] = f"{v.dtype}{tuple(v.shape)}:" + hashlib.sha256(raw.tobytes()).hexdigest()
        else:
            out[path] = repr(v)
    return out


def multi_rank_step(fa, name: str, mesh=None, ckpt_dir=None) -> dict:
    """One flagship train step of layout `name` (or its one-process
    reference without `mesh`) on the card from the seeded init, the shared
    batch and draws, audio the target: its metrics, the gradients of
    MULTI_RANK_GRADS (gathered whole under model 2), the launches, ms of a
    later step, peak memory and the bytes of the state this rank holds.
    Without `mesh`, also the number of elements of the split parameters.
    Under model 2: a second step, then the parameters and EMA (gathered)
    against one process's AdamW on the two steps' gathered gradients
    (``adamw_max_abs_err``), both ranks' torch.cuda.memory_allocated() read
    between two barriers, and with `ckpt_dir` the gathered checkpoint tree,
    which rank 0 writes there, as digests."""
    import torch
    import torch.distributed as dist

    from multimodal_diffusion_torch.parallel.sharding import is_split, tp_gather
    from multimodal_diffusion_torch.train import checkpoint as TC
    from multimodal_diffusion_torch.train.trainer import create_trainer

    layout, overlay = MULTI_RANK_LAYOUTS[name]
    batch, draws, _ = multi_rank_inputs()
    cfg = multi_rank_config(layout if mesh is not None else {}, overlay)
    bundle = create_trainer(cfg, device="cuda", batch_size=MULTI_RANK_CLIPS, seed=0,
                            mesh=mesh)
    st = bundle.state
    group = None if mesh is None else mesh.group("model")
    check = group is not None  # model 2: its sharded AdamW against one process's
    taken, grad_bytes, seen = {}, [], []
    step = st.optimizer.step

    def whole(named):
        return {n: tp_gather(n, t.detach(), group).to("cpu", copy=True) for n, t in named}

    def keep(grads):
        if not grad_bytes:
            grad_bytes.append(sum(g.numel() * g.element_size() for g in grads
                                  if g is not None))
        taken.update({n: tp_gather(n, g, group).float().cpu().numpy()
                      for n, g in zip(st.optimizer.names, grads) if n in MULTI_RANK_GRADS})
        if check and len(seen) < 2:
            seen.append(whole((n, torch.zeros_like(p) if g is None else g)
                              for n, p, g in zip(st.optimizer.names, st.optimizer.params, grads)))
        return step(grads)

    st.optimizer.step = keep
    if check:
        start, start_ema = whole(bundle.model.named_parameters()), whole(st.ema.items())
    d = {k: torch.as_tensor(v).cuda() for k, v in draws.items()}
    torch.cuda.synchronize()
    reset_launch_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    metrics = bundle.train_step(st, batch, 0.0, d)
    torch.cuda.synchronize()
    launches = launch_counts(fa)
    grads = dict(taken)
    if check:
        norms = [metrics["grad_norm"], bundle.train_step(st, batch, 0.0, d)["grad_norm"]]
        after, after_ema = whole(bundle.model.named_parameters()), whole(st.ema.items())
    t0 = time.perf_counter()
    bundle.train_step(st, batch, 0.0, d)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    opt = st.optimizer

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
           "launches": launches, "step_ms": ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "state_bytes": {"params": nbytes(bundle.model.parameters()),
                           "grads": grad_bytes[0], "ema": nbytes(st.ema.values()),
                           "mu": nbytes(opt.mu), "nu": nbytes(opt.nu)}}
    if mesh is None:
        out["split_numel"] = sum(p.numel() for n, p in bundle.model.named_parameters()
                                 if is_split(n))
    if group is not None:
        dist.barrier()
        out["allocated_bytes"] = torch.cuda.memory_allocated()
        dist.barrier()
        if ckpt_dir is not None:
            tree = TC.state_to_tree(st)  # every rank of the group gathers
            if dist.get_rank() == 0:
                TC.CheckpointManager(ckpt_dir).save(tree["step"], tree)
                out["tree_digest"] = tree_digest(tree)
            del tree
            dist.barrier()
    hyper = dict(lr_schedule=opt.lr_schedule, b1=opt.b1, b2=opt.b2, eps=opt.eps,
                 weight_decay=opt.wd, clip_norm=opt.clip_norm, mv_dtype=opt.mv_dtype,
                 accum_steps=opt.accum_steps)
    del bundle, st, keep, opt
    gc.collect()
    torch.cuda.empty_cache()
    if check:
        out["adamw_max_abs_err"] = one_process_adamw_err(
            hyper, float(cfg["training"]["ema"]["decay"]), start, start_ema, seen, norms,
            after, after_ema)
        del start, start_ema, seen, after, after_ema
        gc.collect()
        torch.cuda.empty_cache()
    return out


def one_process_adamw_err(hyper: dict, decay: float, start: dict, start_ema: dict,
                          grads_by_step: list, norms: list, after: dict,
                          after_ema: dict) -> float:
    """The largest |difference| of a layout's parameters and EMA after its
    steps (`after`, `after_ema`, gathered whole) from one process's: the
    trainer's AdamW without a group, with `hyper`, and the trainer's EMA
    update, from the gathered start, on each step's gathered gradients,
    clipped by that step's norm of the layout (`norms`). On the card."""
    import torch

    from multimodal_diffusion_torch.train.trainer import AdamW

    params = {n: t.cuda() for n, t in start.items()}
    ema = {n: t.cuda() for n, t in start_ema.items()}
    ref = AdamW(list(params.items()), **hyper)
    for grads, norm in zip(grads_by_step, norms):
        ref.grad_norm = lambda _grads, norm=norm: norm
        ref.step([grads[n].cuda() for n in params])
        shadow = list(ema.values())
        torch._foreach_mul_(shadow, decay)
        torch._foreach_add_(shadow, [params[n] for n in ema], alpha=1.0 - decay)
    return max(float((got.cuda() - want).abs().max())
               for got_tree, want_tree in ((after, params), (after_ema, ema))
               for got, want in ((got_tree[n], want_tree[n]) for n in want_tree))


def restored_digest(ckpt_dir) -> dict:
    """The digests of the tree that one process (a model-2 layout's
    config without the layout) holds after restoring the latest checkpoint
    under `ckpt_dir`."""
    import torch

    from multimodal_diffusion_torch.train import checkpoint as TC
    from multimodal_diffusion_torch.train.trainer import create_trainer

    layout, overlay = MULTI_RANK_LAYOUTS["model2"]
    bundle = create_trainer(multi_rank_config({}, overlay), device="cuda",
                            batch_size=MULTI_RANK_CLIPS, seed=0)
    TC.restore_state(bundle.state, TC.CheckpointManager(ckpt_dir).restore())
    digest = tree_digest(TC.state_to_tree(bundle.state))
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    return digest


def n002_weights_(model, gen) -> None:
    """spec8_v2a's N(0, 0.02) weights, drawn from `gen` at the one-process
    shapes in parameter order: a tensor-parallel part keeps its part of the
    whole draw, so a layout gets one process's weights."""
    import torch

    from multimodal_diffusion_torch.models.mmdit import HotDense
    from multimodal_diffusion_torch.parallel.sharding import tp_part

    hot = {f"{m}.{leaf}": mod for m, mod in model.named_modules()
           if isinstance(mod, HotDense) and mod.split for leaf in ("weight", "bias")}
    with torch.no_grad():
        for n, p in model.named_parameters():
            mod = hot.get(n)
            if mod is None:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            else:
                whole = torch.randn(mod.whole_shape(n.rsplit(".", 1)[1]), generator=gen) * 0.02
                p.copy_(tp_part(n, whole, p.shape, mod.tp_n, mod.tp_i))


def multi_rank_sample(mesh_kw, frames):
    """A MULTI_RANK_SAMPLE_STEPS-step v2a flagship batch through
    build_components + sample_one_direction on the mesh of `mesh_kw` (one
    process without it), on spec8_v2a's seeded N(0, 0.02) weights: the wav
    [B, L], and spec8_denoise's outputs (numpy) on that model."""
    import torch

    from multimodal_diffusion_torch.infer.sample_clip import (build_components,
                                                              sample_one_direction)
    from multimodal_diffusion_torch.parallel.mesh import make_mesh

    cfg = multi_rank_config(mesh_kw or {}, {})
    cfg["paths"] = {}
    cfg["diffusion"]["audio"]["sampler_steps"] = MULTI_RANK_SAMPLE_STEPS
    mesh = make_mesh(**mesh_kw) if mesh_kw else None
    model = build_components(cfg, device="cuda", mesh=mesh if mesh_kw and
                             mesh_kw.get("context", 1) > 1 else None)
    n002_weights_(model, torch.Generator().manual_seed(0))
    out = sample_one_direction(cfg=cfg, model=model, prompt_modality="video",
                               prompt_video=frames, device="cuda", mesh=mesh,
                               generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        den = spec8_denoise(model)
    den = {k: den[k].float().cpu().numpy() for k in SPEC8_DENOISE_REL_TOL}
    del model
    torch.cuda.empty_cache()
    return out["audio"], den


def multi_rank_int8_sample(fa, mesh_kw, frames) -> dict:
    """A MULTI_RANK_SAMPLE_STEPS-step v2a flagship batch under
    model.core.quant int8 with bf16 serving weights (spec8_v2a's N(0, 0.02)
    weights, then cast) on the mesh of `mesh_kw` (one process without it):
    the wav, its seconds, the launches, and each hot projection's [N, K]
    that torch._int_mm multiplies (each must be servable)."""
    import torch

    from multimodal_diffusion_torch.infer.sample_clip import (build_components,
                                                              sample_one_direction)
    from multimodal_diffusion_torch.models.mmdit import HotDense
    from multimodal_diffusion_torch.ops.quant import int_mm_unservable
    from multimodal_diffusion_torch.parallel.mesh import make_mesh

    cfg = multi_rank_config(mesh_kw or {}, {"model": {"core": {"quant": "int8"}}})
    cfg["paths"] = {}
    cfg["diffusion"]["audio"]["sampler_steps"] = MULTI_RANK_SAMPLE_STEPS
    mesh = make_mesh(**mesh_kw) if mesh_kw else None
    model = build_components(cfg, device="cuda", mesh=mesh, bf16_params=True)
    n002_weights_(model, torch.Generator().manual_seed(0))
    shapes = sorted({tuple(m.weight.shape) for m in model.core.modules()
                     if isinstance(m, HotDense)})
    bad = [why for n_out, k_in in shapes if (why := int_mm_unservable(k_in, n_out))]
    if bad:
        raise AssertionError(f"int8 under {mesh_kw}: {bad}")
    reset_launch_counts(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sample_one_direction(cfg=cfg, model=model, prompt_modality="video",
                               prompt_video=frames, device="cuda", mesh=mesh,
                               generator=torch.Generator().manual_seed(5))
    torch.cuda.synchronize()
    res = {"wav": out["audio"], "s": time.perf_counter() - t0,
           "launches": launch_counts(fa), "weight_shapes": [list(x) for x in shapes]}
    del model
    torch.cuda.empty_cache()
    return res


def ring_inputs():
    import numpy as np

    rng = np.random.default_rng(13)
    q, k, v, dout = (rng.standard_normal(RING_SHAPE).astype(np.float32) for _ in range(4))
    valid = np.ones((RING_SHAPE[0], RING_SHAPE[2]), bool)
    valid[:, -1] = False  # the pad key of 421 -> 422
    return q, k, v, dout, valid


def multi_rank_body(rank: int, world: int) -> dict:
    """What each of the two ranks runs, in one spawned pair: the flash ring
    alone, one step of every layout, the two sampled batches. Returns its
    results (numpy, floats) to the parent."""
    import torch

    from multimodal_diffusion_torch.ops import flash_attention as fa
    from multimodal_diffusion_torch.ops.ring_attention import ring_attention_local
    from multimodal_diffusion_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"rank": rank}
    # the flash ring alone, this rank's [8, 8, 211, 128] shard
    mesh = make_mesh(data=1, context=world)
    group, members = mesh.group("context"), mesh.members("context")
    q, k, v, dout, valid = ring_inputs()
    n = RING_SHAPE[2] // world
    cut = slice(rank * n, (rank + 1) * n)

    def shard(a):
        return torch.as_tensor(a[:, :, cut]).to("cuda", torch.bfloat16).contiguous()

    ql, kl, vl, dl = (shard(a) for a in (q, k, v, dout))
    vd = torch.as_tensor(valid[:, cut]).cuda().contiguous()

    def ring_call():
        leaves = [t.detach().clone().requires_grad_() for t in (ql, kl, vl)]
        out = ring_attention_local(*leaves, group, members, vd, "flash")
        out.backward(dl)
        return [out.detach()] + [t.grad for t in leaves]

    first = ring_call()
    reset_launch_counts(fa)
    again = ring_call()
    res["ring_launches"] = launch_counts(fa)
    res["ring_bit_identical"] = all(torch.equal(a, b) for a, b in zip(first, again))
    res["ring"] = [t.float().cpu().numpy() for t in first]
    times = {"fwd": [], "fwd_bwd": []}
    for _ in range(5):
        for what in times:
            torch.distributed.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if what == "fwd":
                with torch.no_grad():
                    ring_attention_local(ql, kl, vl, group, members, vd, "flash")
            else:
                ring_call()
            torch.cuda.synchronize()
            times[what].append((time.perf_counter() - t0) * 1e3)
    res["ring_ms"] = {k: statistics.median(v) for k, v in times.items()}
    # one train step of each layout
    from multimodal_diffusion_torch.parallel.mesh import make_mesh_from_config

    res["steps"] = {}
    for name, (layout, overlay) in MULTI_RANK_LAYOUTS.items():
        mesh = make_mesh_from_config({"parallel": layout})
        res["steps"][name] = multi_rank_step(fa, name, mesh,
                                             TP_CKPT_DIR if name == "model2" else None)
    _, _, frames = multi_rank_inputs()
    res["sample_data2"] = multi_rank_sample({"data": 2}, frames)
    res["sample_context2"] = multi_rank_sample({"data": 1, "context": 2}, frames)
    res["int8_model2"] = multi_rank_int8_sample(fa, {"data": 1, "model": 2}, frames)
    return res


def rel_err(got, ref) -> float:
    import numpy as np

    return float(np.abs(np.asarray(got, np.float32) - ref).max() / np.abs(ref).max())


def multi_rank_phase(fa, cycles_per_s, smi):
    """Two ranks on this card (gloo): the flash ring against flash_attention
    on the whole sequence, one flagship train step of each layout against
    the one-process step, the sampled batches against one process; then the
    dry run at n = 4. Returns ({path: launches}, the ring's kernel cases)."""
    import numpy as np
    import torch

    from multimodal_diffusion_torch.parallel.launch import run_ranks
    from multimodal_diffusion_torch.tools.dryrun_multichip import dryrun_multichip

    import shutil

    for name in fa.SOURCES:  # built once here, before the ranks load them
        fa._library(name)
    shutil.rmtree(TP_CKPT_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    ranks = run_ranks(multi_rank_body, MULTI_RANK_WORLD, backend=MULTI_RANK_BACKEND,
                      timeout=600, threads=4)
    spawn_s = time.perf_counter() - t_phase

    # the ring against flash_attention on the whole sequence, this card
    q, k, v, dout, valid = ring_inputs()
    dev = [torch.as_tensor(a).to("cuda", torch.bfloat16).requires_grad_()
           for a in (q, k, v)]
    vd = torch.as_tensor(valid).cuda()
    out = fa.flash_attention(*dev, ~vd)
    out.backward(torch.as_tensor(dout).to("cuda", torch.bfloat16))
    whole = [out.detach()] + [t.grad for t in dev]
    whole = [t.float().cpu().numpy() for t in whole]
    n = RING_SHAPE[2] // MULTI_RANK_WORLD
    ring_err = {"out": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    for r in ranks:
        cut = slice(r["rank"] * n, (r["rank"] + 1) * n)
        for key, got, ref in zip(ring_err, r["ring"], whole):
            ring_err[key] = max(ring_err[key], rel_err(got, ref[:, :, cut]))
        if not r["ring_bit_identical"]:
            raise AssertionError(f"rank {r['rank']}: two ring calls differ")
        if r["ring_launches"] != {"flash_fwd": 2, "flash_bwd_dkdv": 2, "flash_bwd_dq": 2}:
            raise AssertionError(f"ring launches {r['ring_launches']}, expected 2 each")
    if ring_err["out"] > SPEC8_DENOISE_REL_TOL["eps_v"] or \
            max(ring_err[k] for k in ("dq", "dk", "dv")) > GRAD_REL_TOL:
        raise AssertionError(f"the flash ring vs the whole sequence: {ring_err}")
    leaves = [t.detach().clone().requires_grad_() for t in dev]

    def whole_call():
        o = fa.flash_attention(*leaves, ~vd)
        o.backward(torch.as_tensor(dout).to("cuda", torch.bfloat16))

    whole_ms = {"fwd": cuda_median_ms(lambda: fa.flash_attention(*[t.detach() for t in dev],
                                                                 ~vd), cycles_per_s),
                "fwd_bwd": cuda_median_ms(whole_call, cycles_per_s, reps=10)}
    # the kernels at a rank's shape, as the ring calls them on each block:
    # rank 0's queries against rank 1's keys (the pad key masked)
    B, H, N, Dh = RING_SHAPE
    shard = [dev[0].detach()[:, :, :n].contiguous()] + [
        t.detach()[:, :, n:].contiguous() for t in dev[1:]]
    vshard = vd[:, n:].contiguous()
    n_valid = [int(x) for x in vshard.sum(dim=1)]
    reset_launch_counts(fa)
    o, lse, fwd_rec = forward_case(fa, "ring_block", *shard, vshard, n_valid, cycles_per_s)
    dl = torch.as_tensor(dout[:, :, :n]).to("cuda", torch.bfloat16).contiguous()
    bwd_recs = backward_case(fa, "ring_block", *shard, vshard, o, lse, dl, n_valid,
                             cycles_per_s)

    # each layout's step against its one-process reference (data 2 and
    # model 2 share one: the same config)
    layouts, refs = {}, {}
    for name in MULTI_RANK_LAYOUTS:
        key = repr(MULTI_RANK_LAYOUTS[name][1])
        if key not in refs:
            refs[key] = multi_rank_step(fa, name)
        ref = refs[key]
        want = MULTI_RANK_LAUNCHES[name]
        errs = []
        for r in ranks:
            got = r["steps"][name]
            if any(c != want for c in got["launches"].values()):
                raise AssertionError(f"{name} rank {r['rank']}: launches {got['launches']}, "
                                     f"expected {want} each")
            loss_rel = abs(got["metrics"]["loss"] - ref["metrics"]["loss"]) / \
                abs(ref["metrics"]["loss"])
            norm_rel = abs(got["metrics"]["grad_norm"] - ref["metrics"]["grad_norm"]) / \
                ref["metrics"]["grad_norm"]
            grad_rel = max(rel_err(got["grads"][g], ref["grads"][g]) for g in MULTI_RANK_GRADS)
            errs.append({"loss_rel_err": loss_rel, "grad_norm_rel_err": norm_rel,
                         "grad_rel_err": grad_rel})
            if not np.isfinite(got["metrics"]["loss"]) or \
                    max(loss_rel, norm_rel, grad_rel) > SPEC8_GRAD_REL_TOL:
                raise AssertionError(f"{name} rank {r['rank']} vs one process: "
                                     f"{errs[-1]} (tol {SPEC8_GRAD_REL_TOL})")
        layouts[name] = {
            "layout": MULTI_RANK_LAYOUTS[name][0], "backend": MULTI_RANK_BACKEND,
            "loss": ranks[0]["steps"][name]["metrics"]["loss"],
            "one_process_loss": ref["metrics"]["loss"],
            "step_ms": [r["steps"][name]["step_ms"] for r in ranks],
            "one_process_step_ms": ref["step_ms"],
            "peak_gb": [r["steps"][name]["peak_gb"] for r in ranks],
            "one_process_peak_gb": ref["peak_gb"],
            "launches": [r["steps"][name]["launches"] for r in ranks],
            "launches_expected": want, "one_process_launches": ref["launches"],
            "errors": errs}

    # model 2: each rank holds its parts (the exact bytes), the parameters
    # after the steps, both ranks' allocations at once, the checkpoint in one
    # process, the kernels at a rank's heads
    ref = refs[repr(MULTI_RANK_LAYOUTS["model2"][1])]
    want_bytes = {k: v - STATE_ITEMSIZE[k] * ref["split_numel"] // 2
                  for k, v in ref["state_bytes"].items()}
    tp = {"state_bytes": [r["steps"]["model2"]["state_bytes"] for r in ranks],
          "state_bytes_expected": want_bytes, "one_process_state_bytes": ref["state_bytes"],
          "split_numel": ref["split_numel"]}
    for r in ranks:
        got = r["steps"]["model2"]
        if got["state_bytes"] != want_bytes:
            raise AssertionError(f"model2 rank {r['rank']} holds {got['state_bytes']} bytes, "
                                 f"expected {want_bytes}")
        err = got["adamw_max_abs_err"]
        tp.setdefault("params_after_max_abs_err", []).append(err)
        if not err <= MULTI_RANK_PARAM_ABS_TOL:
            raise AssertionError(f"model2 rank {r['rank']}: parameters and EMA after two steps "
                                 f"{err} from one process's AdamW on its gradients "
                                 f"(tol {MULTI_RANK_PARAM_ABS_TOL})")
    tp["allocated_bytes_at_once"] = [r["steps"]["model2"]["allocated_bytes"] for r in ranks]
    if not all(b > 0 for b in tp["allocated_bytes_at_once"]):
        raise AssertionError(f"two ranks on one card: {tp['allocated_bytes_at_once']}")
    emit({"phase": "multi_rank_shared_card", "device": smi,
          "memory_allocated_bytes_by_rank_at_once": tp["allocated_bytes_at_once"],
          "note": "two processes hold memory on the one card at the same moment"})
    one_digest = restored_digest(TP_CKPT_DIR)
    shutil.rmtree(TP_CKPT_DIR, ignore_errors=True)
    written = ranks[0]["steps"]["model2"]["tree_digest"]
    if one_digest != written:
        bad = sorted(k for k in set(written) | set(one_digest)
                     if written.get(k) != one_digest.get(k))
        raise AssertionError(f"model2's checkpoint restored in one process differs: {bad[:5]}")
    tp["checkpoint_to_one_process_bit_equal"] = True
    tp["checkpoint_tensors"] = len(written)
    g = torch.Generator(device="cuda").manual_seed(21)
    tq, tk, tv = (torch.randn(TP_BLOCK_SHAPE, generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(3))
    n_all = [TP_BLOCK_SHAPE[2]] * TP_BLOCK_SHAPE[0]
    to, tlse, tp_fwd = forward_case(fa, "model2_block", tq, tk, tv, None, n_all, cycles_per_s)
    tdout = torch.randn(TP_BLOCK_SHAPE, generator=g, device="cuda").to(torch.bfloat16)
    tp_bwd = backward_case(fa, "model2_block", tq, tk, tv, None, to, tlse, tdout, n_all,
                           cycles_per_s)

    # the sampled batches against one process
    _, _, frames = multi_rank_inputs()
    one, one_den = multi_rank_sample(None, frames)
    sample_err = {}
    for key in ("sample_data2", "sample_context2"):
        sample_err[key] = max(rel_err(r[key][0], one) for r in ranks)
        if not all(np.isfinite(r[key][0]).all() and r[key][0].shape == one.shape
                   and np.abs(r[key][0]).max() <= 1.0 for r in ranks):
            raise AssertionError(f"{key}: a non-finite, out-of-range or misshapen batch")
    if max(sample_err.values()) > MULTI_RANK_SAMPLE_REL_TOL:
        raise AssertionError(f"the sampled batches vs one process: {sample_err} "
                             f"(tol {MULTI_RANK_SAMPLE_REL_TOL})")
    denoise_err = {k: max(rel_err(r["sample_context2"][1][k], one_den[k]) for r in ranks)
                   for k in SPEC8_DENOISE_REL_TOL}
    if any(denoise_err[k] > SPEC8_DENOISE_REL_TOL[k] for k in denoise_err):
        raise AssertionError(f"the denoiser forward under context 2 vs one process: "
                             f"{denoise_err} (tol {SPEC8_DENOISE_REL_TOL})")
    # int8 under model 2: one process's int8 batch, bit for bit
    one8 = multi_rank_int8_sample(fa, None, frames)
    want8 = {"flash_fwd": MULTI_RANK_SAMPLE_STEPS * 16, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    for r in [{"rank": "one process", "int8_model2": one8}] + ranks:
        got = r["int8_model2"]
        if got["launches"] != want8:
            raise AssertionError(f"int8 batch ({r['rank']}): launches {got['launches']}, "
                                 f"expected {want8}")
        if not (np.isfinite(got["wav"]).all() and np.array_equal(got["wav"], one8["wav"])):
            raise AssertionError(f"int8 under model 2 (rank {r['rank']}) is not one process's "
                                 f"int8 batch: max diff "
                                 f"{float(np.abs(got['wav'] - one8['wav']).max())}")
    tp["int8_sample"] = {"bit_equal_to_one_process": True,
                         "s": [r["int8_model2"]["s"] for r in ranks], "one_process_s": one8["s"],
                         "weight_shapes_per_rank": ranks[0]["int8_model2"]["weight_shapes"],
                         "one_process_weight_shapes": one8["weight_shapes"],
                         "launches_per_rank": ranks[0]["int8_model2"]["launches"]}

    # the dry run, 4 ranks on this card
    t0 = time.perf_counter()
    dry = dryrun_multichip(4, device="cuda", backend=MULTI_RANK_BACKEND, timeout=600)
    dry_s = time.perf_counter() - t0
    emit({"phase": "multi_rank", "world": MULTI_RANK_WORLD, "backend": MULTI_RANK_BACKEND,
          "device": smi, "note": "two ranks share one card's SMs and gloo moves bytes through "
          "the host: these times are no scaling figures; NCCL across cards runs in "
          "tests/test_torch_nccl_gpu.py",
          "ring": {"shape_per_rank": [B, H, n, Dh], "whole_shape": list(RING_SHAPE),
                   "rel_err": ring_err, "bit_identical": True,
                   "ring_ms": [r["ring_ms"] for r in ranks], "whole_ms": whole_ms,
                   "launches_per_rank": ranks[0]["ring_launches"]},
          "layouts": layouts, "model2": tp, "sample_rel_err": sample_err,
          "sample_tol": MULTI_RANK_SAMPLE_REL_TOL, "context_denoise_rel_err": denoise_err,
          "context_denoise_tol": SPEC8_DENOISE_REL_TOL, "dryrun": dry, "dryrun_s": dry_s,
          "spawned_pair_s": spawn_s, "phase_s": time.perf_counter() - t_phase})
    paths = {f"multi_rank_{name}": ranks[0]["steps"][name]["launches"]
             for name in MULTI_RANK_LAYOUTS}
    paths["multi_rank_ring"] = ranks[0]["ring_launches"]
    paths["multi_rank_int8_model2"] = ranks[0]["int8_model2"]["launches"]
    return paths, {"ring_block": {"fwd": fwd_rec, **bwd_recs},
                   "model2_block": {"fwd": tp_fwd, **tp_bwd}}


def mpeg_audio_phase() -> None:
    """media/mpeg_audio.py on this machine: whether the bundled libavcodec is
    there and of a known major; where it is, a .mpg of a 0.5 s tone written
    by tools/make_mpg.py (the bundled mp2 encoder) and read back: 32 kHz,
    finite, the tone within 0.99 correlation."""
    import shutil
    import tempfile

    import numpy as np

    from multimodal_diffusion_torch.media import mpeg_audio
    from multimodal_diffusion_torch.tools import make_mpg

    rec = {"phase": "mpeg_audio", "available": mpeg_audio.available()}
    try:
        rec["avcodec_major"] = mpeg_audio.avcodec_major()
    except RuntimeError as err:
        rec["unavailable_because"] = str(err)
    if rec["available"]:
        (REPO / "runs").mkdir(exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix="chip_smoke_mpg_", dir=REPO / "runs"))
        try:
            pcm = make_mpg.tone(0.5)
            make_mpg.write_mpg(work / "tone.mpg", make_mpg.encode_mp2(pcm))
            t0 = time.perf_counter()
            wav, sr = mpeg_audio.read_mpeg_audio(work / "tone.mpg")
            rec["read_s"] = time.perf_counter() - t0
        finally:
            shutil.rmtree(work, ignore_errors=True)
        ref = pcm.astype(np.float32) / 32768.0
        n = min(len(wav), len(ref))
        corr = max(float(np.corrcoef(wav[d:n], ref[:n - d])[0, 1]) for d in range(1200))
        rec.update(samples=len(wav), sr=sr, tone_correlation=corr)
        if not (sr == make_mpg.SR and np.isfinite(wav).all() and corr > 0.99):
            raise AssertionError(f"mpeg_audio read back {rec}")
    emit(rec)


# the flagship clip (48 frames of 128x128, latents 12x16x16) decoded to a
# smaller size on every axis; the card's decode against the same decode on
# the CPU (fp32, TF32 off): max |diff| / max |ref|, the 3-D convolutions'
# tolerance; the resize alone on the card against the CPU
DECODE_SHRINK_CLIPS, DECODE_SHRINK_SIZE = 2, (40, 112, 120)
DECODE_SHRINK_REL_TOL, RESIZE_REL_TOL = 1e-4, 1e-5


def decode_shrink_phase(cycles_per_s, smi) -> None:
    """The patch VideoVAE at the flagship's width (configs/specificity8.yaml's
    video block, seeded init, fp32) decoding latents to DECODE_SHRINK_SIZE,
    smaller than its natural 48x128x128: the antialiased resize of
    ops/resize.py (jax.image.resize's), on the card against the CPU, and its
    ms beside the natural-size decode's."""
    import copy

    import torch

    from multimodal_diffusion_torch.models.diffusion import init_weights
    from multimodal_diffusion_torch.models.vae_video3d import VideoVAE, VideoVAEConfig
    from multimodal_diffusion_torch.ops.resize import resize_antialiased
    from multimodal_diffusion_torch.utils.io import specificity8_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = specificity8_config()
    vae = VideoVAE(VideoVAEConfig.from_dict(cfg["video"])).eval()
    init_weights(vae, torch.Generator().manual_seed(0))
    cpu_vae = copy.deepcopy(vae)
    vae = vae.cuda()
    c = vae.cfg
    T, H, W = 48, *cfg["video"]["size"]
    z = torch.randn((DECODE_SHRINK_CLIPS, c.lat_ch, T // c.t_down, H // c.s_down,
                     W // c.s_down), generator=torch.Generator().manual_seed(1))
    zc = z.cuda()
    with torch.no_grad():
        got = vae.decode(zc, DECODE_SHRINK_SIZE).cpu()
        want = cpu_vae.decode(z, DECODE_SHRINK_SIZE)
        natural = vae.decode(zc)
        shrunk = resize_antialiased(natural, DECODE_SHRINK_SIZE, (2, 3, 4)).cpu()
        shrunk_cpu = resize_antialiased(natural.cpu(), DECODE_SHRINK_SIZE, (2, 3, 4))
        decode_err = float((got - want).abs().max() / want.abs().max())
        resize_err = float((shrunk - shrunk_cpu).abs().max() / shrunk_cpu.abs().max())
        ms = cuda_median_ms(lambda: vae.decode(zc, DECODE_SHRINK_SIZE), cycles_per_s, reps=10)
        natural_ms = cuda_median_ms(lambda: vae.decode(zc), cycles_per_s, reps=10)
        resize_ms = cuda_median_ms(
            lambda: resize_antialiased(natural, DECODE_SHRINK_SIZE, (2, 3, 4)), cycles_per_s,
            reps=10)
    rec = {"phase": "decode_shrink", "device": smi, "arch": c.arch, "clips": DECODE_SHRINK_CLIPS,
           "latent": list(z.shape), "natural": [T, H, W], "out_size": list(DECODE_SHRINK_SIZE),
           "shape": list(got.shape), "decode_rel_err_vs_cpu": decode_err,
           "resize_rel_err_vs_cpu": resize_err, "decode_ms": ms, "natural_decode_ms": natural_ms,
           "resize_ms": resize_ms, "tol": [DECODE_SHRINK_REL_TOL, RESIZE_REL_TOL]}
    emit(rec)
    if got.shape != (DECODE_SHRINK_CLIPS, 3) + DECODE_SHRINK_SIZE or \
            not torch.isfinite(got).all() or decode_err > DECODE_SHRINK_REL_TOL or \
            resize_err > RESIZE_REL_TOL:
        raise AssertionError(f"decode_shrink: {rec}")


# tools/bench.py (bench.py's counterpart): each run's arguments, the flash
# forward launches of one pipeline call (av, t2i) or the launches of each
# kernel in one train step, and the JSON keys bench.py prints for its task
CONFIGS = REPO / "configs"
FLAGSHIP_ARGS = ["--config", str(CONFIGS / "mvp.yaml"), str(CONFIGS / "specificity8.yaml")]
SHORT_ARGS = ["--repeats", "3", "--inner", "1"]
BENCH_RUNS = [
    ("v2a_mvp", [], 400),
    ("a2v_mvp", ["--direction", "a2v", *SHORT_ARGS], 400),
    ("v2a_flagship", [*FLAGSHIP_ARGS, *SHORT_ARGS], 800),
    ("t2i", ["--task", "t2i", *SHORT_ARGS], 50 * 8 + 2 * 4),
    ("t2i_serving", ["--task", "t2i", "--serving", *SHORT_ARGS], 12 * 8 + 2 * 4),
    ("train_mvp", ["--task", "train", "--repeats", "5"], 8),
    ("train_flagship", ["--task", "train", *FLAGSHIP_ARGS, "--repeats", "5"], 16),
]
BENCH_KEYS = {
    "av": ["metric", "value", "unit", "vs_baseline", "best_batch_latency_s",
           "p50_batch_latency_s", "p50_clips_per_sec", "spread_s", "calib_tflops"],
    "t2i": ["metric", "value", "unit", "vs_baseline", "spread_s", "calib_tflops"],
    "train": ["metric", "value", "unit", "vs_baseline", "step_ms", "denoiser_mfu_est",
              "calib_tflops"],
}
BENCH_RECON_KEYS = ["recon_step_ms", "norecon_step_ms", "recon_every"]


def finite_numbers(obj) -> bool:
    """Every number in a JSON-like tree is finite."""
    import math

    if isinstance(obj, dict):
        return all(finite_numbers(v) for v in obj.values())
    if isinstance(obj, list):
        return all(finite_numbers(v) for v in obj)
    if isinstance(obj, float):
        return math.isfinite(obj)
    return True


def bench_phase(fa, smi) -> dict:
    """tools/bench.py's main in this process, run by run (BENCH_RUNS). Each
    run prints bench.py's own line; a bench line here adds the denoiser's
    tokens per sample and the launches. Gates: exactly bench.py's keys with
    a _cuda metric, value = batch / best_batch_latency_s (av), finite
    numbers and a finite last output, and the launches of every call or
    step exactly the run's count (the backward kernels none in sampling)."""
    import torch

    from multimodal_diffusion_torch.tools import bench

    paths = {}
    for name, argv, per_call in BENCH_RUNS:
        task = argv[argv.index("--task") + 1] if "--task" in argv else "av"
        reset_launch_counts(fa)
        run = bench.main(argv)
        got = launch_counts(fa)
        if task == "train":
            want = {k: per_call * run.calls for k in got}
        else:
            want = {"flash_fwd": per_call * run.calls, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
        keys = BENCH_KEYS[task] + (BENCH_RECON_KEYS if "recon_step_ms" in run.line else [])
        rec = {"phase": "bench", "run": name, "argv": argv, "device": smi, "tokens": run.tokens,
               "padded_tokens": run.padded_tokens, "calls": run.calls, "launches": got,
               "launches_per_call": {k: v / run.calls for k, v in got.items()},
               "line": run.line}
        emit(rec)
        line = run.line
        bad = []
        if list(line) != keys or not line["metric"].endswith("_cuda"):
            bad.append("keys or metric")
        if task == "av" and abs(line["value"] * line["best_batch_latency_s"] / 8 - 1) > 1e-3:
            bad.append("value != batch / best_batch_latency_s")
        if not (run.finite and finite_numbers(line)):
            bad.append("not finite")
        if got != want:
            bad.append(f"launches {got}, expected {want}")
        if name == "train_flagship" and line.get("recon_every") != 8:
            bad.append("no decode blend")
        if bad:
            raise AssertionError(f"bench {name}: {bad}")
        paths[f"bench_{name}"] = got
        torch.cuda.empty_cache()
    return paths


def eval_report_keys(sufs) -> list:
    """The keys of tools/eval_av_quality.py's mean report for n > 1 clips,
    the conditioning-sensitivity pass and the variants `sufs`."""
    keys = ["logmel_l1", "spec_convergence"]
    for suf in sufs:
        keys += [f"av_sync_corr{suf}_{who}" for who in ("gen", "real", "shuf", "real_shuf")]
    keys += ["env_corr_gen", "env_corr_shuf", "env_corr_real_shuf", "env_retrieval_top1",
             "logmel_l1_shuf", "retrieval_top1", "retrieval_margin", "cond_sensitivity_logmel",
             "cond_sensitivity_wav_l2"]
    for suf in sufs:
        keys += [f"gap{suf}_{who}{t}" for who in ("gen", "real") for t in ("", "_t")]
    return keys + ["gap_logmel", "gap_logmel_t", "gap_env", "gap_env_t", "n_clips", "ema"]


LATENT_STATS = ["rms_per_sample_mean", "rms_per_sample_min", "rms_per_sample_max", "std_global",
                "across_clip_std", "pairwise_cos_mean", "pairwise_cos_max"]
EVAL_CLIPS = 4


def write_eval_corpus(root: Path) -> list:
    """EVAL_CLIPS clips at the orbax fixture's shape (8 PNG frames of 32x32
    at 8 fps, 1 s of 8 kHz audio; a moving square and loudness-modulated
    noise) under `root`, a manifest, a copy of the fixture's checkpoint and
    an overlay naming both; returns the config paths."""
    import shutil

    import numpy as np
    import yaml
    from PIL import Image

    from multimodal_diffusion_torch.media.audio_io import write_wav

    rng = np.random.default_rng(0)
    clips = []
    for i in range(EVAL_CLIPS):
        fdir = root / f"clip_{i}"
        fdir.mkdir(parents=True)
        for t in range(8):
            img = rng.integers(0, 40, (32, 32, 3), dtype=np.uint8)
            r = (t * (1 + i) * 3) % 24
            img[r:r + 8, 4 * i:4 * i + 8] = 230
            Image.fromarray(img).save(fdir / f"frame_{t:06d}.png")
        env = np.repeat(rng.uniform(0.1, 0.6, 8), 1000)
        write_wav(root / f"clip_{i}.wav", (env * rng.uniform(-1, 1, 8000)).astype(np.float32),
                  8000)
        clips.append({"video_frames_dir": str(fdir), "audio_wav_path": str(root / f"clip_{i}.wav"),
                      "fps": 8, "sr": 8000, "clip_seconds": 1.0})
    (root / "clips.json").write_text(json.dumps({"clips": clips}))
    shutil.copytree(REPO / FIXTURE / "ckpt", root / "ckpt")
    overlay = root / "overlay.yaml"
    overlay.write_text(yaml.safe_dump({"paths": {"ckpt_path": str(root / "ckpt")},
                                       "data": {"train_split_glob": str(root / "clips.json")}}))
    return [str(REPO / FIXTURE / "config.yaml"), str(overlay)]


def quiet_call(main, argv):
    """main(argv) with its standard output kept out of this script's."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def tools_phase(fa, smi) -> dict:
    """The other tools of the repo on the card, one line each: quant_probe
    (bf16 / int8 / fp8 rates at its default sizes and their numerics),
    mfu_probe (the t2i core forward's MFU, attention alone through the flash
    kernel and dense), and, on the orbax fixture and EVAL_CLIPS synthetic
    clips written under runs/, eval_av_quality (its report's keys, finite)
    and latent_probe (the same). Launches of the flash kernels are counted
    per tool."""
    import shutil
    import tempfile

    import torch

    from multimodal_diffusion_torch.tools import eval_av_quality, latent_probe, mfu_probe, \
        quant_probe

    paths = {}
    t0 = time.perf_counter()
    q = quiet_call(quant_probe.main, [])
    emit({"phase": "quant_probe", "device": smi, "seconds": time.perf_counter() - t0, **q})
    num = q["qkv_numerics"]
    if not (finite_numbers(q) and 0 < num["int8_rel_err"] < 0.05 and num["fp8_e4m3_rel_err"] < 0.1
            and num["bf16_rel_err"] < 0.01):
        raise AssertionError(f"quant_probe: {q}")

    reset_launch_counts(fa)
    t0 = time.perf_counter()
    m = quiet_call(mfu_probe.main, [])
    paths["mfu_probe"] = launch_counts(fa)
    emit({"phase": "mfu_probe", "device": smi, "seconds": time.perf_counter() - t0,
          "launches": paths["mfu_probe"], **m})
    if not (finite_numbers(m) and m["attn_shape"] == [16, 4, 1152, 128]
            and 0 < m["core_mfu_vs_datasheet"] < 1 and "attn_flash_ms" in m):
        raise AssertionError(f"mfu_probe: {m}")

    (REPO / "runs").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_eval_", dir=REPO / "runs"))
    try:
        configs = write_eval_corpus(work)
        reset_launch_counts(fa)
        t0 = time.perf_counter()
        report = quiet_call(eval_av_quality.main, ["--config", *configs, "--n", str(EVAL_CLIPS)])
        paths["eval_av_quality"] = launch_counts(fa)
        want = eval_report_keys(["", "0", "_mouth", "_mouth0"])
        emit({"phase": "eval_av_quality", "device": smi, "seconds": time.perf_counter() - t0,
              "launches": paths["eval_av_quality"], "report": report})
        if sorted(report) != sorted(want) or not finite_numbers(report) \
                or report["n_clips"] != EVAL_CLIPS:
            raise AssertionError(f"eval_av_quality: keys {sorted(set(report) ^ set(want))}, "
                                 f"{report}")
        t0 = time.perf_counter()
        probe = quiet_call(latent_probe.main, ["--config", *configs, "--n", str(EVAL_CLIPS)])
        emit({"phase": "latent_probe", "device": smi, "seconds": time.perf_counter() - t0,
              "report": probe})
        if sorted(probe) != ["ema", "latent_rmsnorm", "n_clips", "z_audio", "z_video"] \
                or any(sorted(probe[z]) != sorted(LATENT_STATS) for z in ("z_video", "z_audio")) \
                or not finite_numbers(probe):
            raise AssertionError(f"latent_probe: {probe}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return paths


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
    text_cases = text_family_kernel_cases(fa, spin_cycles_per_s())
    pixel_cases = pixel_kernel_cases(fa, spin_cycles_per_s())
    by_path = {"v2a": {"flash_fwd": v2a_phase(fa)}}
    torch.cuda.empty_cache()
    by_path["train"] = train_phase(fa)
    torch.cuda.empty_cache()
    by_path["spec8_train"] = spec8_train_phase(fa)
    torch.cuda.empty_cache()
    by_path["spec8_v2a"], by_path["spec8_v2a_guided"] = spec8_v2a_phases(fa)
    torch.cuda.empty_cache()
    by_path["spec8_cli_resident"], by_path["spec8_cli_streamed"] = spec8_cli_phases(fa)
    torch.cuda.empty_cache()
    by_path["ref_ckpt"] = ref_ckpt_phase(fa)
    torch.cuda.empty_cache()
    by_path["orbax_fixture"] = orbax_fixture_phase(fa)
    torch.cuda.empty_cache()
    by_path["spec8_stream"] = spec8_stream_phase(fa)
    torch.cuda.empty_cache()
    text_paths, t2i_row = text_family_phases(fa)
    by_path.update(text_paths)
    by_path["serve_spec8"] = serve_spec8_phase(fa)
    torch.cuda.empty_cache()
    by_path.update(int8_phases(fa, t2i_row))
    torch.cuda.empty_cache()
    by_path.update(pixel_phases(fa))
    by_path["spec8_remat"] = spec8_remat_phase(fa, smi)
    torch.cuda.empty_cache()
    multi_paths, rank_cases = multi_rank_phase(fa, spin_cycles_per_s(), smi)
    by_path.update(multi_paths)
    torch.cuda.empty_cache()
    mpeg_audio_phase()
    decode_shrink_phase(spin_cycles_per_s(), smi)
    torch.cuda.empty_cache()
    by_path.update(bench_phase(fa, smi))
    by_path.update(tools_phase(fa, smi))

    def launches_of(name):
        paths = {path: counts[name] for path, counts in by_path.items() if counts.get(name)}
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    # ms, plain_ms, bound_ms and library_ms are the mvp shapes'; the flagship
    # shapes' stand beside them (the forward at the sampler's [16, 8, 421,
    # 128], the backward pair at the train step's and guided sampler's
    # [8, 8, 421, 128]), and the text families' (the forward at the t2i and
    # t2a samplers' cores, the backward pair at the t2i train step's core)
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
                     "library_ms": flag["library_ms"]},
        **{name: {"shape": rec["shape"], "max_abs_err": rec["max_abs_err_out"],
                  "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                  "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
           for name, rec in [(n, text_cases[n]["fwd"]) for n in ("t2i_sample", "t2a_sample")]
           + [(n, pixel_cases[n]["fwd"]) for n in ("pixel_sample", "pixel_train")]
           + [(n, rank_cases[n]["fwd"]) for n in ("ring_block", "model2_block")]}}]
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
            **{where: {"shape": rec["shape"], "max_abs_err": max(rec["max_abs_err"].values()),
                       "ms": rec["ms"], "plain_ms": rec["plain_pair_ms"],
                       "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                       "library_ms": rec["library_pair_ms"]}
               for where, rec in (("flagship", flag),
                                  ("t2i_train", text_cases["t2i_train"][kernel]),
                                  ("pixel_train", pixel_cases["pixel_train"][kernel]),
                                  ("ring_block", rank_cases["ring_block"][kernel]),
                                  ("model2_block", rank_cases["model2_block"][kernel]))}})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
