"""The port's headline benchmark, on one CUDA card (counterpart of the repo
root's ``bench.py``, whose flags, defaults, method and one-line JSON output it
keeps):

    python -m multimodal_diffusion_torch.tools.bench [--task av|t2i|train]
        [--batch 8] [--steps 50] [--repeats 7] [--inner 3] [--direction v2a|a2v]
        [--image-size 512] [--config A.yaml [B.yaml ...]] [--cpu]
        [--quant none|int8] [--sampler ddim|dpmpp_2m] [--serving]

Tasks:
  av    — the reference's headline task: configs/mvp.yaml (or ``--config``),
          VideoVAE encode of the prompt, ``--steps`` DDIM steps with batched
          classifier-free guidance (``infer/ddim.py::sampler_from_config``),
          codec decode; v2a or a2v; clips/s. The sampler gets no mouth-crop
          tokens, as ``bench.py`` passes none: under the flagship config the
          stream is zeroed with keep 0 (the JAX sampler's ``tok_mouth=None``)
          and the sequence keeps its 288 mouth tokens.
  t2i   — text -> image at ``bench.py``'s hard-coded widths, not
          configs/t2i_512.yaml's: core d=512, 8 layers, 4 heads of 128,
          seq_multiple 128; text encoder d=256, 4 layers; VAE lat_ch 4,
          down 8, base 64, max_ch 256; guidance 5.0; "a photo of a tpu"
          against ""; images/s.
  train — the full AV train step (``train/trainer.py::create_trainer``, one
          process, parallel.data 1) on a fixed uniform batch already on the
          device; clips/s. Where training.recon_every = K > 1 the decode step
          and the step without the decode are timed apart and blended as
          (t_recon + (K - 1) t_norecon) / K.

Method (``bench.py``'s): two warm-up calls, then ``--repeats`` samples, each
``--inner`` calls enqueued back to back and one ``torch.cuda.synchronize()``;
the minimum is the headline and the median stands beside it. Compute is bf16
on the card and fp32 under ``--cpu``; inference weights are N(0, 0.02) from
``np.random.default_rng(0)`` in the port's parameter order, cast to bf16 once
on the card (``cast_params_bf16``). ``vs_baseline`` divides by the
reference's measured CPU throughput (BASELINE_MEASURED.json), as there.
``calib_tflops`` is ``utils/profiling.py::calib_tflops`` (None on the CPU).
The metric names end in the backend, ``cuda`` or ``cpu``.

Left out, as TPU-only: the chip claim (``bench.py::_claim_chip``; a CUDA card
is shared without one) and the re-exec on a backend UNAVAILABLE error: here a
failure fails. Without CUDA and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..infer.ddim import sampler_from_config
from ..models.diffusion import AVDiffusionConfig, AVDiffusionModel
from ..models.latent_text2image import Text2ImageConfig, Text2ImageModel, make_t2i_sampler
from ..models.mmdit import MMDiTConfig
from ..models.text_encoder import TextEncoderConfig, tokenize_text
from ..models.vae_image2d import ImageVAEConfig
from ..train.checkpoint import cast_params_bf16
from ..train.trainer import build_train_step, create_trainer
from ..utils.convert import load_jax_params
from ..utils.io import latent_shapes_from_config, load_config, resolve_device
from ..utils.profiling import calib_tflops, flops_mmdit_forward, mfu

REPO = Path(__file__).resolve().parents[2]
T2I_PROMPT, T2I_NEGATIVE, T2I_GUIDANCE = "a photo of a tpu", "", 5.0


@dataclasses.dataclass
class BenchRun:
    """What one task printed (``line``) and what a caller checks beside it:
    the pipeline calls or train steps the run made (warm-ups included), the
    denoiser's tokens per sample (before and after the core's padding), and
    whether the last output was finite."""

    line: Dict
    calls: int
    tokens: int
    padded_tokens: int
    finite: bool


def compute_dtype(dev: torch.device) -> torch.dtype:
    """bf16 on the card, fp32 on the CPU (``bench.py``: bf16 on the TPU)."""
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fill_normal_(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Every parameter N(0, 0.02) from np.random.default_rng(seed), in the
    model's parameter order (``bench.py``'s benchmark-speed weights; the
    time does not depend on their values)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(0.0, 0.02, tuple(p.shape)).astype(np.float32)))
    return model


def _place(model: torch.nn.Module, params: Optional[Mapping], dev: torch.device,
           dtype: torch.dtype) -> torch.nn.Module:
    """Weights from a JAX params tree (``utils/convert.py``) or N(0, 0.02);
    cast to bf16 once under bf16 compute; moved to `dev` in eval mode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if params is not None:
        load_jax_params(model, params)
    else:
        fill_normal_(model)
    if dtype == torch.bfloat16:
        cast_params_bf16(model)
    return model.to(dev).eval()


def build_av_pipeline(cfg: Dict, direction: str, batch: int, device="cuda",
                      params: Optional[Mapping] = None
                      ) -> Tuple[AVDiffusionModel, Callable]:
    """(model, pipeline) of the av task: pipeline(video [B, 3, T, H, W],
    audio [B, 1, L], z_init) -> (the sampled target latent, the decoded
    output): v2a encodes the video prompt, samples the audio latent from
    z_init [B, Ca, Fa] and decodes the waveform [B, 1, L]; a2v encodes the
    audio and decodes video [B, 3, T, H, W]. The weights are the JAX tree
    `params` when given, else N(0, 0.02); `batch` only sizes the check of
    z_init's shape."""
    if direction not in ("v2a", "a2v"):
        raise ValueError(f"direction must be v2a|a2v, got {direction!r}")
    dev = resolve_device(device)
    dtype = compute_dtype(dev)
    model = _place(AVDiffusionModel(AVDiffusionConfig.from_config(cfg, dtype=dtype)), params,
                   dev, dtype)
    target = "audio" if direction == "v2a" else "video"
    sample, _ = sampler_from_config(cfg, target)
    shapes = latent_shapes_from_config(cfg, batch)
    z_shape = shapes["z_audio" if target == "audio" else "z_video"]

    def pipeline(video: torch.Tensor, audio: torch.Tensor, z_init: torch.Tensor):
        if tuple(z_init.shape) != tuple(z_shape):
            raise ValueError(f"z_init has shape {tuple(z_init.shape)}, expected {z_shape}")
        with torch.inference_mode():
            if target == "audio":
                z = sample(model, model.encode_video(video), z_init)
                return z, model.decode_audio(z)
            z = sample(model, model.encode_audio(audio), z_init)
            return z, model.decode_video(z)

    return model, pipeline


def av_tokens(model: AVDiffusionModel, cfg: Dict) -> Tuple[int, int]:
    """The denoiser's tokens per sample of the av task (video + audio, plus
    the mouth-crop stream where it is enabled) and that count padded to the
    core's seq_multiple."""
    s = latent_shapes_from_config(cfg, 1)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        n = (model.tokenize_video(torch.zeros(s["z_video"], device=dev)).shape[1]
             + model.tokenize_audio(torch.zeros(s["z_audio"], device=dev)).shape[1])
    if model.cfg.mouth_enabled:
        n += int(np.prod(model.mouth_grid(s["video"][2])))
    return n, _padded(n, model.cfg.core.seq_multiple)


def _padded(n: int, multiple: int) -> int:
    m = max(1, int(multiple))
    return -(-n // m) * m


def t2i_config(image_size: int = 512, quant: str = "none",
               dtype: torch.dtype = torch.float32) -> Text2ImageConfig:
    """``bench.py``'s hard-coded Text2ImageConfig (its t2i row, 8 core
    layers; configs/t2i_512.yaml has 16)."""
    return Text2ImageConfig(
        image_size=image_size, patch=2, width=512,
        vae=ImageVAEConfig(lat_ch=4, down=8, base=64, max_ch=256, dtype=dtype),
        text=TextEncoderConfig(
            width=256, max_len=77,
            core=MMDiTConfig(d_model=256, n_layers=4, n_heads=4, dropout=0.0, dtype=dtype),
            dtype=dtype),
        core=MMDiTConfig(d_model=512, n_layers=8, n_heads=4, dropout=0.0, seq_multiple=128,
                         quant=quant, dtype=dtype),
        dtype=dtype)


def build_t2i_pipeline(image_size: int = 512, quant: str = "none", sampler: str = "ddim",
                       steps: int = 50, device="cuda", params: Optional[Mapping] = None
                       ) -> Tuple[Text2ImageModel, Callable]:
    """(model, pipeline) of the t2i task: pipeline(ids, neg_ids, z_init) ->
    (the sampled latents, the decoded images [B, 3, S, S] in [-1, 1]), `steps`
    `sampler` steps at guidance 5.0. ids and neg_ids [B, 77] are token ids
    (``tokenize_text``), best already on the device; the weights are the
    JAX tree `params` when given, else N(0, 0.02)."""
    dev = resolve_device(device)
    dtype = compute_dtype(dev)
    model = _place(Text2ImageModel(t2i_config(image_size, quant, dtype)), params, dev, dtype)
    sample = make_t2i_sampler(model, steps, T2I_GUIDANCE, sampler=sampler)

    def pipeline(ids, neg_ids, z_init: torch.Tensor):
        z = sample(ids, neg_ids, z_init=z_init)
        with torch.inference_mode():
            return z, model.decode_image(z)

    return model, pipeline


def time_calls(call: Callable[[int], torch.Tensor], dev: torch.device, repeats: int,
               inner: int) -> Tuple[List[float], torch.Tensor]:
    """Two warm-up calls, then `repeats` samples of `inner` calls enqueued
    back to back and one synchronisation: (seconds per call of each sample,
    the last output). call(seed) draws its own noise from `seed`."""
    for _ in range(2):  # the first builds kernels and plans; the second is steady
        call(1)
        sync(dev)
    times, out = [], None
    for i in range(repeats):
        t0 = time.perf_counter()
        outs = [call(2 + i * inner + j) for j in range(inner)]
        sync(dev)
        times.append((time.perf_counter() - t0) / inner)
        out = outs[-1]
    return times, out


def _noise(shape, seed: int, dev: torch.device) -> torch.Tensor:
    """N(0, 1) drawn on `dev` (a host draw would copy, and wait for the
    device, on every call)."""
    return torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(seed),
                       device=dev)


def _vs_baseline(per_sec: float, direction: str) -> float:
    f = REPO / "BASELINE_MEASURED.json"
    if not f.exists():
        return 0.0
    ref = json.loads(f.read_text())["results"].get(direction, {}).get("clips_per_sec")
    return per_sec / float(ref) if ref else 0.0


def _calib(dev: torch.device) -> Optional[float]:
    """The card's bf16 matmul rate now (TFLOP/s, one decimal); None on the
    CPU, as ``bench.py`` gives None off the TPU."""
    if dev.type != "cuda":
        return None
    r = calib_tflops()
    return None if r is None else round(r, 1)


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x.float()).all())


def bench_av(args, dev: torch.device) -> BenchRun:
    cfg = load_config(*(args.config or [REPO / "configs" / "mvp.yaml"]))
    cfg["diffusion"]["video"]["sampler_steps"] = args.steps
    cfg["diffusion"]["audio"]["sampler_steps"] = args.steps
    if args.quant != "none":
        cfg.setdefault("model", {}).setdefault("core", {})["quant"] = args.quant
    B = args.batch
    model, pipeline = build_av_pipeline(cfg, args.direction, B, dev)
    shapes = latent_shapes_from_config(cfg, B)
    rng = np.random.default_rng(0)
    video = torch.from_numpy(rng.uniform(0, 1, shapes["video"]).astype(np.float32)).to(dev)
    audio = torch.from_numpy(rng.uniform(-1, 1, shapes["audio"]).astype(np.float32)).to(dev)
    z_shape = shapes["z_audio" if args.direction == "v2a" else "z_video"]

    def call(seed: int) -> torch.Tensor:
        return pipeline(video, audio, _noise(z_shape, seed, dev))[1]

    times, out = time_calls(call, dev, args.repeats, args.inner)
    t_best, t_med = float(np.min(times)), float(np.median(times))
    clips_per_sec = B / t_best
    line = {
        "metric": f"{args.direction}_clips_per_sec_{args.steps}step_cfg_b{B}"
                  + (f"_{args.quant}" if args.quant != "none" else "") + f"_{dev.type}",
        "value": round(clips_per_sec, 4),
        "unit": "clips/sec/chip",
        "vs_baseline": round(_vs_baseline(clips_per_sec, args.direction), 2),
        "best_batch_latency_s": round(t_best, 4),
        "p50_batch_latency_s": round(t_med, 4),
        "p50_clips_per_sec": round(B / t_med, 4),
        "spread_s": [round(min(times), 4), round(max(times), 4)],
        "calib_tflops": _calib(dev),
    }
    n, n_pad = av_tokens(model, cfg)
    return BenchRun(line, 2 + args.repeats * args.inner, n, n_pad, _finite(out))


def bench_t2i(args, dev: torch.device) -> BenchRun:
    B = args.batch
    model, pipeline = build_t2i_pipeline(args.image_size, args.quant, args.sampler, args.steps,
                                         dev)
    c = model.cfg
    ids = torch.from_numpy(tokenize_text([T2I_PROMPT] * B, c.text.max_len)).to(dev)
    neg = torch.from_numpy(tokenize_text([T2I_NEGATIVE] * B, c.text.max_len)).to(dev)

    def call(seed: int) -> torch.Tensor:
        return pipeline(ids, neg, _noise((B,) + c.latent_shape, seed, dev))[1]

    times, out = time_calls(call, dev, args.repeats, args.inner)
    imgs_per_sec = B / float(np.min(times))
    line = {
        "metric": f"t2i{args.image_size}_images_per_sec_{args.steps}step_cfg_b{B}"
                  + (f"_{args.sampler}" if args.sampler != "ddim" else "")
                  + (f"_{args.quant}" if args.quant != "none" else "") + f"_{dev.type}",
        "value": round(imgs_per_sec, 4),
        "unit": "images/sec/chip",
        "vs_baseline": round(_vs_baseline(imgs_per_sec, "v2a"), 2),
        "spread_s": [round(float(np.min(times)), 4), round(float(np.max(times)), 4)],
        "calib_tflops": _calib(dev),
    }
    n = c.text.max_len + c.n_img_tokens
    return BenchRun(line, 2 + args.repeats * args.inner, n, _padded(n, c.core.seq_multiple),
                    _finite(out))


def build_train_bench(cfg: Dict, batch: int, device="cuda"):
    """(bundle, batch on the device, steps) of the train task: the trainer
    of `cfg` at global batch `batch` in one process (parallel.data 1), the
    fixed uniform batch of ``bench.py`` (np.random.default_rng(0), every
    clip with video and audio), and the step functions {"recon": ...} and,
    where training.recon_every > 1 with a reconstruction loss, also
    {"norecon": ...}: the step with the decode on every call and the step
    with recon_loss_weight 0 (the JAX trainer's train_step_norecon)."""
    cfg = {**cfg, "data": {**cfg["data"], "batch_size": batch},
           "parallel": {"data": 1, "model": 1}}
    bundle = create_trainer(cfg, device=device)
    rng = np.random.default_rng(0)
    s = bundle.latent_shapes
    B = s["video"][0]
    host = {"video": rng.uniform(0, 1, s["video"]).astype(np.float32),
            "audio": rng.uniform(-1, 1, s["audio"]).astype(np.float32),
            "has_video": np.ones(B, bool), "has_audio": np.ones(B, bool)}
    dev_batch = {k: torch.from_numpy(v).to(bundle.device) for k, v in host.items()}
    sc = bundle.step_config
    steps = {"recon": bundle.train_step}
    if sc.recon_weight > 0.0 and sc.recon_every > 1:
        steps = {name: build_train_step(dataclasses.replace(sc, **kw), bundle.abar_v,
                                        bundle.abar_a, bundle.mesh)
                 for name, kw in (("recon", {"recon_every": 1}),
                                  ("norecon", {"recon_weight": 0.0}))}
    return bundle, dev_batch, steps


def time_steps(step: Callable, bundle, batch, n_iters: int) -> Tuple[float, Dict]:
    """Seconds per step over `n_iters` steps enqueued back to back (audio
    the target, as ``bench.py``), synchronised once; and the last metrics."""
    t0 = time.perf_counter()
    for _ in range(n_iters):
        m = step(bundle.state, batch, 1.0)
    float(m["loss"])  # waits for the device
    return (time.perf_counter() - t0) / n_iters, m


def bench_train(args, dev: torch.device) -> BenchRun:
    cfg = load_config(*(args.config or [REPO / "configs" / "mvp.yaml"]))
    bundle, batch, steps = build_train_bench(cfg, args.batch, dev)
    B = bundle.latent_shapes["video"][0]
    for _ in range(2):  # warm-ups
        m = steps["recon"](bundle.state, batch, 1.0)
        float(m["loss"])
    n_iters = max(5, args.repeats)
    dt, m = time_steps(steps["recon"], bundle, batch, n_iters)
    calls, finite = 2 + n_iters, _finite(m["loss"])
    extra = {}
    if "norecon" in steps:
        K = bundle.step_config.recon_every
        dt_recon = dt
        float(steps["norecon"](bundle.state, batch, 1.0)["loss"])  # warm-up
        dt_nr, m = time_steps(steps["norecon"], bundle, batch, n_iters)
        calls, finite = calls + 1 + n_iters, finite and _finite(m["loss"])
        dt = (dt_recon + (K - 1) * dt_nr) / K
        extra = {"recon_step_ms": round(dt_recon * 1e3, 2),
                 "norecon_step_ms": round(dt_nr * 1e3, 2), "recon_every": K}
    # rough MFU, bench.py's formula: the denoiser's fwd + bwd (3x the
    # forward) at the mvp shape (133 tokens, d=512, 8 layers), whatever the config
    flops = 3 * B * flops_mmdit_forward(133, 512, 8)
    line = {
        "metric": f"train_clips_per_sec_b{B}_{dev.type}",
        "value": round(B / dt, 4),
        "unit": "clips/sec",
        "vs_baseline": 0.0,
        "step_ms": round(dt * 1e3, 2),
        "denoiser_mfu_est": round(mfu(flops / dt, dev), 4),
        "calib_tflops": _calib(dev),
        **extra,
    }
    n, n_pad = av_tokens(bundle.model, cfg)
    return BenchRun(line, calls, n, n_pad, finite)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", choices=["av", "t2i", "train"], default="av",
                    help="av: AV clip sampling; t2i: text->image latent diffusion with CFG; "
                         "train: the full AV train step")
    ap.add_argument("--batch", type=int, default=8, help="clips (or images) per batch")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=7,
                    help="timed samples (the least is reported, the median beside it)")
    ap.add_argument("--inner", type=int, default=3,
                    help="calls enqueued back to back per timed sample")
    ap.add_argument("--direction", choices=["v2a", "a2v"], default="v2a")
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--config", type=str, nargs="+", default=None,
                    help="configs merged left to right for the av and train tasks "
                         "(default: configs/mvp.yaml)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (fp32)")
    ap.add_argument("--quant", choices=["none", "int8"], default="none",
                    help="av/t2i: the W8A8 int8 core (ops/quant.py)")
    ap.add_argument("--sampler", choices=["ddim", "dpmpp_2m"], default="ddim",
                    help="t2i: the ODE solver")
    ap.add_argument("--serving", action="store_true",
                    help="t2i: dpmpp_2m at 12 steps with the int8 core")
    args = ap.parse_args(argv)
    if args.serving:
        args.sampler, args.steps, args.quant = "dpmpp_2m", 12, "int8"
    return args


def main(argv=None) -> BenchRun:
    """Run one task and print its JSON line; returns the BenchRun."""
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    run = {"av": bench_av, "t2i": bench_t2i, "train": bench_train}[args.task](args, dev)
    print(json.dumps(run.line), flush=True)
    return run


if __name__ == "__main__":
    main()
