"""CogVideoX text-to-video sampling: diffusers' ``CogVideoXPipeline`` with
its ``CogVideoXDDIMScheduler`` over the transformer
(``models/cogvideox.py``) and the causal 3-D VAE decoder
(``models/cogvideox_vae.py``).

  noise [B, F, 16, H/8, W/8] from the call's generator, F = (frames - 1) / 4 + 1
  schedule: scaled_linear betas, rescaled to zero terminal SNR, 'trailing'
      timesteps (999, 979, ..., 19 at 50 steps), alpha_bar(-1) = 1
  each step, [uncond; cond] as one batch of 2B: v = model(x, x), then
      v_hat = v_u + guidance (v_c - v_u), x <- ddim_step(x, v_hat, param "v")
  decode (x permuted to [B, 16, F, h, w]) -> (x / 2 + 0.5) clamped to [0, 1]
      -> uint8 (255 x, rounded) [B, frames, H, W, 3]

The text tower (T5-XXL) is not part of the port: the sampler takes its
outputs, the prompt's and the negative prompt's token states [B, 226,
4096], precomputed (the CLI's ``--text-embeds``). The latent stays float32
between steps (the source keeps it in the weights' bf16).

Spans (``utils/profiling.span``): ``cogvideox.call`` around a call,
``cogvideox.upload`` (text states and noise to the device),
``cogvideox.step`` (each DDIM step), ``cogvideox.denoiser`` (its
transformer pass), ``cogvideox.decode`` and ``cogvideox.readback``; the
transformer opens ``cogvideox.blocks``.

    python -m multimodal_diffusion_torch.infer.sample_cogvideox \\
        --config configs/cogvideox_5b.yaml --text-embeds embeds.npz \\
        [--steps 50] [--guidance 6.0] [--seed 0] [--out-dir DIR] [--device cpu]

(``embeds.npz``: ``text`` and ``negative``, each [226, 4096] or [B, 226,
4096]). Weights come from the latest step under ``paths.ckpt_dir`` (the
port's checkpoint, diffusers' key names: the transformer's, the decoder's
under ``vae.``), else seeded random ones. Writes each video's frames as
JPEGs into ``--out-dir``/video_0000 ...
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..models.cogvideox import CogVideoXConfig, CogVideoXTransformer
from ..models.cogvideox_vae import CogVideoXVAEDecoder, VAEConfig
from ..models.flux import init_flux_weights
from ..ops.schedule import (alphas_cumprod_from_betas, ddim_step, make_beta_schedule,
                            make_sampling_schedule, rescale_zero_terminal_snr)
from ..train.checkpoint import cast_params_bf16
from ..utils.io import compute_dtype_from_config, load_config, resolve_device
from ..utils.profiling import span

VAE_PREFIX = "vae."
FAMILY = "cogvideox"


def schedule(cfg: Dict, steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """(alpha_bar [T_train] float32, the steps + 1 timesteps ending at -1)
    of the config's ``diffusion`` block."""
    d = cfg["diffusion"]
    T = int(d["train_steps"])
    betas = make_beta_schedule(T, str(d["beta_schedule"]), float(d["beta_start"]),
                               float(d["beta_end"]))
    abar = alphas_cumprod_from_betas(betas)[1]
    if bool(d.get("rescale_zero_terminal_snr", False)):
        abar = rescale_zero_terminal_snr(abar)
    return abar, make_sampling_schedule(T, steps, str(d.get("timestep_spacing", "linspace")))


def latent_shape(cfg: Dict, batch: int) -> Tuple[int, ...]:
    """[B, latent frames, 16, H / 8, W / 8] of the config's sampling size."""
    s, v = cfg["sampling"], cfg["model"]["vae"]
    r = int(v["temporal_compression_ratio"])
    return (batch, (int(s["frames"]) - 1) // r + 1, int(v["latent_channels"]),
            int(s["height"]) // 8, int(s["width"]) // 8)


def split_weights(weights: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One state dict -> the transformer's and the decoder's (the keys under
    ``vae.``, the prefix taken off)."""
    vae = {k[len(VAE_PREFIX):]: v for k, v in weights.items() if k.startswith(VAE_PREFIX)}
    return {k: v for k, v in weights.items() if not k.startswith(VAE_PREFIX)}, vae


def build_cogvideox(cfg: Dict, device: Union[str, torch.device] = "cuda",
                    weights: Optional[Dict[str, torch.Tensor]] = None,
                    seed: int = 0) -> Tuple[CogVideoXTransformer, CogVideoXVAEDecoder]:
    """The transformer and the VAE decoder in eval mode on `device`, built on
    the meta device. `weights` (the transformer's keys and the decoder's
    under ``vae.``) become the parameters themselves, in their own dtype
    (strict); without them the parameters are drawn from `seed` (matrices
    and kernels N(0, 1 / fan-in), norm weights 1, the rest N(0, 0.02)), and
    under bf16 compute cast to bf16 as served."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = compute_dtype_from_config(cfg)
    with torch.device("meta"):
        model = CogVideoXTransformer(CogVideoXConfig.from_config(cfg, dtype))
        vae = CogVideoXVAEDecoder(VAEConfig.from_config(cfg, dtype))
    if weights is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        for m in (model, vae):
            m.to_empty(device=dev)
            init_flux_weights(m, gen)
            if dtype == torch.bfloat16:
                cast_params_bf16(m)
    else:
        own, vae_sd = split_weights(weights)
        model.load_state_dict(own, strict=True, assign=True)
        vae.load_state_dict(vae_sd, strict=True, assign=True)
    return model.eval(), vae.eval()


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[B, 3, T, H, W] decoder output -> [B, T, H, W, 3] uint8: 255 clamp(x /
    2 + 0.5, 0, 1), rounded."""
    return torch.round(255.0 * (x / 2 + 0.5).clamp(0.0, 1.0)).to(torch.uint8).permute(
        0, 2, 3, 4, 1)


@torch.inference_mode()
def sample_cogvideox(cfg: Dict, model: CogVideoXTransformer, vae: CogVideoXVAEDecoder,
                     text: torch.Tensor, negative: torch.Tensor,
                     device: Union[str, torch.device], generator: torch.Generator,
                     steps: Optional[int] = None, guidance: Optional[float] = None
                     ) -> Dict[str, np.ndarray]:
    """Videos for a batch of prompts' T5 states (text and negative [B, L,
    4096], on the host or the device) at the config's sampling.frames x
    height x width: the noise drawn on the host from `generator`, ``steps``
    DDIM steps (default sampling.steps) at classifier-free ``guidance``
    (default sampling.guidance). Returns {"video": [B, frames, H, W, 3]
    uint8} on the host."""
    s = cfg["sampling"]
    steps = int(s["steps"]) if steps is None else int(steps)
    guidance = float(s["guidance"]) if guidance is None else float(guidance)
    device = torch.device(device)
    B = text.shape[0]
    abar_np, ts = schedule(cfg, steps)
    with span("cogvideox.call"):
        with span("cogvideox.upload"):
            x = torch.randn(latent_shape(cfg, B), generator=generator).to(device)
            ctx = torch.cat((negative, text)).to(device, model.cfg.dtype)
            abar = torch.as_tensor(abar_np, device=device)
        for t_now, t_prev in zip(ts[:-1], ts[1:]):
            with span("cogvideox.step"):
                t2 = torch.full((2 * B,), int(t_now), device=device, dtype=torch.long)
                with span("cogvideox.denoiser"):
                    v = model(torch.cat((x, x)), ctx, t2)
                v_u, v_c = v.chunk(2)
                v_hat = v_u + guidance * (v_c - v_u)
                x = ddim_step(x, t2[:B], torch.full_like(t2[:B], int(t_prev)), v_hat, abar,
                              param="v")
        with span("cogvideox.decode"):
            video = vae.decode(x.permute(0, 2, 1, 3, 4))
        with span("cogvideox.readback"):
            out = to_uint8(video).cpu().numpy()
    return {"video": out}


def load_text_embeds(path) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``.npz`` of ``text`` and ``negative`` ([L, 4096] or [B, L, 4096];
    a single negative is repeated over the batch) -> (text, negative), each
    [B, L, 4096] float32."""
    with np.load(path) as f:
        text, neg = np.asarray(f["text"], np.float32), np.asarray(f["negative"], np.float32)
    text = text[None] if text.ndim == 2 else text
    neg = neg[None] if neg.ndim == 2 else neg
    if neg.shape[0] == 1:
        neg = np.repeat(neg, text.shape[0], 0)
    if neg.shape != text.shape:
        raise ValueError(f"{path}: text {text.shape} and negative {neg.shape} differ")
    return torch.from_numpy(text), torch.from_numpy(neg)


def main(argv=None) -> List[Path]:
    from .sample_clip import latest_state_dict

    ap = argparse.ArgumentParser(description="CogVideoX text-to-video sampling")
    ap.add_argument("--config", type=str, nargs="+", required=True)
    ap.add_argument("--text-embeds", type=Path, required=True,
                    help="the prompts' and the negative prompt's T5 states (.npz)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--guidance", type=float, default=None)
    ap.add_argument("--out-dir", type=Path, default=Path("t2v_samples"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if (args.device or "").lower() == "cpu" else "cuda")
    cfg = load_config(*args.config)
    family = (cfg.get("model", {}) or {}).get("family")
    if family != FAMILY:
        raise SystemExit(f"this entry point samples model.family {FAMILY!r}, not {family!r}")
    ckpt_dir = (cfg.get("paths", {}) or {}).get("ckpt_dir")
    sd = latest_state_dict(ckpt_dir) if ckpt_dir else None
    if sd is None:
        print("[info] no checkpoint; sampling with random weights")
    else:  # served in the compute dtype, as cast_params_bf16 leaves a model
        sd = {k: v.to(device, compute_dtype_from_config(cfg)) for k, v in sd.items()}
    model, vae = build_cogvideox(cfg, device, sd, seed=int(cfg.get("seed", 0)))
    text, negative = load_text_embeds(args.text_embeds)
    videos = sample_cogvideox(cfg, model, vae, text, negative, device,
                              torch.Generator().manual_seed(args.seed), steps=args.steps,
                              guidance=args.guidance)["video"]
    from ..media.video_io import write_frames

    paths = [args.out_dir / f"video_{i:04d}" for i in range(len(videos))]
    for path, frames in zip(paths, videos):
        write_frames(frames, path, fps=int(cfg["sampling"].get("fps", 8)))
    print(f"[ok] wrote {len(videos)} videos -> {args.out_dir}")
    return paths


if __name__ == "__main__":
    main()
