"""One-shot DDIM sampling with classifier-free guidance, V->A or A->V
(counterpart of the JAX ``infer/sample_clip.py``). Public API + CLI:

  python -m multimodal_diffusion_torch.infer.sample_clip \
      --config configs/mvp.yaml configs/v2a.yaml \
      --frames path/to/frames_dir --out-audio out.wav

Runs on CUDA unless ``--device cpu`` (the entry points raise when CUDA is
asked for and absent). Weights come from the port's own checkpoint at
``paths.ckpt_path`` (``train/checkpoint.py``), from a JAX params tree carried
across by ``utils/convert.py``, or from a seeded random init; restoring an
orbax checkpoint of the JAX package is not ported yet.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..models.diffusion import AVDiffusionConfig, AVDiffusionModel, init_weights
from ..train.checkpoint import CheckpointManager, params_only_tree
from ..utils.convert import load_jax_params
from ..utils.io import compute_dtype_from_config, load_config, resolve_device
from .ddim import sampler_from_config

Device = Union[str, torch.device]


def _checkpoint_dir(cfg: Dict) -> Tuple[Optional[Path], Optional[int]]:
    """paths.ckpt_path -> (checkpoint directory, step or None for the
    latest)."""
    paths = cfg.get("paths", {}) or {}
    ckpt = paths.get("ckpt_path") or paths.get("ckpt")
    if not ckpt:
        return None, None
    ckpt = Path(str(ckpt))
    if ckpt.name == "latest":
        return ckpt.parent, None
    if ckpt.name.isdigit():
        return ckpt.parent, int(ckpt.name)
    return ckpt, None


def _restore(ckpt_dir: Path, step: Optional[int], use_ema: bool) -> Optional[Dict]:
    """The state_dict of the port's checkpoint in `ckpt_dir`, or None when
    the directory holds no checkpoint."""
    mgr = CheckpointManager(ckpt_dir)
    step = step if step is not None else mgr.latest_step()
    if step is None:
        return None
    if not (mgr.dir / str(step) / "params.pt").exists():
        raise NotImplementedError(
            f"{mgr.dir / str(step)} is not a checkpoint of this port (restoring the "
            f"JAX package's orbax checkpoints is not ported yet); convert its params "
            f"tree and pass params=")
    print(f"[ckpt] restored step {step} from {mgr.dir} (ema={use_ema})")
    return params_only_tree(mgr.restore(step), use_ema=use_ema)


def build_components(cfg: Dict, params: Optional[Mapping] = None,
                     device: Device = "cuda", use_ema: bool = False) -> AVDiffusionModel:
    """The model in eval mode on `device`: weights from a JAX params tree
    when given, else from the port's checkpoint at paths.ckpt_path (with the
    EMA shadow swapped in when `use_ema`), else a random init seeded by
    cfg['seed'].

    Sets torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 to False: fp32 matmuls and convolutions
    run in full fp32 (cuDNN would use TF32 for conv3d by default); bf16
    compute is unaffected."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = AVDiffusionModel(AVDiffusionConfig.from_config(
        cfg, dtype=compute_dtype_from_config(cfg)))
    if params is not None:
        load_jax_params(model, params)
        return model.to(dev).eval()
    ckpt_dir, step = _checkpoint_dir(cfg)
    state = _restore(ckpt_dir, step, use_ema) if ckpt_dir and ckpt_dir.exists() else None
    if state is not None:
        model.load_state_dict(state, strict=True)
    else:
        print("[info] no checkpoint; sampling with random weights.")
        init_weights(model, torch.Generator().manual_seed(int(cfg.get("seed", 0))))
    return model.to(dev).eval()


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def sample_one_direction(
    *,
    cfg: Dict,
    model: AVDiffusionModel,
    prompt_modality: str,  # "video" -> generate audio; "audio" -> generate video
    prompt_video=None,  # [T,H,W,3] or [B,T,H,W,3] uint8 (numpy or torch)
    prompt_audio=None,  # [L] or [B,L] float32 (numpy or torch)
    generator: Optional[torch.Generator] = None,
    device: Device = "cuda",
) -> Dict[str, object]:
    """DDIM+CFG generation of the non-prompt modality.

    Returns {"audio": wav float32 [L] or [B,L], "sr": int} or
    {"video": frames uint8 [T,H,W,3] or [B,T,H,W,3], "fps": int}; a leading
    batch axis on the prompt generates B clips in one batched call.
    `generator` (a CPU generator) draws the initial noise."""
    if prompt_modality not in {"video", "audio"}:
        raise ValueError("prompt_modality must be 'video' or 'audio'")
    dev = _model_device(model)
    if dev.type != resolve_device(device).type:
        raise ValueError(f"model is on {dev}, not {device}")
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))

    vl = cfg["video"]["latent"]
    al = cfg["audio"]["latent"]
    Cv, t_down, s_down = int(vl["channels"]), int(vl["t_down"]), int(vl["s_down"])
    Ca, Fa = int(al["channels"]), int(al["frames_per_clip"])
    sr = int(cfg["audio"]["sr"])
    fps = int(cfg["video"]["fps"])
    H, W = (int(x) for x in cfg["video"]["size"])

    with torch.inference_mode():
        if prompt_modality == "video":
            if prompt_video is None:
                raise ValueError("prompt_video frames required for prompt_modality=video")
            frames = torch.as_tensor(prompt_video).to(dev, torch.float32) / 255.0
            batched = frames.ndim == 5
            if not batched:
                frames = frames[None]
            B = frames.shape[0]
            frames = frames.permute(0, 4, 1, 2, 3)  # [B,3,T,H,W]
            T_in = frames.shape[2]
            T_crop = (T_in // t_down) * t_down
            if T_crop == 0:
                raise ValueError(f"prompt has {T_in} frames; need at least {t_down}")
            if T_crop != T_in:
                s0 = (T_in - T_crop) // 2
                frames = frames[:, :, s0:s0 + T_crop]
            z_v0 = model.encode_video(frames)
            z_init = torch.randn((B, Ca, Fa), generator=generator).to(dev)
            sample, _ = sampler_from_config(cfg, target="audio")
            z_a = sample(model, z_v0, z_init)
            wav = model.decode_audio(z_a)[:, 0].float().cpu().numpy()  # [B, L]
            return {"audio": wav if batched else wav[0], "sr": sr}

        if prompt_audio is None:
            raise ValueError("prompt_audio required for prompt_modality=audio")
        wav = torch.as_tensor(prompt_audio).to(dev, torch.float32)
        batched = wav.ndim == 2
        if not batched:
            wav = wav[None]
        B = wav.shape[0]
        z_a0 = model.encode_audio(wav[:, None, :])
        T_in = (prompt_video.shape[-4] if prompt_video is not None
                else int(round(float(cfg["data"]["clip_seconds"]) * fps)))
        Tp = max(1, T_in // t_down)
        z_init = torch.randn((B, Cv, Tp, H // s_down, W // s_down),
                             generator=generator).to(dev)
        sample, _ = sampler_from_config(cfg, target="video")
        z_v = sample(model, z_a0, z_init)
        x = model.decode_video(z_v).float().clamp(0, 1).cpu().numpy()  # [B,3,T,H,W]
        frames_u8 = (x.transpose(0, 2, 3, 4, 1) * 255.0).astype(np.uint8)
        return {"video": frames_u8 if batched else frames_u8[0], "fps": fps}


def main(argv=None):
    ap = argparse.ArgumentParser(description="One-shot DDIM sampling with CFG (V->A or A->V).")
    ap.add_argument("--config", type=str, nargs="+", required=True,
                    help="One or more YAML configs (merged left->right)")
    ap.add_argument("--frames", type=Path, default=None,
                    help="Prompt: directory of frames (for V->A)")
    ap.add_argument("--audio", type=Path, default=None, help="Prompt: audio wav (for A->V)")
    ap.add_argument("--out-frames", type=Path, default=None,
                    help="Output frames directory (for A->V)")
    ap.add_argument("--save-mp4", type=Path, default=None, help="Optional mp4 path (for A->V)")
    ap.add_argument("--out-audio", type=Path, default=None, help="Output wav path (for V->A)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; cuda raises when absent")
    args = ap.parse_args(argv)

    from ..media.audio_io import read_wav, write_wav
    from ..media.video_io import load_frames_dir, write_frames

    cfg = load_config(*args.config)
    model = build_components(cfg, device=args.device)
    prompt_modality = cfg.get("sampling", {}).get("prompt_modality", "video")
    if prompt_modality == "video":
        if args.frames is None:
            raise SystemExit("Provide --frames for prompt_modality=video")
        H, W = (int(x) for x in cfg["video"]["size"])
        result = sample_one_direction(
            cfg=cfg, model=model, prompt_modality="video",
            prompt_video=load_frames_dir(args.frames, size_hw=(H, W)), device=args.device)
        out = args.out_audio or Path("samples_out.wav")
        write_wav(out, result["audio"], result["sr"])
        print(f"[ok] wrote audio -> {out}")
    elif prompt_modality == "audio":
        if args.audio is None:
            raise SystemExit("Provide --audio for prompt_modality=audio")
        prompt_audio, _ = read_wav(args.audio, sr=int(cfg["audio"]["sr"]))
        result = sample_one_direction(
            cfg=cfg, model=model, prompt_modality="audio", prompt_audio=prompt_audio,
            device=args.device)
        out_dir = args.out_frames or Path("frames_out")
        write_frames(result["video"], out_dir, mp4_path=args.save_mp4, fps=result["fps"])
        print(f"[ok] wrote frames -> {out_dir}")
    else:
        raise ValueError("sampling.prompt_modality must be 'video' or 'audio'")


if __name__ == "__main__":
    main()
