"""Sliding-window A->V / V->A generation with crossfade stitching
(counterpart of the JAX package's ``infer/stream_infer.py``):

    python -m multimodal_diffusion_torch.infer.stream_infer \\
        --config configs/mvp.yaml configs/v2a.yaml --frames DIR \\
        [--ckpt CKPT] [--ema] [--out-dir stream_out] [--device cpu]

The prompt is cut into ``streaming.window_seconds`` windows every
``streaming.hop_seconds`` (the last one padded: zeros for audio, the last
frame repeated for video); the other modality is sampled for every window;
the windows are stitched with a cosine crossfade overlap-add for audio and
a triangular alpha blend for video (``streaming.crossfade_seconds``).
Windowing and stitching are host numpy, exactly the JAX package's. The
windows ride the sampler's batch axis in chunks of
``streaming.max_batch_windows`` (default 8); the last chunk is padded by
repeating its final window to the same batch size, so N windows cost
ceil(N / B) batched sampler calls of one shape. Each call draws its initial
noise from the config's seed, as each JAX call does from its default key.

Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Tuple

import numpy as np

from ..utils.io import load_config
from .sample_clip import (Device, add_checkpoint_args, build_components, config_with_checkpoint,
                          sample_one_direction)


# ---------------------------------------------------------------------------
# windowing
# ---------------------------------------------------------------------------


def split_audio_into_windows(
    y: np.ndarray, sr: int, win_s: float, hop_s: float
) -> Tuple[np.ndarray, int, int]:
    """[L] -> ([N, win], win, hop); last window zero-padded."""
    L = len(y)
    win = int(round(sr * win_s))
    hop = int(round(sr * hop_s))
    if L <= win:
        pad = np.pad(y, (0, win - L)) if L < win else y
        return pad[None, :], win, hop
    chunks = []
    start = 0
    while start < L:
        end = min(L, start + win)
        seg = y[start:end]
        if len(seg) < win:
            seg = np.pad(seg, (0, win - len(seg)))
        chunks.append(seg)
        if end == L:
            break
        start += hop
    return np.stack(chunks, axis=0), win, hop


def split_frames_into_windows(
    frames: np.ndarray, fps: int, win_s: float, hop_s: float
) -> Tuple[np.ndarray, int, int]:
    """[T, H, W, 3] -> ([N, win, H, W, 3], win, hop); pads by repeating the
    last frame."""
    T = frames.shape[0]
    win = int(round(fps * win_s))
    hop = int(round(fps * hop_s))
    if T <= win:
        if T < win:
            pad = np.repeat(frames[-1:], win - T, axis=0)
            frames = np.concatenate([frames, pad], axis=0)
        return frames[None, ...], win, hop
    chunks = []
    start = 0
    while start < T:
        end = min(T, start + win)
        seg = frames[start:end]
        if seg.shape[0] < win:
            pad = np.repeat(seg[-1:], win - seg.shape[0], axis=0)
            seg = np.concatenate([seg, pad], axis=0)
        chunks.append(seg)
        if end == T:
            break
        start += hop
    return np.stack(chunks, axis=0), win, hop


# ---------------------------------------------------------------------------
# crossfade stitching
# ---------------------------------------------------------------------------


def crossfade_audio(
    chunks: np.ndarray, sr: int, hop: int, win: int, fade_s: float
) -> np.ndarray:
    """[N, L] -> stitched [L_total] with cosine fades at window edges."""
    N, L = chunks.shape
    fade = int(round(sr * fade_s))
    w = np.ones(L, dtype=np.float32)
    if fade > 0:
        ramp = 0.5 * (1.0 - np.cos(np.linspace(0, np.pi, fade, dtype=np.float32)))
        w[:fade] = ramp           # fade-in
        w[-fade:] = ramp[::-1]    # fade-out
    y = np.zeros((N - 1) * hop + L, dtype=np.float32)
    norm = np.zeros_like(y)
    for i in range(N):
        a = i * hop
        y[a : a + L] += chunks[i] * w
        norm[a : a + L] += w
    return (y / np.maximum(norm, 1e-6)).astype(np.float32)


def crossfade_video(chunks: np.ndarray, hop: int, win: int, fade_f: int) -> np.ndarray:
    """[N, T, H, W, 3] uint8 -> stitched frames with triangular alpha blend."""
    N, L, H, W, C = chunks.shape
    w = np.ones((L, 1, 1, 1), dtype=np.float32)
    fade = int(fade_f)
    if fade > 0:
        ramp = np.linspace(0, 1, fade, dtype=np.float32)
        w[:fade] *= ramp.reshape(-1, 1, 1, 1)
        w[-fade:] *= ramp[::-1].reshape(-1, 1, 1, 1)
    out = np.zeros(((N - 1) * hop + L, H, W, C), dtype=np.float32)
    norm = np.zeros((out.shape[0], 1, 1, 1), dtype=np.float32)
    for i in range(N):
        a = i * hop
        out[a : a + L] += chunks[i].astype(np.float32) / 255.0 * w
        norm[a : a + L] += w
    out = out / np.maximum(norm, 1e-6)
    return (np.clip(out, 0, 1) * 255.0).astype(np.uint8)


# ---------------------------------------------------------------------------
# batched window sampling
# ---------------------------------------------------------------------------


def sample_windows_batched(
    chunks: np.ndarray,
    *,
    cfg,
    model,
    prompt_modality: str,
    max_batch: int,
    device: Device = "cuda",
) -> np.ndarray:
    """Run all N windows through the batched sampler in ceil(N/B) calls of
    sample_one_direction. The last chunk is padded (repeating the final
    window) to the same batch size B = min(max_batch, N); the padding's
    outputs are dropped. Each call seeds its initial noise from cfg['seed'],
    as the JAX package's calls do."""
    N = chunks.shape[0]
    B = max(1, min(int(max_batch), N))
    key = "audio" if prompt_modality == "video" else "video"
    outs = []
    for a in range(0, N, B):
        batch = chunks[a : a + B]
        pad = B - batch.shape[0]
        if pad:
            batch = np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)])
        kw = {"prompt_video": batch} if prompt_modality == "video" else {
            "prompt_audio": batch}
        out = sample_one_direction(cfg=cfg, model=model, prompt_modality=prompt_modality,
                                   device=device, **kw)[key]
        outs.append(out[: out.shape[0] - pad] if pad else out)
    return np.concatenate(outs, axis=0)


def stream_config(cfg) -> Tuple[float, float, float, int]:
    """(window, hop, crossfade seconds, max windows per batch) of
    cfg['streaming']."""
    stream = cfg.get("streaming", {}) or {}
    return (float(stream.get("window_seconds", 3.0)), float(stream.get("hop_seconds", 1.0)),
            float(stream.get("crossfade_seconds", 0.25)),
            int(stream.get("max_batch_windows", 8)))


def stream_video_to_audio(frames: np.ndarray, *, cfg, model,
                          device: Device = "cuda") -> np.ndarray:
    """A long prompt [T, H, W, 3] uint8 -> stitched float32 audio."""
    win_s, hop_s, xfade_s, max_batch = stream_config(cfg)
    fps, sr = int(cfg["video"]["fps"]), int(cfg["audio"]["sr"])
    chunks, _, _ = split_frames_into_windows(frames, fps, win_s, hop_s)
    outs = sample_windows_batched(chunks, cfg=cfg, model=model, prompt_modality="video",
                                  max_batch=max_batch, device=device)
    return crossfade_audio(outs, sr=sr, hop=int(round(sr * hop_s)), win=int(round(sr * win_s)),
                           fade_s=xfade_s)


def stream_audio_to_video(wav: np.ndarray, *, cfg, model,
                          device: Device = "cuda") -> np.ndarray:
    """A long prompt [L] float32 -> stitched uint8 frames [T, H, W, 3]."""
    win_s, hop_s, xfade_s, max_batch = stream_config(cfg)
    fps, sr = int(cfg["video"]["fps"]), int(cfg["audio"]["sr"])
    chunks, _, _ = split_audio_into_windows(wav, sr, win_s, hop_s)
    outs = sample_windows_batched(chunks, cfg=cfg, model=model, prompt_modality="audio",
                                  max_batch=max_batch, device=device)
    return crossfade_video(outs, hop=int(round(fps * hop_s)), win=int(round(fps * win_s)),
                           fade_f=int(round(xfade_s * fps)))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Sliding-window AV generation with crossfade stitching."
    )
    ap.add_argument("--config", type=str, nargs="+", required=True)
    ap.add_argument("--frames", type=Path, default=None,
                    help="Prompt frames dir (for V->A)")
    ap.add_argument("--audio", type=Path, default=None,
                    help="Prompt audio wav (for A->V)")
    ap.add_argument("--out-dir", type=Path, default=Path("stream_out"))
    ap.add_argument("--save-mp4", type=Path, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; cuda raises when absent")
    add_checkpoint_args(ap)
    args = ap.parse_args(argv)

    from ..media.audio_io import read_wav, write_wav
    from ..media.video_io import load_frames_dir, write_frames

    cfg = config_with_checkpoint(load_config(*args.config), args.ckpt)
    prompt_modality = cfg.get("sampling", {}).get("prompt_modality", "video")
    model = build_components(cfg, device=args.device, use_ema=args.ema)
    args.out_dir.mkdir(parents=True, exist_ok=True)

    if prompt_modality == "video":
        if args.frames is None:
            raise SystemExit("Provide --frames for prompt_modality=video")
        H, W = (int(x) for x in cfg["video"]["size"])
        wav = stream_video_to_audio(load_frames_dir(args.frames, size_hw=(H, W)), cfg=cfg,
                                    model=model, device=args.device)
        wav_path = args.out_dir / "stream_audio.wav"
        write_wav(wav_path, wav, int(cfg["audio"]["sr"]))
        print(f"[ok] wrote {wav_path}")
    else:
        if args.audio is None:
            raise SystemExit("Provide --audio for prompt_modality=audio")
        wav_all, _ = read_wav(args.audio, sr=int(cfg["audio"]["sr"]))
        frames = stream_audio_to_video(wav_all, cfg=cfg, model=model, device=args.device)
        frames_dir = args.out_dir / "frames"
        write_frames(frames, frames_dir, mp4_path=args.save_mp4, fps=int(cfg["video"]["fps"]))
        print(f"[ok] wrote frames -> {frames_dir}")
        if args.save_mp4:
            print(f"[ok] wrote mp4 -> {args.save_mp4}")


if __name__ == "__main__":
    main()
