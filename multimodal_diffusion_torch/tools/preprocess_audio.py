"""Audio preprocessing for the AV corpus: raw audio (``.wav``, or the GRID
corpus's ``.mpg`` clips) -> mono WAVs at one rate, or log-mel ``.npz`` files
(counterpart of the repo root's ``scripts/preprocess_audio.py``, whose flags
and outputs it keeps, byte for byte):

    python -m multimodal_diffusion_torch.tools.preprocess_audio \
        --input data/audio/raw --output data/audio/wav16k --mode wav --sr 16000 [--rms-norm]
    python -m multimodal_diffusion_torch.tools.preprocess_audio \
        --input data/audio/wav16k --output data/audio/mel --mode mel --sr 16000 \
        --n-mels 80 [--align-to data/video/frames/x/clips.json]

  --mode wav: resample every file under --input to mono --sr WAVs under
              --output (same relative paths; --rms-norm scales each to
              -23 dBFS RMS): the input of ``tools/build_records.py``.
  --mode mel: one log-mel .npz per file, or with --align-to one per clip
              window of that video manifest (clip i covers
              [i, i + 1) x clip_seconds), and mel_manifest.json.

MPEG program streams (.mpg, .mpeg, .m2v) are demuxed and their MP2 audio
decoded by ``media/mpeg_audio.py`` (the ffmpeg libraries that opencv-python
bundles), which raises where ``mpeg_audio.available()`` is False. Host-only:
no device is involved, so there is no ``--device``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..media.audio_io import logmel, read_wav, rms_normalize, write_wav

AUDIO_EXTS = {".wav", ".flac", ".mp3", ".ogg", ".m4a"}
MPEG_EXTS = {".mpg", ".mpeg", ".m2v"}


def iter_audio(root: Path):
    if root.is_file():
        yield root
    else:
        yield from sorted(p for p in root.rglob("*")
                          if p.suffix.lower() in (AUDIO_EXTS | MPEG_EXTS))


def read_any(src: Path, sr: int):
    """(mono float32 samples at `sr`, sr) of a WAV or an MPEG program
    stream."""
    if src.suffix.lower() in MPEG_EXTS:
        from ..media.mpeg_audio import read_mpeg_audio

        return read_mpeg_audio(src, sr=sr, mono=True)
    return read_wav(src, sr=sr, mono=True)


def mode_wav(args) -> None:
    n = 0
    for src in iter_audio(args.input):
        y, _ = read_any(src, args.sr)
        if args.rms_norm:
            y = rms_normalize(y)
        rel = src.relative_to(args.input) if not args.input.is_file() else src.name
        write_wav((args.output / rel).with_suffix(".wav"), y, args.sr)
        n += 1
    print(f"[done] wrote {n} wavs -> {args.output}")


def _save_mel(dst: Path, y: np.ndarray, args) -> None:
    M = logmel(y, args.sr, n_fft=args.n_fft, hop=args.hop, n_mels=args.n_mels,
               fmin=args.fmin, fmax=args.fmax)
    dst.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(dst, logmel=M, sr=args.sr)


def mode_mel(args) -> None:
    align = None
    if args.align_to:
        align = json.loads(Path(args.align_to).read_text())["clips"]
    entries = []
    for src in iter_audio(args.input):
        y, _ = read_any(src, args.sr)
        if align is None:
            dst = args.output / f"{src.stem}.npz"
            _save_mel(dst, y, args)
            entries.append({"mel_path": str(dst), "source_audio": str(src)})
            continue
        # window the audio to each aligned video clip
        for ci, clip in enumerate(align):
            secs = float(clip.get("clip_seconds", args.clip_seconds))
            a = int(round(ci * secs * args.sr))
            b = a + int(round(secs * args.sr))
            seg = y[a:b]
            if len(seg) == 0:
                break
            if len(seg) < b - a:
                seg = np.pad(seg, (0, (b - a) - len(seg)))
            dst = args.output / f"{src.stem}_clip_{ci:04d}.npz"
            _save_mel(dst, seg, args)
            entries.append({"mel_path": str(dst), "clip_index": ci, "source_audio": str(src)})
    (args.output / "mel_manifest.json").write_text(json.dumps({"clips": entries}, indent=2))
    print(f"[done] wrote {len(entries)} mel npz -> {args.output}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Audio preprocessing (wav | mel).")
    ap.add_argument("--input", "--in", dest="input", type=Path, default=None)
    ap.add_argument("--output", "--out", dest="output", type=Path, default=None)
    # the reference implementation's spellings
    ap.add_argument("--input_path", dest="input_alias", type=Path, default=None)
    ap.add_argument("--output_dir", dest="output_alias", type=Path, default=None)
    ap.add_argument("--mode", type=str, default="wav", choices=["wav", "mel"])
    ap.add_argument("--sr", type=int, default=16000)
    ap.add_argument("--rms-norm", "--norm-rms", dest="rms_norm", action="store_true")
    ap.add_argument("--n-mels", type=int, default=80)
    ap.add_argument("--n-fft", type=int, default=1024)
    ap.add_argument("--hop", "--hop-length", dest="hop", type=int, default=256)
    ap.add_argument("--fmin", type=float, default=0.0)
    ap.add_argument("--fmax", type=float, default=None)
    ap.add_argument("--clip-seconds", type=float, default=3.0)
    ap.add_argument("--align-to", type=Path, default=None,
                    help="Video clips.json to window the audio against")
    args = ap.parse_args(argv)
    args.input = args.input or args.input_alias
    args.output = args.output or args.output_alias
    if args.input is None or args.output is None:
        ap.error("supply --input/--output (or --input_path/--output_dir)")
    args.output.mkdir(parents=True, exist_ok=True)
    (mode_wav if args.mode == "wav" else mode_mel)(args)


if __name__ == "__main__":
    main()
