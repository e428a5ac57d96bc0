"""Convert a clips.json manifest into `.avrec` record shards, the input that
``data.records_dir`` points the trainer at (counterpart of the repo's
``tools/build_records.py``, through the port's own modules).

    python -m multimodal_diffusion_torch.tools.build_records \\
        --config configs/mvp.yaml [overlay.yaml ...] [--out DIR] \\
        [--clips-per-shard 256] [--limit N]

Decodes every clip of ``data.train_split_glob`` once (the native loader when
it builds, else PIL) into uint8 [T, H, W, 3] frames and float32 waveforms of
the config's clip length, size, fps and sample rate. The shards go to
`--out` (default: a ``records`` directory beside the manifest). A clip that
fails to decode is skipped and named.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..datasets.av_manifest import AVClipsDataset
from ..datasets.records import write_record_shards
from ..utils.io import load_config


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=str, nargs="+", required=True)
    ap.add_argument("--out", type=Path, default=None,
                    help="output dir (default: <manifest dir>/records)")
    ap.add_argument("--clips-per-shard", type=int, default=256)
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)

    cfg = load_config(*args.config)
    manifest = cfg["data"]["train_split_glob"]
    ds = AVClipsDataset(
        manifest_path=manifest,
        clip_seconds=float(cfg["data"]["clip_seconds"]),
        fps=int(cfg["video"]["fps"]),
        sr=int(cfg["audio"]["sr"]),
        size_hw=tuple(cfg["video"]["size"]),
        video_root=cfg.get("paths", {}).get("video_root"),
        audio_root=cfg.get("paths", {}).get("audio_root"),
        device_preprocess=True,  # records store uint8 [T, H, W, 3]
    )
    n = len(ds) if args.limit is None else min(len(ds), args.limit)
    out = args.out or (Path(manifest).parent / "records")
    H, W = (int(x) for x in cfg["video"]["size"])
    t0 = time.time()

    def items():
        for i in range(n):
            try:
                it = ds[i]
            except Exception as e:
                print(f"[skip] clip {i}: {e}")
                continue
            a = it.get("audio")
            yield {"video": it.get("video"),
                   "audio": None if a is None else np.asarray(a).reshape(-1)}
            if (i + 1) % 50 == 0:
                print(f"[build] {i + 1}/{n} clips ({(i + 1) / (time.time() - t0):.1f} clips/s)")

    paths = write_record_shards(
        items(), out, video_shape=(ds.T, H, W, 3), audio_shape=(ds.L,),
        clips_per_shard=args.clips_per_shard,
        fps=int(cfg["video"]["fps"]), sr=int(cfg["audio"]["sr"]))
    print(f"[done] {n} clips -> {len(paths)} shards in {out} ({time.time() - t0:.1f}s)")
    return paths


if __name__ == "__main__":
    main()
