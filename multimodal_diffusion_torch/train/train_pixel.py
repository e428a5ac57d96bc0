"""Unconditional pixel-space DDPM training on one CUDA card (counterpart of
the JAX package's ``train/train_pixel.py``).

    python -m multimodal_diffusion_torch.train.train_pixel \\
        --config configs/pixel32.yaml [overlay.yaml ...] [--max-steps N] [--device cpu]

Trains PixelDiT on the directory of images ``data.train_images``: each is
center-cropped and resized to ``image.size`` and scaled to [-1, 1] on the
host (a folder of JPEGs only decodes through the native loader). Compute in
``mixed_precision``'s dtype with fp32 parameters, the config's AdamW.
Metrics (the loss, steps/s and images/s of the interval, host decode
included) go to ``paths.log_dir`` every ``training.log_every`` steps; the
port's checkpoints (step and params) to ``paths.ckpt_dir`` every
``training.ckpt_every`` steps and at the end. Runs on CUDA unless
``--device cpu``, and raises without a card.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Iterator, List

import numpy as np
import torch

from ..models.diffusion import init_weights
from ..models.image_diffusion import PixelDiT, PixelDiTConfig, make_pixel_train_step
from ..utils.io import compute_dtype_from_config, load_config, resolve_device
from .checkpoint import CheckpointManager
from .metrics import MetricWriter
from .trainer import make_optimizer

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def iter_image_batches(root, size: int, batch: int, seed: int = 0) -> Iterator[np.ndarray]:
    """Infinite stream of [B, C, size, size] float32 in [-1, 1]: a
    ``np.random.default_rng(seed)`` permutation of the sorted image paths
    each epoch, full batches only. When every file is a JPEG and the native
    loader is available, one threaded call decodes a batch (a plain resize:
    the images are taken to be square); otherwise PIL center-crops to a
    square and resizes bilinearly."""
    paths: List[Path] = sorted(p for p in Path(root).rglob("*")
                               if p.suffix.lower() in _IMG_EXTS)
    if not paths:
        raise FileNotFoundError(f"no images under {root}")
    native = None
    if all(p.suffix.lower() in (".jpg", ".jpeg") for p in paths):
        from ..datasets import native_loader

        if native_loader.available():
            native = native_loader

    rng = np.random.default_rng(seed)
    while True:
        idx = rng.permutation(len(paths))
        for i in range(0, len(idx) - batch + 1, batch):
            sel = [paths[j] for j in idx[i:i + batch]]
            if native is not None:
                u8 = native.decode_clip_u8(sel, size, size)  # [B, H, W, 3]
                yield (u8.astype(np.float32) / 127.5 - 1.0).transpose(0, 3, 1, 2)
                continue
            from PIL import Image

            imgs = []
            for p in sel:
                im = Image.open(p).convert("RGB")
                w, h = im.size
                s = min(w, h)
                im = im.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
                im = im.resize((size, size), Image.BILINEAR)
                imgs.append(np.asarray(im, np.float32) / 127.5 - 1.0)
            yield np.stack(imgs).transpose(0, 3, 1, 2)


def build_pixel_model(cfg, device) -> PixelDiT:
    """The config's PixelDiT on `device` in its compute dtype (fp32
    parameters), seeded random init from cfg['seed']."""
    model = PixelDiT(PixelDiTConfig.from_config(cfg, dtype=compute_dtype_from_config(cfg)))
    init_weights(model, torch.Generator().manual_seed(int(cfg.get("seed", 0))))
    return model.to(device)


def main(argv=None) -> int:
    """Returns the number of steps taken."""
    ap = argparse.ArgumentParser(description="Unconditional pixel DDPM training")
    ap.add_argument("--config", type=str, nargs="+", required=True)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--device", type=str, default=None)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if (args.device or "").lower() == "cpu" else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = load_config(*args.config)
    model = build_pixel_model(cfg, device)
    mcfg = model.cfg
    B = int(cfg["data"]["batch_size"])
    seed = int(cfg.get("seed", 0))
    optimizer = make_optimizer(cfg, list(model.named_parameters()))
    step_fn = make_pixel_train_step(model, optimizer,
                                    torch.Generator(device=device).manual_seed(seed + 1))

    writer = MetricWriter(cfg["paths"]["log_dir"])
    ckpt = CheckpointManager(cfg["paths"]["ckpt_dir"])
    max_steps = args.max_steps or int(cfg["training"]["max_steps"])
    log_every = int(cfg["training"].get("log_every", 100))
    ckpt_every = int(cfg["training"].get("ckpt_every", 5000))

    def params():
        return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}

    batches = iter_image_batches(cfg["data"]["train_images"], mcfg.image_size, B, seed=seed)
    step = logged = 0
    t_last = time.perf_counter()
    for batch in batches:
        if step >= max_steps:
            break
        images = torch.from_numpy(batch).pin_memory() if device.type == "cuda" else \
            torch.from_numpy(batch)
        loss = step_fn(images.to(device, non_blocking=True))
        step += 1
        if step % log_every == 0:
            value = float(loss)  # waits for the step
            now = time.perf_counter()
            dt = (now - t_last) / (step - logged)
            t_last, logged = now, step
            writer.write(step, {"loss": value, "steps_per_sec": 1.0 / dt,
                                "images_per_sec": B / dt})
            print(f"step {step}: loss={value:.4f}", flush=True)
        if step % ckpt_every == 0:
            ckpt.save(step, {"step": step, "params": params()})
    ckpt.save(step, {"step": step, "params": params()}, wait=True)
    ckpt.close()
    writer.close()
    print(f"[done] step {step}", flush=True)
    return step


if __name__ == "__main__":
    main()
