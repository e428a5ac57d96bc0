"""Sample images from a pixel-space DDPM (counterpart of the JAX package's
``infer/sample_pixel.py``):

    python -m multimodal_diffusion_torch.infer.sample_pixel \\
        --config configs/pixel32.yaml --num 16 --out-dir samples/ [--seed 0] [--device cpu]

Runs the full ancestral sampler (``diffusion.image.steps`` steps, one eager
denoiser forward each) on CUDA unless ``--device cpu`` (raises when CUDA is
asked for and absent). Weights come from the latest step under
``paths.ckpt_dir``: the port's checkpoint (``train/train_pixel.py`` writes
them) or the JAX package's orbax one (read by ``train/orbax_reader.py``
without orbax), told apart per step directory; with neither it samples with
seeded random weights and says so, as the JAX package does. Writes
``sample_0000.png`` ... into ``--out-dir``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np
import torch

from ..models.diffusion import init_weights
from ..models.image_diffusion import PixelDiT, PixelDiTConfig, make_ancestral_sampler
from ..models.latent_text2image import images_to_uint8
from ..utils.io import compute_dtype_from_config, load_config, resolve_device
from .sample_clip import latest_state_dict


def build_pixel(cfg, device: Union[str, torch.device] = "cuda") -> PixelDiT:
    """The config's PixelDiT in eval mode on `device` with the weights of the
    latest step under paths.ckpt_dir (either format, strict), else a random
    init seeded by cfg['seed']."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = PixelDiT(PixelDiTConfig.from_config(cfg, dtype=compute_dtype_from_config(cfg)))
    ckpt_dir = Path(cfg["paths"]["ckpt_dir"])
    sd = latest_state_dict(ckpt_dir)
    if sd is None:  # the JAX package's two messages
        print("[warn] no checkpoints; random weights" if ckpt_dir.exists()
              else "[info] no ckpt dir; random weights")
        init_weights(model, torch.Generator().manual_seed(int(cfg.get("seed", 0))))
    else:
        model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()


def sample_pixel_images(model: PixelDiT, num: int, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """`num` images from the ancestral sampler, drawn from a generator on
    the model's device seeded with `seed`: (fp32 [N, C, H, W] in [-1, 1],
    uint8 [N, H, W, C])."""
    dev = next(model.parameters()).device
    imgs = make_ancestral_sampler(model)(num, torch.Generator(device=dev).manual_seed(seed))
    return imgs.float().cpu().numpy(), images_to_uint8(imgs)


def main(argv=None) -> List[Path]:
    ap = argparse.ArgumentParser(description="Pixel DDPM ancestral sampling")
    ap.add_argument("--config", type=str, nargs="+", required=True)
    ap.add_argument("--num", type=int, default=16)
    ap.add_argument("--out-dir", type=Path, default=Path("pixel_samples"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if (args.device or "").lower() == "cpu" else "cuda")

    cfg = load_config(*args.config)
    model = build_pixel(cfg, device)
    _, imgs_u8 = sample_pixel_images(model, args.num, args.seed)

    from PIL import Image

    args.out_dir.mkdir(parents=True, exist_ok=True)
    paths: List[Path] = []
    for i, im in enumerate(imgs_u8):
        paths.append(args.out_dir / f"sample_{i:04d}.png")
        Image.fromarray(im.squeeze() if im.shape[-1] == 1 else im).save(paths[-1])
    print(f"[ok] wrote {len(imgs_u8)} images -> {args.out_dir}")
    return paths


if __name__ == "__main__":
    main()
