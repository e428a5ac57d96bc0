"""Text -> image sampling with CFG + negative prompts (counterpart of the JAX
``infer/sample_t2i.py``):

    python -m multimodal_diffusion_torch.infer.sample_t2i \
        --config configs/t2i_512.yaml --prompt "a red fox" \
        [--negative "blurry"] [--steps 50] [--guidance 5.0] [--out-dir DIR] [--device cpu]

A config with ``model.family: flux`` (``configs/flux_dev.yaml``) samples
FLUX.1 instead (``infer/sample_flux.py``): its text towers are not ported,
so it takes their outputs in place of ``--prompt``:

    python -m multimodal_diffusion_torch.infer.sample_t2i \
        --config configs/flux_dev.yaml --text-embeds embeds.npz [--steps 28] [--guidance 3.5]

(``embeds.npz``: ``t5`` [L, 4096] or [B, L, 4096], ``pooled`` [768] or
[B, 768]).

Runs on CUDA unless ``--device cpu`` (raises when CUDA is asked for and
absent). Weights come from the latest step under ``paths.ckpt_dir``: the
port's own checkpoint (``train/checkpoint.py``) or the JAX package's orbax
one (read by ``train/orbax_reader.py`` without orbax), told apart per step
directory; with neither, it samples with seeded random weights and says so.
Writes ``t2i_0000.png`` ... into ``--out-dir``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Union

import torch

from ..models.diffusion import init_weights
from ..models.latent_text2image import Text2ImageConfig, Text2ImageModel, sample_images
from ..train.checkpoint import cast_params_bf16
from ..utils.io import compute_dtype_from_config, load_config, resolve_device
from .sample_clip import latest_state_dict


def build_t2i(cfg: Dict, device: Union[str, torch.device] = "cuda",
              bf16_params: bool = False) -> Text2ImageModel:
    """The config's Text2ImageModel in eval mode on `device`, with the
    weights of the latest step under paths.ckpt_dir (``latest_state_dict``,
    strict), else a random init seeded by
    cfg['seed']; with `bf16_params` and bf16 compute, the fp32 weights cast
    to bf16 once (``cast_params_bf16``, as ``bench.py``'s t2i task does)."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = compute_dtype_from_config(cfg)
    model = Text2ImageModel(Text2ImageConfig.from_config(cfg, dtype=dtype))
    ckpt_dir = (cfg.get("paths", {}) or {}).get("ckpt_dir")
    sd = latest_state_dict(ckpt_dir) if ckpt_dir else None
    if sd is None:
        print("[info] no checkpoint; sampling with random weights")
        init_weights(model, torch.Generator().manual_seed(int(cfg.get("seed", 0))))
    else:
        model.load_state_dict(sd, strict=True)
    if bf16_params and dtype == torch.bfloat16:
        cast_params_bf16(model)
    return model.to(dev).eval()


def main(argv=None) -> List[Path]:
    ap = argparse.ArgumentParser(description="Text->image DDIM sampling w/ CFG")
    ap.add_argument("--config", type=str, nargs="+", required=True)
    ap.add_argument("--prompt", type=str, nargs="+", default=None)
    ap.add_argument("--text-embeds", type=Path, default=None,
                    help="a flux config's T5 and pooled CLIP embeddings (.npz)")
    ap.add_argument("--negative", type=str, nargs="*", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--guidance", type=float, default=None)
    ap.add_argument("--out-dir", type=Path, default=Path("t2i_samples"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if (args.device or "").lower() == "cpu" else "cuda")

    cfg = load_config(*args.config)
    if (cfg.get("model", {}) or {}).get("family") == "flux":
        imgs = sample_flux_cli(cfg, args, device)
    else:
        if not args.prompt:
            ap.error("--prompt is required")
        imgs = sample_t2i_cli(cfg, args, device)

    from PIL import Image

    args.out_dir.mkdir(parents=True, exist_ok=True)
    paths = [args.out_dir / f"t2i_{i:04d}.png" for i in range(len(imgs))]
    for path, im in zip(paths, imgs):
        Image.fromarray(im).save(path)
    print(f"[ok] wrote {len(imgs)} images -> {args.out_dir}")
    return paths


def sample_t2i_cli(cfg: Dict, args, device: torch.device):
    model = build_t2i(cfg, device)
    steps = args.steps or int(cfg["diffusion"]["image"].get("sampler_steps", 50))
    guidance = args.guidance if args.guidance is not None else float(
        cfg.get("sampling", {}).get("guidance_scale", 5.0))
    sampler = str(cfg.get("sampling", {}).get("sampler", "ddim"))
    return sample_images(model, args.prompt, negative=args.negative or None,
                         sampler_steps=steps, guidance_scale=guidance,
                         generator=torch.Generator(device=device).manual_seed(args.seed),
                         sampler=sampler)


def sample_flux_cli(cfg: Dict, args, device: torch.device):
    """FLUX.1 from --text-embeds, with the weights of the latest step under
    paths.ckpt_dir (the port's checkpoint, the published key names), else
    seeded random ones."""
    from .sample_flux import build_flux, load_text_embeds, sample_flux

    if args.text_embeds is None:
        raise SystemExit("a flux config samples from --text-embeds (its text towers "
                         "are not ported)")
    ckpt_dir = (cfg.get("paths", {}) or {}).get("ckpt_dir")
    sd = latest_state_dict(ckpt_dir) if ckpt_dir else None
    if sd is None:
        print("[info] no checkpoint; sampling with random weights")
    else:  # served in the compute dtype, as cast_params_bf16 leaves a model
        sd = {k: v.to(device, compute_dtype_from_config(cfg)) for k, v in sd.items()}
    model, ae = build_flux(cfg, device, sd, seed=int(cfg.get("seed", 0)))
    t5, pooled = load_text_embeds(args.text_embeds)
    return sample_flux(cfg, model, ae, t5, pooled, device,
                       torch.Generator().manual_seed(args.seed), steps=args.steps,
                       guidance=args.guidance)["image"]


if __name__ == "__main__":
    main()
