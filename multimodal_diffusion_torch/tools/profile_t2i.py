"""Where the device time of one text->image batch of configs/t2i_512.yaml
goes, on one CUDA card.

    python -m multimodal_diffusion_torch.tools.profile_t2i [--batch 8] [--steps 50]
        [--sampler ddim|dpmpp_2m] [--quant none|int8] [--bf16-params]

This is configs/t2i_512.yaml's 16-layer core, not the root ``bench.py``'s
t2i row: that row hard-codes an 8-layer core, and its port is
``tools/bench.py --task t2i [--serving]``. (`--sampler dpmpp_2m --steps 12
--quant int8 --bf16-params` applies the ``--serving`` levers to the
16-layer config.)

Builds configs/t2i_512.yaml at full width (512x512 images, 4x64x64 latents,
text d=256 4 layers, core d=512 16 layers 4 heads of 128, 77 + 1024 tokens
padded to 1152; bf16 compute) with every parameter N(0, 0.02) from a seed,
written as a checkpoint and restored through the CLI's weight path
(``infer/sample_t2i.py::build_t2i``); samples B prompts with a real negative
prompt, guidance 5.0. Runs one batch to warm up, times one, then profiles
one under torch.profiler, and prints one JSON line: images/s of the timed
batch, the profiled batch's wall time, the device's busy time in it (sum of
the CUDA kernels' self time), the idle share 1 - busy / wall, its kernel
launches, the flash kernels' device time and share of the busy time, and
the kernels with the most device time; under `--quant int8` also the device
time of the activation-quantize passes, the int8 products and their rescale.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..infer.sample_t2i import build_t2i
from ..models.latent_text2image import Text2ImageConfig, Text2ImageModel, sample_images
from ..train.checkpoint import CheckpointManager
from ..utils.io import load_config
from .profile_v2a import profile_batch

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "t2i_512.yaml"
PROMPTS = ["a red fox in the snow", "a lighthouse at dusk, oil painting",
           "a bowl of ramen, studio photo", "an astronaut riding a horse",
           "a watercolor of a mountain lake", "a city street in the rain at night",
           "a close-up of a honeybee on a flower", "a cat wearing a tiny hat"]
NEGATIVE = "blurry, low quality, watermark, text"


def random_t2i_checkpoint(cfg: dict, ckpt_dir, seed: int = 0) -> None:
    """Write a port checkpoint (step 0) of cfg's Text2ImageModel with every
    parameter N(0, 0.02) from `seed` (as bench.py makes them) into ckpt_dir."""
    model = Text2ImageModel(Text2ImageConfig.from_config(cfg))
    gen = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(v.shape, generator=gen) * 0.02 for k, v in model.state_dict().items()}
    CheckpointManager(ckpt_dir).save(0, {"params": sd})


def t2i_workload(batch: int = 8, steps: int = 50, seed: int = 0, ckpt_dir=None,
                 quant: str = "none", bf16_params: bool = False):
    """(cfg, model, run): configs/t2i_512.yaml's model with model.core.quant
    `quant` on the card with the weights of ``random_t2i_checkpoint`` read
    back from `ckpt_dir` (a new temporary directory when None; cast to bf16
    once with `bf16_params`), and run(negative=NEGATIVE, sampler="ddim")
    that samples `batch` prompts (uint8 [B, 512, 512, 3]) and waits for the
    card."""
    cfg = load_config(CONFIG)
    cfg["diffusion"]["image"]["sampler_steps"] = steps
    cfg["model"]["core"]["quant"] = quant
    tmp = None
    if ckpt_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="t2i_ckpt_")
        ckpt_dir = tmp.name
    cfg["paths"]["ckpt_dir"] = str(ckpt_dir)
    random_t2i_checkpoint(cfg, ckpt_dir, seed)
    model = build_t2i(cfg, device="cuda", bf16_params=bf16_params)
    if tmp is not None:
        tmp.cleanup()
    prompts = (PROMPTS * (batch // len(PROMPTS) + 1))[:batch]
    guidance = float(cfg["sampling"]["guidance_scale"])

    def run(negative=NEGATIVE, sampler: str = "ddim"):
        out = sample_images(model, prompts, None if negative is None else [negative] * batch,
                            sampler_steps=steps, guidance_scale=guidance, sampler=sampler,
                            generator=torch.Generator(device="cuda").manual_seed(seed + 1))
        torch.cuda.synchronize()
        return out

    return cfg, model, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--sampler", choices=("ddim", "dpmpp_2m"), default="ddim")
    ap.add_argument("--quant", choices=("none", "int8"), default="none")
    ap.add_argument("--bf16-params", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this tool profiles the card")
    _, _, sample = t2i_workload(args.batch, args.steps, quant=args.quant,
                                bf16_params=args.bf16_params)

    def run():
        return sample(sampler=args.sampler)

    run()  # warm-up: kernel build, cuDNN plans, allocator
    t0 = time.perf_counter()
    run()
    batch_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    prof = profile_batch(run)
    print(json.dumps({"phase": "profile_t2i", "config": "t2i_512", "batch": args.batch,
                      "steps": args.steps, "sampler": args.sampler, "quant": args.quant,
                      "bf16_params": args.bf16_params, "nvidia_smi": smi,
                      "batch_s": batch_s, "images_per_s": args.batch / batch_s,
                      "flash_share_of_busy": prof["flash_kernels_device_ms"] / 1e3
                      / prof["device_busy_s"], **prof}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
