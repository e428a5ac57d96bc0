"""Seeded model weights drawn tensor by tensor on the device, for models
whose float32 draw in one piece (``weights.py``) would not fit beside them:
FLUX.1-dev's 11.9 G parameters are 48 GB as one float32 draw and 95 GB with
its uniforms.

The recipe is ``weights.py``'s: every matrix and convolution kernel
N(0, 1 / fan-in), every normalisation scale 1 + N(0, 0.02) with one channel
in 32 (drawn from the seed) scaled by 8, every other tensor N(0, 0.02). Each
tensor is drawn in float32 from one generator on the device, in the order of
`shapes`, and rounded once to the type the model is served in; only the norm
scales draw the uniforms that pick their outlier channels. The numbers are
not ``weights.py``'s for the same seed, the distributions are.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from benchmark.weights import OUTLIER_EVERY, OUTLIER_GAIN, std_of


def make_weights_by_tensor(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
                           is_norm_scale: Callable[[str], bool],
                           dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        w.mul_(std_of(name, shape))
        if is_norm_scale(name):
            pick = torch.rand(shape, generator=gen, device=device)
            w.add_(1.0).mul_(torch.where(pick < 1.0 / OUTLIER_EVERY, OUTLIER_GAIN, 1.0))
        out[name] = w.to(dtype)
    return out
