"""Seeded model weights, made on the device in one draw.

Every matrix and convolution kernel is N(0, 1 / fan-in), every other tensor
(biases, embedding and position tables) N(0, 0.02), and every normalisation
scale 1 + N(0, 0.02), with one channel in 32 (drawn from the seed) scaled by
8: the outlier channels of trained transformers, which set the step of an
8-bit activation quantizer. All of it is one flat float32 draw from a
generator on the device, rounded once to the type the model is served in and
cut into the named tensors of the reference's layout
(``reference/av_sampling.py::param_shapes``). The program loads them by
name; the reference reads the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference.av_sampling import is_norm_scale

STD = 0.02
OUTLIER_EVERY = 32
OUTLIER_GAIN = 8.0


def std_of(name: str, shape: Tuple[int, ...]) -> float:
    if len(shape) >= 2 and not name.endswith("table"):
        return 1.0 / math.sqrt(math.prod(shape[1:]))
    return STD


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
                 dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    pick = torch.rand(sum(sizes), generator=gen, device=device)
    for (name, shape), part, u in zip(shapes.items(), torch.split(flat, sizes),
                                      torch.split(pick, sizes)):
        part.mul_(std_of(name, shape))
        if is_norm_scale(name):
            part.add_(1.0).mul_(torch.where(u < 1.0 / OUTLIER_EVERY, OUTLIER_GAIN, 1.0))
    flat = flat.to(dtype)
    return {name: part.view(shape) for (name, shape), part
            in zip(shapes.items(), torch.split(flat, sizes))}
