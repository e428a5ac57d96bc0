"""Image patch tokens (counterpart of the JAX ``models/image_diffusion.py``'s
``patch_image`` / ``unpatch_image``): the 2-D case of tube patching, shared
by the latent text->image and text->audio mel families. The pixel DiT of
that module is not ported yet."""

from __future__ import annotations

import torch

from ..ops.tokenize import tube_patch_video, tube_unpatch_video


def patch_image(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)(W/p), C*p*p] (2-D case of tube patching)."""
    return tube_patch_video(x[:, :, None], 1, p, p)


def unpatch_image(tok: torch.Tensor, C: int, H: int, W: int, p: int) -> torch.Tensor:
    """Inverse of patch_image: [B, (H/p)(W/p), C*p*p] -> [B, C, H, W]."""
    return tube_unpatch_video(tok, C, 1, H, W, 1, p, p)[:, :, 0]
