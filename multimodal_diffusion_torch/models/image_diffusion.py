"""Pixel-space image diffusion: a DiT over patch tokens (counterpart of the
JAX ``models/image_diffusion.py``), the unconditional 32x32 DDPM family with
its 1000-step ancestral sampler.

``patch_image`` / ``unpatch_image`` are also the 2-D tube patching of the
latent text->image and text->audio mel families.

Randomness is explicit: the train step takes its draws (timesteps and noise)
from ``draw_pixel_randomness`` or the caller, and the sampler takes x_T and
the per-step noise as tensors or draws them from a ``torch.Generator``, so a
test can hand the JAX package's draws to both. The JAX sampler is one
``lax.scan``; this one is a Python loop of eager launches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops import schedule as S
from ..ops.tokenize import tube_patch_video, tube_unpatch_video
from .adapters import LinearAdapter, PositionalEmbedding1D
from .heads import NoisePredictionHead
from .mmdit import MMDiT, MMDiTConfig, set_dropout_generator


def patch_image(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)(W/p), C*p*p] (2-D case of tube patching)."""
    return tube_patch_video(x[:, :, None], 1, p, p)


def unpatch_image(tok: torch.Tensor, C: int, H: int, W: int, p: int) -> torch.Tensor:
    """Inverse of patch_image: [B, (H/p)(W/p), C*p*p] -> [B, C, H, W]."""
    return tube_unpatch_video(tok, C, 1, H, W, 1, p, p)[:, :, 0]


@dataclasses.dataclass(frozen=True)
class PixelDiTConfig:
    image_size: int = 32
    channels: int = 3
    patch: int = 4
    width: int = 192
    core: MMDiTConfig = dataclasses.field(
        default_factory=lambda: MMDiTConfig(d_model=192, n_layers=6, n_heads=6,
                                            mlp_ratio=4.0, dropout=0.0))
    steps: int = 1000
    schedule: str = "cosine"
    min_beta: float = 1e-4
    max_beta: float = 2e-2
    dtype: Any = torch.float32

    @classmethod
    def from_config(cls, cfg: Dict, dtype: Any = torch.float32) -> "PixelDiTConfig":
        img = cfg.get("image", {})
        core = MMDiTConfig.from_dict(cfg["model"]["core"], dtype=dtype)
        diff = cfg["diffusion"]["image"]
        return cls(
            image_size=int(img.get("size", 32)),
            channels=int(img.get("channels", 3)),
            patch=int(cfg["tokenizer"]["image"]["patch"]),
            width=core.d_model,
            core=core,
            steps=int(diff["steps"]),
            schedule=str(diff.get("schedule", "cosine")),
            min_beta=float(diff.get("min_beta", 1e-4)),
            max_beta=float(diff.get("max_beta", 2e-2)),
            dtype=dtype,
        )

    @property
    def n_tokens(self) -> int:
        return (self.image_size // self.patch) ** 2

    @property
    def token_dim(self) -> int:
        return self.channels * self.patch * self.patch

    @property
    def image_shape(self) -> tuple:
        return (self.channels, self.image_size, self.image_size)


def pixel_schedule(c: PixelDiTConfig):
    """(betas, alpha_bar) of the config's training schedule, fp32 numpy."""
    betas = S.make_beta_schedule(c.steps, c.schedule, c.min_beta, c.max_beta)
    return betas, S.alphas_cumprod_from_betas(betas)[1]


class PixelDiT(nn.Module):
    """Unconditional epsilon-predictor over pixel patches: LinearAdapter +
    learned positions + the timestep embedding -> MMDiT -> a 2-layer
    NoisePredictionHead."""

    def __init__(self, cfg: PixelDiTConfig):
        super().__init__()
        self.cfg = c = cfg
        self.adapter = LinearAdapter(c.token_dim, c.width, c.dtype)
        self.pos = PositionalEmbedding1D(c.width, max_len=c.n_tokens, mode="learned",
                                         dtype=c.dtype)
        self.core = MMDiT(c.core)
        self.head = NoisePredictionHead(c.core.d_model, c.token_dim, hidden_dim=c.width,
                                        num_layers=2, dtype=c.dtype)

    def forward(self, x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x_t [B, C, H, W] noisy image, t [B] -> eps_hat [B, C, H, W] (in the
        compute dtype)."""
        c = self.cfg
        tok = patch_image(x_t, c.patch)
        h = self.adapter(tok) + self.pos(tok.shape[1], tok.device)
        h = h + S.timestep_embedding(t, c.width).to(h.dtype)[:, None, :]
        h = self.core(h)
        return unpatch_image(self.head(h), c.channels, c.image_size, c.image_size, c.patch)


# ---------------------------------------------------------------------------
# training + sampling
# ---------------------------------------------------------------------------


def draw_pixel_randomness(generator: torch.Generator, c: PixelDiTConfig,
                          batch: int) -> Dict[str, torch.Tensor]:
    """One step's draws on the generator's device: t [B] uniform in
    [0, steps) and the noise [B, C, H, W] fp32."""
    dev = generator.device
    return {"t": torch.randint(0, c.steps, (batch,), generator=generator, device=dev),
            "noise": torch.randn((batch,) + c.image_shape, generator=generator, device=dev)}


def pixel_loss(model: PixelDiT, images: torch.Tensor, draws: Dict[str, torch.Tensor],
               alpha_bar: torch.Tensor) -> torch.Tensor:
    """mean((eps_hat - eps)^2) in fp32 at x_t = q_sample(images, t, noise)."""
    x_t, eps = S.q_sample(images, draws["t"], alpha_bar, draws["noise"])
    eps_hat = model(x_t, draws["t"])
    return torch.mean(torch.square(eps_hat.float() - eps.float()))


def make_pixel_train_step(model: PixelDiT, optimizer,
                          generator: Optional[torch.Generator] = None):
    """step(images [B, C, H, W] in [-1, 1], draws=None) -> loss: one step of
    `optimizer` (``train/trainer.py::AdamW`` over ``model.named_parameters()``,
    e.g. ``make_optimizer(cfg, ...)``) on the gradient of the epsilon MSE
    w.r.t. every parameter. The draws come from `generator` (on the model's
    device, seed 0 by default) unless given; dropout draws from it too."""
    c = model.cfg
    dev = next(model.parameters()).device
    abar = torch.as_tensor(pixel_schedule(c)[1], device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    set_dropout_generator(model, generator)

    def step(images: torch.Tensor, draws: Optional[Dict[str, torch.Tensor]] = None
             ) -> torch.Tensor:
        model.train()
        images = images.to(dev)
        if draws is None:
            draws = draw_pixel_randomness(generator, c, images.shape[0])
        loss = pixel_loss(model, images, draws, abar)
        grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True)
        optimizer.step(grads)
        return loss.detach()

    return step


def make_ancestral_sampler(model: PixelDiT):
    """The full ancestral DDPM sampler: sample(batch_size, generator=None, *,
    x_T=None, z=None) -> images [B, C, H, W] fp32 in
    [-1, 1]. x_T ~ N(0, 1), then for t = T-1 ... 0 one model forward and
    ``ddpm_step`` with clip_x0=(-1, 1), a final clip. x_T [B, C, H, W] and z
    [T, B, C, H, W] (z[i] is the noise of the i-th step, t = T-1-i) are
    drawn from `generator` in that order unless given."""
    c = model.cfg
    betas_np, abar_np = pixel_schedule(c)

    @torch.inference_mode()
    def sample(batch_size: int, generator: Optional[torch.Generator] = None, *,
               x_T: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        dev = next(model.parameters()).device
        model.eval()
        betas = torch.as_tensor(betas_np, device=dev)
        abar = torch.as_tensor(abar_np, device=dev)
        shape = (batch_size,) + c.image_shape
        if (x_T is None or z is None) and generator is None:
            raise ValueError("make_ancestral_sampler: pass a generator or both x_T and z")
        x = (torch.randn(shape, generator=generator, device=dev) if x_T is None
             else x_T.to(dev, torch.float32))
        for i, t in enumerate(range(c.steps - 1, -1, -1)):
            tb = torch.full((batch_size,), t, dtype=torch.long, device=dev)
            eps_hat = model(x, tb)
            zi = (torch.randn(shape, generator=generator, device=dev) if z is None
                  else z[i].to(dev))
            x = S.ddpm_step(x, tb, eps_hat, betas, abar, zi, clip_x0=(-1.0, 1.0))
        return torch.clamp(x, -1.0, 1.0)

    return sample
