"""Text -> image latent diffusion with classifier-free guidance (counterpart
of the JAX ``models/latent_text2image.py``).

Text tokens from the byte-level encoder are concatenated with the
image-latent patch tokens in ONE MMDiT sequence (pad text keys masked; the
core pads the sequence to ``seq_multiple`` with masked keys). Sampling runs
the cond and negative branches stacked on the batch axis, one denoiser
forward per step: eps = eps_neg + g (eps_cond - eps_neg), eps_neg from the
negative prompt's tokens (empty text when none is given).

Randomness is explicit: the sampler takes ``z_init`` (else draws it from a
``torch.Generator``), the train step takes its draws from
``draw_t2i_randomness`` (or the caller's), so a test can hand the JAX
package's draws to both.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops import schedule as S
from .adapters import LinearAdapter, PositionalEmbedding1D
from .heads import NoisePredictionHead
from .image_diffusion import patch_image, unpatch_image
from .mmdit import MMDiT, MMDiTConfig, set_dropout_generator
from .text_encoder import PAD_ID, TextEncoder, TextEncoderConfig, tokenize_text
from .vae_image2d import ImageVAE, ImageVAEConfig


@dataclasses.dataclass(frozen=True)
class Text2ImageConfig:
    image_size: int = 256
    patch: int = 2
    width: int = 512
    vae: ImageVAEConfig = dataclasses.field(
        default_factory=lambda: ImageVAEConfig(lat_ch=4, down=8))
    text: TextEncoderConfig = dataclasses.field(default_factory=TextEncoderConfig)
    core: MMDiTConfig = dataclasses.field(
        default_factory=lambda: MMDiTConfig(d_model=512, n_layers=8, n_heads=8, dropout=0.0))
    steps: int = 1000
    schedule: str = "cosine"
    min_beta: float = 1e-4
    max_beta: float = 2e-2
    dtype: Any = torch.float32

    @property
    def latent_hw(self) -> int:
        return self.image_size // self.vae.down

    @property
    def n_img_tokens(self) -> int:
        return (self.latent_hw // self.patch) ** 2

    @property
    def token_dim(self) -> int:
        return self.vae.lat_ch * self.patch * self.patch

    @property
    def latent_shape(self) -> tuple:
        return (self.vae.lat_ch, self.latent_hw, self.latent_hw)

    @classmethod
    def from_config(cls, cfg: Dict, dtype: Any = torch.float32) -> "Text2ImageConfig":
        img = cfg["image"]
        return cls(
            image_size=int(img["size"]),
            patch=int(cfg["tokenizer"]["image"]["patch"]),
            width=int(cfg["model"]["core"]["d_model"]),
            vae=ImageVAEConfig.from_dict(img, dtype=dtype),
            text=TextEncoderConfig(
                width=int(cfg["model"]["text"].get("d_model", 256)),
                max_len=int(cfg["model"]["text"].get("max_len", 77)),
                core=MMDiTConfig.from_dict(cfg["model"]["text"], dtype=dtype),
                dtype=dtype),
            core=MMDiTConfig.from_dict(cfg["model"]["core"], dtype=dtype),
            steps=int(cfg["diffusion"]["image"]["steps"]),
            schedule=str(cfg["diffusion"]["image"].get("schedule", "cosine")),
            min_beta=float(cfg["diffusion"]["image"].get("min_beta", 1e-4)),
            max_beta=float(cfg["diffusion"]["image"].get("max_beta", 2e-2)),
            dtype=dtype,
        )


def alpha_bar(c) -> np.ndarray:
    """The training schedule's alpha_bar[t] (fp32 numpy) of a text-family
    config (steps, schedule, min_beta, max_beta)."""
    betas = S.make_beta_schedule(c.steps, c.schedule, c.min_beta, c.max_beta)
    return S.alphas_cumprod_from_betas(betas)[1]


def text_conditioned_tokens(adapter: nn.Module, proj: nn.Module, pos: nn.Module,
                            tok: torch.Tensor, t: torch.Tensor, text_tokens: torch.Tensor,
                            text_pad: Optional[torch.Tensor],
                            keep_text: Optional[torch.Tensor], width: int):
    """The denoiser's input sequence [text; target] and its key mask (None
    without `text_pad`): target tokens through `adapter` plus positions and
    the timestep embedding, text tokens through `proj`, nulled per sample
    where keep_text is 0."""
    h = adapter(tok) + pos(tok.shape[1], tok.device)
    h = h + S.timestep_embedding(t, width).to(h.dtype)[:, None, :]
    h_txt = proj(text_tokens)
    if keep_text is not None:
        h_txt = h_txt * keep_text.to(h_txt.dtype)[:, None, None]
    mask = None
    if text_pad is not None:
        target_pad = torch.zeros(tok.shape[:2], dtype=torch.bool, device=tok.device)
        mask = torch.cat([text_pad.to(torch.bool), target_pad], dim=1)
    return torch.cat([h_txt, h], dim=1), mask, h_txt.shape[1]


class Text2ImageModel(nn.Module):
    def __init__(self, cfg: Text2ImageConfig):
        super().__init__()
        self.cfg = c = cfg
        self.text_encoder = TextEncoder(c.text)
        self.vae = ImageVAE(c.vae)
        self.text_proj = LinearAdapter(c.text.width, c.width, c.dtype)
        self.img_adapter = LinearAdapter(c.token_dim, c.width, c.dtype)
        self.pos_img = PositionalEmbedding1D(c.width, max_len=c.n_img_tokens,
                                             mode="learned", dtype=c.dtype)
        self.core = MMDiT(c.core)
        self.head = NoisePredictionHead(c.core.d_model, c.token_dim, hidden_dim=c.width,
                                        num_layers=2, dtype=c.dtype)

    # ---------------- codec / text passthroughs ----------------

    def encode_image(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return self.vae.encode(x, generator)

    def decode_image(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z)

    def encode_text(self, ids: torch.Tensor, use_kernel: Optional[bool] = None):
        return self.text_encoder(ids, use_kernel)

    # ---------------- denoiser ----------------

    def denoise(self, z_t: torch.Tensor, t: torch.Tensor, text_tokens: torch.Tensor,
                text_pad: Optional[torch.Tensor] = None,
                keep_text: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        """z_t [B, C, h, w] noisy latent, t [B], text_tokens [B, L, d_text],
        text_pad [B, L] (True = PAD), keep_text [B] 0/1 -> eps_hat [B, C, h, w]."""
        c = self.cfg
        x, mask, n_txt = text_conditioned_tokens(
            self.img_adapter, self.text_proj, self.pos_img, patch_image(z_t, c.patch), t,
            text_tokens, text_pad, keep_text, c.width)
        h = self.core(x, mask, use_kernel)
        eps_tok = self.head(h[:, n_txt:])
        return unpatch_image(eps_tok, c.vae.lat_ch, c.latent_hw, c.latent_hw, c.patch)

    def forward(self, images: torch.Tensor, ids: torch.Tensor, t: torch.Tensor,
                noise: torch.Tensor, alpha_bar: torch.Tensor,
                keep_text: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None):
        """Training forward: encode -> q_sample -> denoise. Returns (eps_hat,
        eps) in latent space. The VAE decoder takes no part (its parameters
        get no gradient)."""
        z0 = self.encode_image(images)
        z_t, eps = S.q_sample(z0, t, alpha_bar, noise)
        text_tokens, _ = self.encode_text(ids, use_kernel)
        eps_hat = self.denoise(z_t, t, text_tokens, ids == PAD_ID, keep_text, use_kernel)
        return eps_hat, eps


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def draw_t2i_randomness(generator: torch.Generator, c: Text2ImageConfig, batch: int,
                        cfg_drop_prob: float = 0.1) -> Dict[str, torch.Tensor]:
    """One step's draws on the generator's device: t [B] in [0, steps), latent
    noise [B, C, h, w] fp32 and the CFG keep [B] (1.0 where the text is
    kept)."""
    dev = generator.device
    return {
        "t": torch.randint(0, c.steps, (batch,), generator=generator, device=dev),
        "noise": torch.randn((batch,) + c.latent_shape, generator=generator, device=dev),
        "keep": (torch.rand((batch,), generator=generator, device=dev)
                 >= cfg_drop_prob).to(torch.float32),
    }


def t2i_loss(model: Text2ImageModel, images: torch.Tensor, ids: torch.Tensor,
             draws: Dict[str, torch.Tensor], abar: torch.Tensor,
             use_kernel: Optional[bool] = None) -> torch.Tensor:
    """mean((eps_hat - eps)^2) in fp32 over the step's draws."""
    eps_hat, eps = model(images, ids, draws["t"], draws["noise"], abar, draws["keep"],
                         use_kernel)
    return torch.mean(torch.square(eps_hat.float() - eps.float()))


def make_t2i_train_step(model: Text2ImageModel, optimizer, cfg_drop_prob: float = 0.1,
                        generator: Optional[torch.Generator] = None):
    """step(images, ids, draws=None) -> loss: one AdamW step
    (``train/trainer.py::AdamW`` over ``model.named_parameters()``, e.g.
    ``make_optimizer(cfg, ...)``) on the gradient of the loss w.r.t. every
    parameter, as the JAX step's ``value_and_grad`` over all params: the
    text encoder and the VAE encoder train too; the decoder's gradient is
    zero, and weight decay still moves it. The draws come from `generator`
    (on the model's device, seed 0 by default) unless given; dropout draws
    from it too."""
    c = model.cfg
    dev = next(model.parameters()).device
    abar = torch.as_tensor(alpha_bar(c), device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    set_dropout_generator(model, generator)

    def step(images: torch.Tensor, ids, draws: Optional[Dict[str, torch.Tensor]] = None
             ) -> torch.Tensor:
        model.train()
        ids = torch.as_tensor(ids, device=dev)
        if draws is None:
            draws = draw_t2i_randomness(generator, c, images.shape[0], cfg_drop_prob)
        loss = t2i_loss(model, images.to(dev), ids, draws, abar)
        grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True)
        optimizer.step(grads)
        return loss.detach()

    return step


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def sampling_pairs(T_train: int, sampler_steps: int) -> np.ndarray:
    """[(t_now, t_prev)] of the sampler, t_prev = -1 at the last step."""
    sched = S.make_sampling_schedule(T_train, sampler_steps)
    return np.stack([sched[:-1], sched[1:]], axis=1).astype(np.int64)


@torch.inference_mode()
def cfg_sample_loop(model: nn.Module, text2: torch.Tensor, pad2: torch.Tensor,
                    z: torch.Tensor, pairs: np.ndarray, g: float, abar: torch.Tensor,
                    sampler: str = "ddim", eta: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The text families' sampling loop: per step one ``model.denoise`` of
    the 2B batch [z; z] under the stacked [cond; negative] text, the guided
    eps_neg + g (eps_cond - eps_neg) in the denoiser's dtype, and a ddim
    (eta 0, or eta > 0 with step_noise[i] or the generator's draw) or
    dpmpp_2m update in fp32."""
    B = z.shape[0]
    x0_prev = torch.zeros_like(z)
    h_prev = torch.zeros((B,) + (1,) * (z.ndim - 1), dtype=torch.float32, device=z.device)
    for i, (t_now, t_prev) in enumerate(pairs.tolist()):
        t2 = torch.full((2 * B,), t_now, dtype=torch.long, device=z.device)
        eps2 = model.denoise(torch.cat([z, z]), t2, text2, pad2)
        eps_c, eps_n = eps2[:B], eps2[B:]
        eps_hat = eps_n + g * (eps_c - eps_n)
        tb, pb = t2[:B], torch.full((B,), t_prev, dtype=torch.long, device=z.device)
        if sampler == "dpmpp_2m":
            z, x0_prev, h_prev = S.dpmpp_2m_step(z, tb, pb, eps_hat, abar, x0_prev, h_prev)
        elif eta > 0.0:
            noise = None if step_noise is None else step_noise[i]
            z = S.ddim_step(z, tb, pb, eps_hat, abar, eta=eta, noise=noise,
                            generator=generator)
        else:
            z = S.ddim_step(z, tb, pb, eps_hat, abar)
    return z


def encode_prompts(model: nn.Module, ids, neg_ids):
    """Both prompt sets through the text encoder, one call each (as the JAX
    sampler): ([cond; negative] tokens [2B, L, d], their pad mask [2B, L]).
    Ids already on the model's device are used as they are (a host array is
    copied there, which waits for the device)."""
    dev = next(model.parameters()).device
    ids, neg_ids = (torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), device=dev)
                    for x in (ids, neg_ids))
    text_c, _ = model.encode_text(ids)
    text_n, _ = model.encode_text(neg_ids)
    return torch.cat([text_c, text_n]), torch.cat([ids == PAD_ID, neg_ids == PAD_ID])


def initial_noise(shape, device, z_init: Optional[torch.Tensor],
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """`z_init` (any device) as fp32 on `device`, else N(0, 1) from
    `generator` (seed 0 on `device` when None)."""
    if z_init is not None:
        if tuple(z_init.shape) != tuple(shape):
            raise ValueError(f"z_init has shape {tuple(z_init.shape)}, expected {tuple(shape)}")
        return torch.as_tensor(z_init, dtype=torch.float32).to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, generator=generator, device=generator.device).to(device)


def make_t2i_sampler(model: Text2ImageModel, sampler_steps: int = 50,
                     guidance_scale: float = 5.0, eta: float = 0.0, sampler: str = "ddim"):
    """Returns sample(ids, neg_ids, generator=None, z_init=None,
    step_noise=None) -> latents [B, C, h, w] fp32.

    Batched CFG: [cond; negative] stacked on batch, one forward per step.
    `neg_ids` of empty text is the pure unconditional branch; a real negative
    prompt steers away from it. `sampler`: "ddim" or "dpmpp_2m" (the
    deterministic 2nd-order multistep solver; eta must be 0). The initial
    noise is `z_init` or drawn from `generator`; with eta > 0 each step's
    noise is step_noise[i] ([steps, B, C, h, w]) or drawn from `generator`.
    """
    if sampler not in {"ddim", "dpmpp_2m"}:
        raise ValueError(f"sampler must be ddim|dpmpp_2m, got {sampler!r}")
    if sampler == "dpmpp_2m" and eta > 0.0:
        raise ValueError("dpmpp_2m is deterministic; eta must be 0")
    c = model.cfg
    abar_np = alpha_bar(c)
    pairs = sampling_pairs(c.steps, sampler_steps)
    g = float(guidance_scale)

    def sample(ids, neg_ids, generator: Optional[torch.Generator] = None,
               z_init: Optional[torch.Tensor] = None,
               step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev = next(model.parameters()).device
        with torch.inference_mode():
            text2, pad2 = encode_prompts(model, ids, neg_ids)
        z = initial_noise((text2.shape[0] // 2,) + c.latent_shape, dev, z_init, generator)
        return cfg_sample_loop(model, text2, pad2, z, pairs, g,
                               torch.as_tensor(abar_np, device=dev), sampler, eta,
                               generator, step_noise)

    return sample


def images_to_uint8(x: torch.Tensor) -> np.ndarray:
    """Decoded images [B, 3, H, W] in [-1, 1] -> uint8 [B, H, W, 3]: clip,
    then (x + 1) * 127.5 in x's dtype, truncated as numpy's astype(uint8)."""
    x = torch.clamp(x, -1.0, 1.0).permute(0, 2, 3, 1)
    return ((x + 1.0) * 127.5).to(torch.uint8).cpu().numpy()


def sample_images(model: Text2ImageModel, prompts: Sequence[str],
                  negative: Optional[Sequence[str]] = None, sampler_steps: int = 50,
                  guidance_scale: float = 5.0, generator: Optional[torch.Generator] = None,
                  sampler: str = "ddim", z_init: Optional[torch.Tensor] = None) -> np.ndarray:
    """End to end: prompts -> uint8 images [B, H, W, 3] on the model's
    device (the initial noise `z_init`, else from `generator`, else seed 0)."""
    c = model.cfg
    ids = tokenize_text(prompts, c.text.max_len)
    neg = tokenize_text(negative if negative is not None else [""] * len(prompts),
                        c.text.max_len)
    sample = make_t2i_sampler(model, sampler_steps, guidance_scale, sampler=sampler)
    z = sample(ids, neg, generator=generator, z_init=z_init)
    with torch.inference_mode():
        return images_to_uint8(model.decode_image(z))
