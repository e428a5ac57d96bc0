"""FLUX.1 text-to-image sampling: the rectified-flow Euler sampler of
``github.com/black-forest-labs/flux`` ``src/flux/sampling.py`` over the
transformer (``models/flux.py``) and the AE decoder (``models/flux_ae.py``).

  noise [B, 16, H/8, W/8] -> packed [B, (H/16)(W/16), 64] (2x2 patches)
  t_i = shift(linspace(1, 0, steps + 1)), shift(t) = e^mu / (e^mu + 1/t - 1),
      mu linear in the image tokens: base_shift at 256, max_shift at 4096
  x += (t_{i+1} - t_i) v(x, t_i, g), guidance g embedded: one pass a step
  unpack -> AE decode -> clamp [-1, 1] -> uint8 (127.5 (x + 1), truncated)

The text towers (T5-XXL, CLIP-L) are not part of the port: the sampler takes
their outputs, the T5 token embeddings [B, L, 4096] and the pooled CLIP
vector [B, 768], precomputed (``infer/sample_t2i.py --text-embeds``). The
latent stays float32 between steps (the source keeps it in the weights'
bf16).

Spans (``utils/profiling.span``): ``flux.call`` around a call,
``flux.upload`` (text embeddings and noise to the device), ``flux.step``
(each Euler step), ``flux.denoiser`` (its transformer pass), ``flux.decode``
and ``flux.readback``; the transformer opens ``flux.double_blocks`` and
``flux.single_blocks``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..models.flux import Flux, FluxConfig, init_flux_weights
from ..models.flux_ae import AEConfig, AEDecoder
from ..train.checkpoint import cast_params_bf16
from ..utils.io import compute_dtype_from_config, resolve_device
from ..utils.profiling import span

AE_PREFIX = "ae."


def flux_schedule(steps: int, image_tokens: int, base_shift: float = 0.5,
                  max_shift: float = 1.15) -> List[float]:
    """The steps + 1 times from 1 to 0, shifted toward 1 by mu, linear in
    the image tokens from (256, base_shift) to (4096, max_shift)."""
    mu = base_shift + (max_shift - base_shift) * (image_tokens - 256) / (4096 - 256)
    out = []
    for t in np.linspace(1.0, 0.0, steps + 1):
        out.append(0.0 if t <= 0.0 else math.exp(mu) / (math.exp(mu) + (1.0 / float(t) - 1.0)))
    return out


def position_ids(txt_len: int, h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(img_ids [h w, 3], txt_ids [txt_len, 3]) float32: the image tokens at
    (0, row, col) of the h x w patch grid, row-major; the text tokens at 0."""
    img = torch.zeros(h, w, 3, device=device)
    img[..., 1] += torch.arange(h, device=device)[:, None]
    img[..., 2] += torch.arange(w, device=device)[None, :]
    return img.reshape(h * w, 3), torch.zeros(txt_len, 3, device=device)


def pack(z: torch.Tensor) -> torch.Tensor:
    """[B, C, 2h, 2w] -> [B, h w, C 2 2], each token's features (c, ph, pw)."""
    B, C, H, W = z.shape
    z = z.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return z.reshape(B, (H // 2) * (W // 2), C * 4)


def unpack(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The inverse of ``pack`` on an h x w patch grid."""
    B, _, D = x.shape
    x = x.reshape(B, h, w, D // 4, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(B, D // 4, 2 * h, 2 * w)


def split_weights(weights: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One state dict -> the transformer's and the AE decoder's (the keys
    under ``ae.``, the prefix taken off)."""
    ae = {k[len(AE_PREFIX):]: v for k, v in weights.items() if k.startswith(AE_PREFIX)}
    return {k: v for k, v in weights.items() if not k.startswith(AE_PREFIX)}, ae


def build_flux(cfg: Dict, device: Union[str, torch.device] = "cuda",
               weights: Optional[Dict[str, torch.Tensor]] = None,
               seed: int = 0) -> Tuple[Flux, AEDecoder]:
    """The transformer and the AE decoder in eval mode on `device`, built on
    the meta device so nothing is allocated twice. `weights` (the
    transformer's keys and the decoder's under ``ae.``) become the
    parameters themselves, in their own dtype (strict); without them the
    parameters are drawn from `seed` (``init_flux_weights``), and under bf16
    compute cast to bf16 as served (``cast_params_bf16``)."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = compute_dtype_from_config(cfg)
    with torch.device("meta"):
        model = Flux(FluxConfig.from_config(cfg, dtype))
        ae = AEDecoder(AEConfig.from_config(cfg, dtype))
    if weights is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        for m in (model, ae):
            m.to_empty(device=dev)
            init_flux_weights(m, gen)
            if dtype == torch.bfloat16:
                cast_params_bf16(m)
    else:
        own, ae_sd = split_weights(weights)
        model.load_state_dict(own, strict=True, assign=True)
        ae.load_state_dict(ae_sd, strict=True, assign=True)
    return model.eval(), ae.eval()


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] -> [B, H, W, 3] uint8: 127.5 (clamp(x, -1, 1) + 1),
    truncated."""
    return (127.5 * (x.clamp(-1.0, 1.0) + 1.0)).to(torch.uint8).permute(0, 2, 3, 1)


@torch.inference_mode()
def sample_flux(cfg: Dict, model: Flux, ae: AEDecoder, t5: torch.Tensor, pooled: torch.Tensor,
                device: Union[str, torch.device], generator: torch.Generator,
                steps: Optional[int] = None, guidance: Optional[float] = None
                ) -> Dict[str, np.ndarray]:
    """Images for a batch of prompts' text embeddings (t5 [B, L, 4096],
    pooled [B, 768], on the host or the device) at the config's
    sampling.height x width: the noise drawn on the host from `generator`
    ([B, 16, H/8, W/8] float32, standard normal), ``steps`` Euler steps
    (default sampling.steps) at ``guidance`` (default sampling.guidance).
    Returns {"image": [B, H, W, 3] uint8} on the host."""
    s = cfg["sampling"]
    steps = int(s["steps"]) if steps is None else int(steps)
    guidance = float(s["guidance"]) if guidance is None else float(guidance)
    device = torch.device(device)
    B = t5.shape[0]
    h, w = int(s["height"]) // 16, int(s["width"]) // 16
    C = int(cfg["model"]["ae"]["z_channels"])
    with span("flux.call"):
        with span("flux.upload"):
            noise = torch.randn((B, C, 2 * h, 2 * w), generator=generator)
            x = pack(noise).to(device)
            txt = t5.to(device, model.cfg.dtype)
            y = pooled.to(device, torch.float32)
            img_ids, txt_ids = position_ids(txt.shape[1], h, w, device)
            g = torch.full((B,), guidance, device=device)
        times = flux_schedule(steps, h * w, float(s["base_shift"]), float(s["max_shift"]))
        for t_cur, t_prev in zip(times[:-1], times[1:]):
            with span("flux.step"):
                t_vec = torch.full((B,), t_cur, device=device)
                with span("flux.denoiser"):
                    v = model(x, img_ids, txt, txt_ids, t_vec, y, g)
                x = x + (t_prev - t_cur) * v
        with span("flux.decode"):
            img = ae.decode(unpack(x, h, w))
        with span("flux.readback"):
            out = to_uint8(img).cpu().numpy()
    return {"image": out}


def load_text_embeds(path) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``.npz`` of ``t5`` ([L, 4096] or [B, L, 4096]) and ``pooled``
    ([768] or [B, 768]) -> (t5 [B, L, 4096], pooled [B, 768]) float32."""
    with np.load(path) as f:
        t5, pooled = np.asarray(f["t5"], np.float32), np.asarray(f["pooled"], np.float32)
    if t5.ndim == 2:
        t5, pooled = t5[None], pooled.reshape(1, -1)
    if t5.shape[0] != pooled.shape[0]:
        raise ValueError(f"{path}: t5 {t5.shape} and pooled {pooled.shape} differ in batch")
    return torch.from_numpy(t5), torch.from_numpy(pooled)
