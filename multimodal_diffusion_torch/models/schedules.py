"""Per-modality diffusion schedule objects (counterpart of the JAX
``models/schedules.py``): ``ModalitySchedule`` and
``build_schedules_from_config``, thin wrappers over ``ops/schedule.py``, the
ops the trainer and the samplers call, so there is one numerical source
either way. The tables are numpy fp32; the per-step methods run in torch on
the inputs' device, with noise passed in or drawn from a generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import schedule as S


@dataclasses.dataclass
class ModalitySchedule:
    kind: str
    steps: int
    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray

    @classmethod
    def make(cls, *, kind: str = "cosine", steps: int = 1000, min_beta: float = 1e-4,
             max_beta: float = 2e-2) -> "ModalitySchedule":
        betas = S.make_beta_schedule(steps=steps, kind=kind, min_beta=min_beta,
                                     max_beta=max_beta)
        alphas, abar = S.alphas_cumprod_from_betas(betas)
        return cls(kind=kind, steps=int(steps), betas=betas, alphas=alphas,
                   alphas_cumprod=abar)

    def _abar(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.alphas_cumprod, device=like.device)

    # ---------- forward process ----------

    def q_sample(self, z0: torch.Tensor, t: torch.Tensor, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        """(z_t, noise); the noise is drawn from `generator` when not given."""
        if noise is None:
            if generator is None:
                raise ValueError("q_sample needs either `noise` or `generator`")
            noise = torch.randn(z0.shape, generator=generator, device=z0.device)
        return S.q_sample(z0, t, self._abar(z0), noise)

    # ---------- reverse (DDIM) ----------

    def ddim_step(self, z_t: torch.Tensor, t: torch.Tensor, t_prev: torch.Tensor,
                  eps_hat: torch.Tensor, eta: float = 0.0, noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return S.ddim_step(z_t, t, t_prev, eps_hat, self._abar(z_t), eta=eta, noise=noise,
                           generator=generator)

    def make_sampling_schedule(self, steps_sample: int) -> np.ndarray:
        return S.make_sampling_schedule(self.steps, steps_sample)

    def timestep_embedding(self, t: torch.Tensor, dim: int,
                           max_period: int = 10_000) -> torch.Tensor:
        return S.timestep_embedding(t, dim=dim, max_period=max_period)


def build_schedules_from_config(cfg: Dict) -> Dict[str, ModalitySchedule]:
    """{"video": ..., "audio": ...} from the `diffusion:` config block."""
    out = {}
    for mod in ("video", "audio"):
        c = cfg["diffusion"][mod]
        out[mod] = ModalitySchedule.make(
            kind=c.get("schedule", "cosine"),
            steps=int(c.get("steps", 1000)),
            min_beta=float(c.get("min_beta", 1e-4)),
            max_beta=float(c.get("max_beta", 2e-2)),
        )
    return out
