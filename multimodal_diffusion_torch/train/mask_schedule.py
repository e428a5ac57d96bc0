"""Any->any target selection (a copy of the JAX package's
``train/mask_schedule.py``): a normalized Bernoulli pick of "video" vs
"audio" per batch, host-side. It uses Python's ``random.Random(seed)``, so a
seed gives the same target sequence in both packages."""

from __future__ import annotations

import random
from typing import Dict, Optional


class Any2AnySchedule:
    def __init__(self, probs: Dict[str, float], seed: Optional[int] = None):
        pv = float(probs.get("video", 0.5))
        pa = float(probs.get("audio", 0.5))
        total = pv + pa
        if total <= 0:
            raise ValueError("Sum of probabilities must be > 0")
        self.pv = pv / total
        self.pa = pa / total
        self._rng = random.Random(seed)

    def sample_target(self) -> str:
        return "video" if self._rng.random() < self.pv else "audio"
