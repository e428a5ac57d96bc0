"""Seeds of a run's parts, derived from --seed: each part draws from its own
stream, so the same --seed gives the same weights, prompts and batches."""

from __future__ import annotations

import numpy as np

PARTS = ("weights", "prompts", "batches", "check", "pass")


def part_seed(seed: int, part: str, index: int = 0) -> int:
    """A 63-bit seed for `part` (and its `index`-th member) of run `seed`."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), PARTS.index(part), int(index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
