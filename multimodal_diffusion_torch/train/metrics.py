"""Metric writers: JSONL always, TensorBoard when importable (counterpart of
the JAX package's ``train/metrics.py``; the same tags)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricWriter:
    def __init__(self, log_dir, use_tensorboard: bool = True):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.dir))
            except ImportError:  # tensorboard not installed: JSONL only
                self._tb = None

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                tag = k if "/" in k else f"train/{k}"
                self._tb.add_scalar(tag, float(v), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
