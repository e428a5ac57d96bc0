"""The benchmark's harness: finds a cell's configuration, traffic mix,
driver, per-layer metric readers and limits by the names in BENCHMARK.json,
runs the driver, and prints the result line.

Everything that belongs to one configuration, mix or metric is a file of
its own, found by name:

  configs/<config>.json      the merged model configuration as run ("config"),
                             its source and what was cut ("reduced")
  traffic/<traffic>.json     the mix's parameters; "driver" names the module
  drivers/<driver>.py        run(cell, seed, seconds, trace, device) -> Outcome
  metrics/<metric>.py        read(ctx) -> float or None (None: nothing to read)
  limits/<workload>.json     the limit of each number the check compares

A later cell, mix or metric is added by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]  # the checkout: BENCHMARK.json's directory
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
# top-level module names that must not be loaded by the time the result prints
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "multimodal_diffusion_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]  # the merged model configuration
    traffic_name: str
    traffic: Dict[str, Any]
    driver: ModuleType
    end_to_end: List[Dict[str, Any]]  # the metrics this cell reports with --trace 0
    per_layer: List[Dict[str, Any]]  # ... with --trace 1
    limits: Dict[str, float]


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end values it took, what the
    per-layer readers read (``context``), the work attempted and failed, the
    device's peak memory, and each number the check compared beside its
    limit."""

    values: Dict[str, float]
    context: Dict[str, Any]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Tuple[str, float, float]]


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _checked_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(kind: str, name: str, base: Path = HERE) -> Dict[str, Any]:
    return json.loads((base / kind / f"{_checked_name(name)}.json").read_text())


def load_module(kind: str, name: str, base: Path = HERE) -> ModuleType:
    """drivers/<name>.py or metrics/<name>.py, loaded from its file."""
    path = base / kind / f"{_checked_name(name)}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(spec: Dict[str, Any], workload: str) -> Tuple[List[Dict], List[Dict]]:
    """The end-to-end and per-layer metrics a cell reports: those that list
    it under "workloads", and those without the key (per-layer ones then
    wherever the metric they move is reported)."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in names else [])]
    return e2e, layer


def resolve_cell(spec: Dict[str, Any], workload: str, root: Path = ROOT) -> Cell:
    base = root / "benchmark"
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())["config"]
    traffic = load_json("traffic", w["traffic"], base)
    e2e, layer = metrics_of(spec, workload)
    limits_path = base / "limits" / f"{_checked_name(workload)}.json"
    limits = json.loads(limits_path.read_text())["limits"] if limits_path.exists() else {}
    return Cell(workload, int(w["chips"]), w["config"], config, w["traffic"], traffic,
                load_module("drivers", traffic["driver"], base), e2e, layer, limits)


def readers_of(cell: Cell, root: Path = ROOT) -> Dict[str, ModuleType]:
    return {m["name"]: load_module("metrics", m["name"], root / "benchmark")
            for m in cell.per_layer}


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def result_line(cell: Cell, out: Outcome, trace: bool, device: Dict[str, Any],
                readers: Optional[Dict[str, ModuleType]] = None) -> Dict[str, Any]:
    """The result's JSON object; the checks come last."""
    metrics, breakdown = {}, None
    if trace:
        for m in cell.per_layer:
            value = readers[m["name"]].read(out.context)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dtrace = out.context.get("trace")
        if dtrace is not None:
            device = dict(device, busy_s=dtrace.busy_s(), window_s=dtrace.window_s)
            breakdown = {"device_ops": dtrace.top_device_ops(), "idle_gaps": dtrace.idle_gaps()}
    else:
        for m in cell.end_to_end:
            if m["name"] in out.values:
                metrics[m["name"]] = {"value": float(out.values[m["name"]]), "unit": m["unit"]}
    correct = bool(out.checks) and all(v <= lim for _, v, lim in out.checks)
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dict(device, memory_peak_bytes=out.memory_peak_bytes)}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    return line
