"""The controls of the sampling cells' check at a tiny size on the CPU: the
reference computed in float8 in the program's place, and the program with
its int8 path switched on, read above the program as the cell runs it. At
the cells' own sizes the readings come from ``benchmark/control.py`` on the
card (the marked test below)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny

SPEC = harness.load_spec()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell(workload, precision="bf16"):
    cell = harness.resolve_cell(SPEC, workload)
    cell.config = tiny(cell.config_name, precision, steps=6)
    cell.traffic = dict(cell.traffic, batch=2, pool=3)
    return cell


def test_fp8_reference_reads_above_the_program():
    cell = tiny_cell("v2a-spec8-b8")
    program = cell.driver.readings(cell, 5, 1, "none", "cpu")
    control = cell.driver.readings(cell, 5, 1, "fp8", "cpu")
    for name in program:
        assert control[name] > program[name], (name, program, control)


def test_int8_path_moves_the_first_prediction():
    cell = tiny_cell("v2a-spec8-b8")
    program = cell.driver.readings(cell, 5, 1, "none", "cpu")
    control = cell.driver.readings(cell, 5, 1, "int8", "cpu")
    assert control["eps_rel_err"] > program["eps_rel_err"], (program, control)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_controls_fail_the_cell_at_its_size(workload):
    """The card: each control that bounds the cell's limits from above (its
    limits file's "controls"), and each fault of the later passes the cell
    can see ("faults"), reads above a limit, at the cell's size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls are read at the cell's own size")
    limits = harness.resolve_cell(SPEC, workload).limits
    kept = json.loads((harness.HERE / "limits" / f"{workload}.json").read_text())
    for control in kept["controls"] + kept["faults"]:
        out = subprocess.run([sys.executable, "benchmark/control.py", "--workload", workload,
                              "--seeds", "7001", "--control", control],
                             capture_output=True, text=True, check=True, cwd=harness.ROOT,
                             env=dict(os.environ))
        reading = json.loads(out.stdout.strip().splitlines()[-1])
        assert any(reading[k] > v for k, v in limits.items()), (control, reading, limits)
