"""The training cell's parts on the CPU: the backward kernels' bound
against the kernel table, its reader on a made-up device trace, and the
cell driven at a tiny size, sound (correct) and with each planted fault
(not correct)."""

import pytest

from benchmark import harness
from benchmark.arith.roofline_bwd import attention_bwd_bound_s
from benchmark.devicetrace import DeviceTrace, Op
from benchmark.tests.tiny import frozen, tiny

SPEC = harness.load_spec()
CELL = "train-spec8-b8"
MS = 1_000_000


def test_backward_bounds_of_the_kernel_table():
    # the kernel table's bounds at [8, 8, 421, 128]: dK/dV 12.4 us, dQ 10.4 us
    shape = (8, 8, 421, 128)
    assert attention_bwd_bound_s("dkdv", shape, "bfloat16", [421] * 8, False) == \
        pytest.approx(12.4e-6, rel=5e-3)
    assert attention_bwd_bound_s("dq", shape, "bfloat16", [421] * 8, False) == \
        pytest.approx(10.4e-6, rel=5e-3)
    # operations bind at a long sequence
    big = attention_bwd_bound_s("dq", (1, 24, 4608, 128), "bfloat16", [4608], False)
    assert big == pytest.approx(3 * 2 * 24 * 4608 * 128 * 4608 / 989e12, rel=1e-12)


def test_flash_bwd_roofline_reader():
    read = harness.load_module("metrics", "flash_bwd_roofline.train").read
    cfg = frozen("spec8")
    ctx = {"cfg": cfg, "traffic": {"batch": 8}}
    assert read(ctx) is None
    dkdv = attention_bwd_bound_s("dkdv", (8, 8, 421, 128), "bfloat16", [421] * 8, False)
    dq = attention_bwd_bound_s("dq", (8, 8, 421, 128), "bfloat16", [421] * 8, False)
    ops = [Op("flash_bwd_dkdv_wgmma_kernel", 0, int(4 * dkdv * 1e9)),
           Op("nvjet_gemm", 0, 5 * MS),
           Op("flash_bwd_dq_wgmma_kernel", 6 * MS, 6 * MS + int(4 * dq * 1e9))]
    ctx["trace"] = DeviceTrace(ops, ops, [], 1.0)
    assert read(ctx) == pytest.approx(25.0, rel=1e-4)


@pytest.fixture
def tiny_cell():
    cell = harness.resolve_cell(SPEC, CELL)
    cell.config = tiny("spec8")
    cell.traffic = dict(cell.traffic, batch=2, resident_clips=6, planned_steps=16)
    return cell  # the cell's own limits


def test_sound_tiny_run_is_correct(tiny_cell):
    out = tiny_cell.driver.run(tiny_cell, 2**31 + 12345, 0.2, True, "cpu")
    line = harness.result_line(tiny_cell, out, True, {"platform": "cpu"},
                               harness.readers_of(tiny_cell))
    assert line["correct"], line["check"]
    assert line["attempted"] > 0 and line["attempted"] % 2 == 0
    assert not line["metrics"]  # no card: nothing on the device to read


@pytest.mark.parametrize("fault", ["no_dropout", "target", "half_batch", "no_ema"])
def test_planted_fault_fails(tiny_cell, fault):
    numbers = tiny_cell.driver.readings(tiny_cell, 2**33 + 1, 1, fault, "cpu")
    assert any(numbers[k] > lim for k, lim in tiny_cell.limits.items()), numbers


def test_fp8_control_fails(tiny_cell):
    numbers = tiny_cell.driver.readings(tiny_cell, 2**33 + 2, 1, "fp8", "cpu")
    assert any(numbers[k] > lim for k, lim in tiny_cell.limits.items()), numbers
