"""The serving cell on the CPU at a tiny size (the tiny spec8, max_batch 2):
a sound run is correct and counts the clips its window completed, both
directions' passes reach the check, and the fp8 control and each planted
fault are not correct."""

import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny

SPEC = harness.load_spec()
CELL = "serve-spec8-poisson"
TINY_LIMIT = 0.05


@pytest.fixture
def tiny_cell():
    cell = harness.resolve_cell(SPEC, CELL)
    cell.config = tiny("spec8", steps=3)
    cell.traffic = dict(cell.traffic, rate=6.0, max_batch=2, max_queue=4, profile_seconds=0.5,
                        check_batches=1)
    cell.limits = {name: TINY_LIMIT for name in cell.limits}
    return cell


def test_sound_tiny_run_is_correct(tiny_cell):
    out = tiny_cell.driver.run(tiny_cell, 2**31 + 99, 1.5, True, "cpu")
    line = harness.result_line(tiny_cell, out, True, {"platform": "cpu"},
                               harness.readers_of(tiny_cell))
    assert line["correct"], line["check"]
    assert out.failed == 0 and out.attempted > 0
    assert 0 < out.values["clips_per_s"] * 1.5 <= out.attempted
    assert {k for k in line["check"] if k.startswith("a2v_")} == {
        "a2v_eps_rel_err", "a2v_eps_later_rel_err", "a2v_latent_rel_err", "a2v_frames_rel_err"}


@pytest.mark.parametrize("control", ["fp8", "stale", "guidance"])
def test_controls_fail(tiny_cell, control):
    numbers = tiny_cell.driver.readings(tiny_cell, 2**33 + 5, 1, control, "cpu")
    assert max(numbers[k] for k in tiny_cell.limits) > TINY_LIMIT, numbers
    sound = tiny_cell.driver.readings(tiny_cell, 2**33 + 5, 1, "none", "cpu")
    assert max(sound[k] for k in tiny_cell.limits) < TINY_LIMIT, sound
