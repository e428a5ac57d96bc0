"""The CogVideoX cell's parts on the CPU: its readers on made-up device
traces, its FLOP count against a hand sum and the published 0.332 PFLOP a
pass, and the cell itself driven at a tiny size, sound (correct) and with
the fp8 control and each planted fault (not correct)."""

import copy

import pytest

from benchmark import harness
from benchmark.arith.cogvideox_flops import cogvideox_forward_flops, tokens
from benchmark.arith.roofline import attention_fwd_bound_s
from benchmark.devicetrace import DeviceTrace, Op
from benchmark.tests.tiny import frozen

SPEC = harness.load_spec()
CELL = "t2v-cogvideox5b-49f"
MS = 1_000_000
TINY_LIMIT = 0.05


def reader(name):
    return harness.load_module("metrics", name)


def tiny_cogvideox():
    cfg = copy.deepcopy(frozen("cogvideox-5b"))
    cfg["mixed_precision"] = "fp32"
    cfg["model"]["core"].update(d_model=64, n_heads=2, n_layers=2, text_embed_dim=16,
                                time_embed_dim=24, axes_dim=[8, 12, 12])
    cfg["model"]["vae"].update(block_out_channels=[8, 16, 16, 32], norm_num_groups=4)
    cfg["text"]["max_sequence_length"] = 8
    cfg["sampling"].update(frames=17, height=32, width=48, steps=5)
    return cfg


def trace(kernels, window_s=1.0):
    ops = [Op(n, int(a * MS), int(b * MS)) for n, a, b in kernels]
    return DeviceTrace(ops, ops, [], window_s)


def test_flops_by_hand():
    cfg = tiny_cogvideox()
    # N = 8 text + 5 frames x 2 x 3 = 38 tokens, d 64, m 256, e 24
    N, d, m, e = 38, 64, 256, 24
    block = 2 * (2 * e * 6 * d) + 2 * N * d * (4 * d + 2 * m)
    io = 2 * 30 * 64 * d + 2 * 8 * 16 * d + 2 * (d * e + e * e) + 2 * e * 2 * d + 2 * 30 * d * 64
    got = cogvideox_forward_flops(cfg)
    assert got["projections"] == 2 * block + io
    assert got["attention"] == 2 * 4 * N * N * d
    full = cogvideox_forward_flops(frozen("cogvideox-5b"))
    assert tokens(frozen("cogvideox-5b")) == {"video": 17550, "text": 226, "total": 17776}
    assert full["projections"] == pytest.approx(0.169e15, rel=2e-3)
    assert full["attention"] == pytest.approx(0.163e15, rel=2e-3)
    assert full["total"] == pytest.approx(0.332e15, rel=1e-3)


def test_flash_roofline_and_attention_share():
    cfg = frozen("cogvideox-5b")
    ctx = {"cfg": cfg, "traffic": {"batch": 1}}
    roof = reader("flash_fwd_roofline.cogvideox").read
    share = reader("attention_share.cogvideox").read
    assert roof({}) is None and share(dict(ctx, trace=trace([("gemm", 0, 1)]))) is None
    bound = attention_fwd_bound_s((2, 48, 17776, 64), "bfloat16", [17776] * 2, False)
    assert bound * 1e3 == pytest.approx(7.852, rel=1e-3)
    t = trace([("flash_fwd_kernel", 0, 2 * bound * 1e3), ("nvjet", 20.0, 30.0),
               ("flash_fwd_kernel", 30.0, 30.0 + 2 * bound * 1e3)])
    assert roof(dict(ctx, trace=t)) == pytest.approx(50.0, rel=1e-4)
    want = 100 * 4 * bound * 1e3 / (10.0 + 4 * bound * 1e3)
    assert share(dict(ctx, trace=t)) == pytest.approx(want, rel=1e-3)


def test_mfu_and_decode_ms():
    cfg = frozen("cogvideox-5b")
    mfu = reader("mfu.cogvideox").read
    assert mfu({"cfg": cfg}) is None
    flops = cogvideox_forward_flops(cfg)["total"]
    assert mfu({"cfg": cfg, "forwards": 100, "wall_s": 100 * flops / 989e12}) == \
        pytest.approx(100.0)
    dec = reader("decode_ms.cogvideox").read
    t = trace([("conv", 10, 12), ("gn", 11, 13), ("gemm", 20, 22)])
    assert dec({"trace": t, "traced_calls": 1}) is None
    ranges = {"cogvideox.decode": [(10 * MS, 13 * MS)]}
    assert dec({"trace": t, "traced_calls": 1, "device_ranges": ranges}) == pytest.approx(3.0)


@pytest.fixture
def tiny_cell():
    cell = harness.resolve_cell(SPEC, CELL)
    cell.config = tiny_cogvideox()
    cell.limits = {name: TINY_LIMIT for name in cell.limits}
    return cell


def test_sound_tiny_run_is_correct(tiny_cell):
    readers = harness.readers_of(tiny_cell)
    out = tiny_cell.driver.run(tiny_cell, 2**31 + 12345, 0.2, True, "cpu")
    line = harness.result_line(tiny_cell, out, True, {"platform": "cpu"}, readers)
    assert line["correct"], line["check"]
    assert set(line["check"]) == {"v_rel_err", "v_later_rel_err", "step_rel_err",
                                  "video_rel_err"}
    assert set(line["metrics"]) == {"mfu.cogvideox"}  # no card: nothing on the device


@pytest.mark.parametrize("control", ["fp8", "stale", "guidance", "rope", "update", "mod"])
def test_controls_fail(tiny_cell, control, monkeypatch):
    from multimodal_diffusion_torch.infer import sample_cogvideox
    from multimodal_diffusion_torch.models import cogvideox

    # the module-wide plants, restored after the test
    monkeypatch.setattr(cogvideox, "apply_rope", cogvideox.apply_rope)
    monkeypatch.setattr(sample_cogvideox, "ddim_step", sample_cogvideox.ddim_step)
    numbers = tiny_cell.driver.readings(tiny_cell, 2**33 + 1, 1, control, "cpu")
    assert max(numbers[k] for k in tiny_cell.limits) > TINY_LIMIT, numbers


def test_program_passes(tiny_cell):
    sound = tiny_cell.driver.readings(tiny_cell, 2**33 + 2, 1, "none", "cpu")
    assert max(sound[k] for k in tiny_cell.limits) < TINY_LIMIT, sound
