"""The FLUX.1 cell's parts on the CPU: its readers on made-up device
traces, its FLOP count against a hand sum, the tensor-by-tensor weight draw
against weights.py's recipe, and the cell itself driven at a tiny size,
sound (correct) and with each planted fault (not correct)."""

import copy
import math

import pytest
import torch

from benchmark import harness
from benchmark.arith.flux_flops import flux_forward_flops, tokens
from benchmark.arith.roofline import attention_fwd_bound_s
from benchmark.chunked_weights import make_weights_by_tensor
from benchmark.devicetrace import DeviceTrace, Op
from benchmark.reference import flux_sampling as ref
from benchmark.tests.tiny import frozen

SPEC = harness.load_spec()
CELL = "t2i-flux-dev-1024"
MS = 1_000_000
TINY_LIMIT = 0.05


def reader(name):
    return harness.load_module("metrics", name)


def tiny_flux():
    cfg = copy.deepcopy(frozen("flux-dev"))
    cfg["mixed_precision"] = "fp32"
    cfg["model"]["core"].update(d_model=64, n_heads=2, axes_dim=[8, 12, 12], depth=2,
                                depth_single_blocks=2, context_in_dim=48, vec_in_dim=24)
    cfg["model"]["ae"]["ch"] = 32
    cfg["sampling"].update(height=256, width=256, steps=4)
    cfg["text"]["max_sequence_length"] = 8
    return cfg


def trace(kernels, window_s=1.0):
    ops = [Op(n, int(a * MS), int(b * MS)) for n, a, b in kernels]
    return DeviceTrace(ops, ops, [], window_s)


def ctx_of(cfg, **more):
    return dict({"cfg": cfg, "traffic": {"batch": 1}}, **more)


def test_flops_by_hand():
    cfg = tiny_flux()
    # N = 8 text + 256 image tokens, d 64, m 256, in 64, context 48, vec 24
    N, d, m = 264, 64, 256
    double = 2 * (2 * d * 6 * d) + 2 * N * d * (3 * d + d + 2 * m)
    single = 2 * d * 3 * d + 2 * N * d * (3 * d + m) + 2 * N * (d + m) * d
    embed = 2 * 2 * (256 * d + d * d) + 2 * (24 * d + d * d)
    io = 2 * 256 * 64 * d + 2 * 8 * 48 * d + 2 * d * 2 * d + 2 * 256 * d * 64
    attn = 4 * 4 * N * N * d
    got = flux_forward_flops(cfg)
    assert got["projections"] == 2 * double + 2 * single + embed + io
    assert got["attention"] == attn and got["total"] == got["projections"] + attn
    full = flux_forward_flops(frozen("flux-dev"))
    assert tokens(frozen("flux-dev")) == {"img": 4096, "txt": 512, "total": 4608}
    assert full["projections"] == pytest.approx(59.51e12, rel=1e-3)
    assert full["attention"] == pytest.approx(14.87e12, rel=1e-3)


def test_weight_draw_recipe():
    shapes = {"a.weight": (512, 256), "a.bias": (512,), "c.conv.weight": (64, 32, 3, 3),
              "q.norm.query_norm.scale": (4096,), "g.norm1.weight": (4096,)}
    w = make_weights_by_tensor(shapes, 2**40 + 3, "cpu", ref.is_norm_scale, torch.float32)
    assert float(w["a.weight"].std()) == pytest.approx(1 / 16, rel=0.02)
    assert float(w["a.bias"].std()) == pytest.approx(0.02, rel=0.1)
    assert float(w["c.conv.weight"].std()) == pytest.approx(1 / math.sqrt(288), rel=0.03)
    for name in ("q.norm.query_norm.scale", "g.norm1.weight"):
        big = w[name] > 4
        assert 0.02 < float(big.float().mean()) < 0.045  # one channel in 32 at x8
        assert float(w[name][~big].mean()) == pytest.approx(1.0, abs=0.005)
        assert float(w[name][big].mean()) == pytest.approx(8.0, abs=0.05)
    again = make_weights_by_tensor(shapes, 2**40 + 3, "cpu", ref.is_norm_scale)
    assert again["a.weight"].dtype == torch.bfloat16
    torch.testing.assert_close(again["a.weight"], w["a.weight"].to(torch.bfloat16))


def test_flash_roofline_and_attention_share():
    cfg = frozen("flux-dev")
    roof, share = reader("flash_fwd_roofline.flux").read, reader("attention_share.flux").read
    assert roof({}) is None and share(ctx_of(cfg, trace=trace([("gemm", 0, 1)]))) is None
    bound = attention_fwd_bound_s((1, 24, 4608, 128), "bfloat16", [4608], False)
    assert bound == pytest.approx(4 * 24 * 4608 * 128 * 4608 / 989e12, rel=1e-12)
    t = trace([("flash_fwd_kernel", 0, 2 * bound * 1e3), ("nvjet_gemm", 1.0, 3.0),
               ("flash_fwd_kernel", 3.0, 3.0 + 2 * bound * 1e3)])
    assert roof(ctx_of(cfg, trace=t)) == pytest.approx(50.0, rel=1e-4)  # whole ns
    # flash busy 2 x 2 bound of a busy union of the 2-ms gemm and both launches
    want = 100 * 4 * bound * 1e3 / (2.0 + 4 * bound * 1e3)
    assert share(ctx_of(cfg, trace=t)) == pytest.approx(want, rel=1e-3)


def test_mfu_of_the_window():
    cfg = frozen("flux-dev")
    read = reader("mfu.flux").read
    assert read({"cfg": cfg}) is None
    flops = flux_forward_flops(cfg)["total"]
    assert read({"cfg": cfg, "forwards": 56, "wall_s": 56 * flops / 989e12}) == \
        pytest.approx(100.0)


def test_decode_ms_reads_the_device_ranges():
    read = reader("decode_ms.flux").read
    t = trace([("conv", 10, 12), ("gn", 11, 13), ("gemm", 20, 22), ("conv", 40, 41)])
    assert read(ctx_of(None, trace=t, traced_calls=2)) is None  # no ranges: nothing
    ranges = {"flux.decode": [(10 * MS, 13 * MS), (40 * MS, 41 * MS)]}
    ctx = ctx_of(None, trace=t, traced_calls=2, device_ranges=ranges)
    assert read(ctx) == pytest.approx((3.0 + 1.0) / 2)


@pytest.fixture
def tiny_cell():
    cell = harness.resolve_cell(SPEC, CELL)
    cell.config = tiny_flux()
    cell.limits = {name: TINY_LIMIT for name in cell.limits}
    return cell


def test_sound_tiny_run_is_correct(tiny_cell):
    readers = harness.readers_of(tiny_cell)
    out = tiny_cell.driver.run(tiny_cell, 2**31 + 12345, 0.2, True, "cpu")
    line = harness.result_line(tiny_cell, out, True, {"platform": "cpu"}, readers)
    assert line["correct"], line["check"]
    assert set(line["check"]) == {"v_rel_err", "v_later_rel_err", "latent_rel_err",
                                  "img_rel_err"}
    assert set(line["metrics"]) == {"mfu.flux"}  # no card: nothing on the device to read


@pytest.mark.parametrize("fault", ["stale", "guidance", "rope"])
def test_planted_fault_fails(tiny_cell, fault, monkeypatch):
    from multimodal_diffusion_torch.models import flux

    monkeypatch.setattr(flux, "apply_rope", flux.apply_rope)  # restored after the test
    numbers = tiny_cell.driver.readings(tiny_cell, 2**33 + 1, 1, fault, "cpu")
    assert max(numbers[k] for k in tiny_cell.limits) > TINY_LIMIT, numbers


def test_fp8_control_fails_and_program_passes(tiny_cell):
    low = tiny_cell.driver.readings(tiny_cell, 2**33 + 2, 1, "fp8", "cpu")
    assert max(low[k] for k in tiny_cell.limits) > TINY_LIMIT, low
    sound = tiny_cell.driver.readings(tiny_cell, 2**33 + 2, 1, "none", "cpu")
    assert max(sound[k] for k in tiny_cell.limits) < TINY_LIMIT, sound
