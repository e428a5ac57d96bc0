"""FLUX.1 on the port (models/flux.py, models/flux_ae.py, infer/sample_flux.py)
against the plain float32 reference of the benchmark
(benchmark/reference/flux_sampling.py) on the CPU at a tiny size: hidden 64,
2 heads of 32, RoPE axes [8, 12, 12], 2 double + 2 single blocks, a 32 x 32
latent (a 16 x 16 patch grid beside 8 text tokens), the AE decoder at ch 32.
The weights are the benchmark's seeded draw (chunked_weights.py), in fp32."""

import copy
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from benchmark.chunked_weights import make_weights_by_tensor
from benchmark.reference import flux_sampling as ref
from multimodal_diffusion_torch.infer import sample_flux as sf
from multimodal_diffusion_torch.infer import sample_t2i
from multimodal_diffusion_torch.models import flux

REPO = Path(__file__).resolve().parents[1]
# fp32 on both sides: only the order of the sums differs
FWD_TOL = 1e-5
SAMPLE_TOL = 1e-4


def tiny_cfg(precision="fp32"):
    cfg = yaml.safe_load((REPO / "configs" / "flux_dev.yaml").read_text())
    cfg["mixed_precision"] = precision
    cfg["model"]["core"].update(d_model=64, n_heads=2, axes_dim=[8, 12, 12], depth=2,
                                depth_single_blocks=2)
    cfg["model"]["ae"]["ch"] = 32
    cfg["sampling"].update(height=256, width=256, steps=4)
    cfg["text"]["max_sequence_length"] = 8
    cfg["paths"]["ckpt_dir"] = "does/not/exist"
    return cfg


@pytest.fixture(scope="module")
def cfg():
    return tiny_cfg()


@pytest.fixture(scope="module")
def weights(cfg):
    return make_weights_by_tensor(ref.param_shapes(cfg), 2**31 + 7, "cpu", ref.is_norm_scale,
                                  torch.float32)


@pytest.fixture(scope="module")
def program(cfg, weights):
    return sf.build_flux(cfg, "cpu", dict(weights))


def _inputs(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    L, core = cfg["text"]["max_sequence_length"], cfg["model"]["core"]
    txt = torch.randn(2, L, core["context_in_dim"], generator=g)
    y = torch.randn(2, core["vec_in_dim"], generator=g)
    x = torch.randn(2, 16 * 16, core["in_channels"], generator=g)
    return x, txt, y


def rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _velocity(model, cfg, x, txt, y, t=0.6, g=3.5):
    img_ids, txt_ids = sf.position_ids(txt.shape[1], 16, 16, "cpu")
    with torch.inference_mode():
        return model(x, img_ids, txt, txt_ids, torch.full((2,), t), y, torch.full((2,), g))


def test_weights_become_the_parameters(program, weights):
    model, ae = program
    params = dict(model.named_parameters())
    assert params["double_blocks.1.img_attn.qkv.weight"].data_ptr() == weights[
        "double_blocks.1.img_attn.qkv.weight"].data_ptr()
    assert dict(ae.named_parameters())["decoder.conv_out.weight"].data_ptr() == weights[
        "ae.decoder.conv_out.weight"].data_ptr()
    assert len(params) + len(list(ae.parameters())) == len(weights)


def test_forward_matches_reference(cfg, program, weights):
    x, txt, y = _inputs(cfg)
    v = _velocity(program[0], cfg, x, txt, y)
    want = ref.velocity(weights, cfg, x, txt, y, 0.6, 3.5, (16, 16))
    assert v.shape == x.shape and v.dtype == torch.float32
    assert rel(v, want) < FWD_TOL


@pytest.mark.parametrize("t,g", [(1.0, 3.5), (0.05, 1.0)])
def test_time_and_guidance_reach_the_velocity(cfg, program, weights, t, g):
    x, txt, y = _inputs(cfg, 1)
    v = _velocity(program[0], cfg, x, txt, y, t, g)
    assert rel(v, ref.velocity(weights, cfg, x, txt, y, t, g, (16, 16))) < FWD_TOL
    assert rel(v, _velocity(program[0], cfg, x, txt, y, 0.6, 3.5)) > 1e-2


def test_rope_rotates_adjacent_pairs_per_axis():
    """Each pair (x_2i, x_2i+1) turns by its axis's angle: the tables
    against the reference's rotation matrices, and a position on one axis
    moves only that axis's pairs (4, 6 and 6 of them at axes [8, 12, 12])."""
    axes, theta = [8, 12, 12], 10_000.0
    ids = torch.tensor([[0.0, 0, 0], [0, 3, 0], [0, 0, 5], [2, 7, 11]])
    cos, sin = flux.rope_tables(ids, axes, theta)
    x = torch.randn(1, 2, 4, 32, generator=torch.Generator().manual_seed(0))
    got = flux.apply_rope(x, cos, sin)
    want = ref.apply_rope(x, ref.rope(ids, axes, theta))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    moved = (got - x).abs().amax(dim=(0, 1)).reshape(4, 16, 2).amax(-1) > 1e-6
    assert not moved[0].any()
    assert moved[1, 4:10].all() and not moved[1, :4].any() and not moved[1, 10:].any()
    assert moved[2, 10:].all() and not moved[2, :10].any()
    # a pair turns by pos * theta^(-2i/d): row-axis pair 1 at position 3
    ang = 3.0 * theta ** (-2.0 / 12)
    x0, x1 = x[..., 1, 10], x[..., 1, 11]
    torch.testing.assert_close(got[..., 1, 10], math.cos(ang) * x0 - math.sin(ang) * x1)


def test_rotate_half_layout_fails_the_reference(cfg, program, weights, monkeypatch):
    """The port's AV core rotates half against half (mmdit.rotary_embed's
    layout); FLUX.1 rotates adjacent pairs. With the halves' layout in
    place, the velocity leaves the reference far behind: the pair layout is
    pinned."""
    x, txt, y = _inputs(cfg, 2)
    want = ref.velocity(weights, cfg, x, txt, y, 0.6, 3.5, (16, 16))

    def rotate_half(t, cos, sin):
        a, b = t.chunk(2, dim=-1)
        return torch.cat([cos * a - sin * b, sin * a + cos * b], dim=-1)

    monkeypatch.setattr(flux, "apply_rope", rotate_half)
    assert rel(_velocity(program[0], cfg, x, txt, y), want) > 1e-2


def test_schedule_matches_reference_and_the_shift():
    cfg = tiny_cfg()
    cfg["sampling"].update(height=1024, width=1024, steps=28)
    got = sf.flux_schedule(28, 4096, 0.5, 1.15)
    np.testing.assert_allclose(got, ref.schedule(cfg), rtol=1e-12, atol=0)
    assert got[0] == 1.0 and got[-1] == 0.0 and all(a > b for a, b in zip(got, got[1:]))
    # at 4096 image tokens mu = max_shift: t = 1/2 maps to e^mu / (e^mu + 1)
    half = sf.flux_schedule(2, 4096, 0.5, 1.15)[1]
    assert half == pytest.approx(math.exp(1.15) / (math.exp(1.15) + 1.0), rel=1e-12)
    # at 256 tokens mu = base_shift
    assert sf.flux_schedule(2, 256, 0.5, 1.15)[1] == pytest.approx(
        math.exp(0.5) / (math.exp(0.5) + 1.0), rel=1e-12)


def test_pack_unpack_round_trip():
    z = torch.randn(2, 16, 8, 6)
    x = sf.pack(z)
    assert x.shape == (2, 12, 64)
    torch.testing.assert_close(x, ref.patchify(z))
    torch.testing.assert_close(sf.unpack(x, 4, 3), z)


def test_euler_loop_and_decoder_match_reference(cfg, program, weights):
    """The whole sampled latent within 1e-4 of its magnitude (4 steps fed
    back), the decoded image within one level of the uint8 truncation."""
    model, ae = program
    kept = {}
    decode = ae.decode

    def tap(z):
        kept["z"] = z.clone()
        return decode(z)

    ae.decode = tap
    try:
        _, txt, y = _inputs(cfg, 3)
        out = sf.sample_flux(cfg, model, ae, txt, y, "cpu", torch.Generator().manual_seed(11))
    finally:
        del ae.decode
    noise = torch.randn((2, 16, 32, 32), generator=torch.Generator().manual_seed(11))
    image, z_ref, _ = ref.sample_image(weights, cfg, noise, txt, y)
    assert rel(kept["z"], z_ref) < SAMPLE_TOL
    assert out["image"].shape == (2, 256, 256, 3) and out["image"].dtype == np.uint8
    diff = np.abs(out["image"].astype(np.int16) - image.numpy().astype(np.int16))
    assert diff.max() <= 1 and diff.mean() < 0.01
    assert 20 < out["image"].mean() < 235 and out["image"].std() > 10  # not saturated


def test_ae_decoder_matches_reference(cfg, program, weights):
    z = torch.randn(1, 16, 8, 8, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        got = program[1].decode(z).clamp(-1, 1)
    assert got.shape == (1, 3, 64, 64)
    assert rel(got, ref.decode(weights, cfg, z)) < FWD_TOL


def test_bf16_program_stays_near_the_reference(cfg, weights):
    """Served in bf16 (the weights rounded once, bf16 operands, float32
    streams): within a few bf16 roundings of the float32 reference."""
    cfg16 = copy.deepcopy(cfg)
    cfg16["mixed_precision"] = "bf16"
    w16 = {k: v.to(torch.bfloat16) for k, v in weights.items()}
    model, _ = sf.build_flux(cfg16, "cpu", w16)
    x, txt, y = _inputs(cfg, 4)
    v = _velocity(model, cfg16, x, txt.to(torch.bfloat16), y)
    assert rel(v, ref.velocity(w16, cfg, x, txt.to(torch.bfloat16), y, 0.6, 3.5,
                               (16, 16))) < 3e-2


def test_sample_t2i_cli_writes_png_from_text_embeds(tmp_path):
    cfg = tiny_cfg()
    cfg["sampling"]["steps"] = 2
    (tmp_path / "flux.yaml").write_text(yaml.safe_dump(cfg))
    g = np.random.default_rng(0)
    np.savez(tmp_path / "embeds.npz", t5=g.standard_normal((8, 4096)).astype(np.float32),
             pooled=g.standard_normal(768).astype(np.float32))
    paths = sample_t2i.main(["--config", str(tmp_path / "flux.yaml"), "--text-embeds",
                             str(tmp_path / "embeds.npz"), "--out-dir", str(tmp_path / "out"),
                             "--device", "cpu"])
    from PIL import Image

    assert [p.name for p in paths] == ["t2i_0000.png"]
    assert Image.open(paths[0]).size == (256, 256)


def test_sample_t2i_flux_needs_text_embeds(tmp_path):
    (tmp_path / "flux.yaml").write_text(yaml.safe_dump(tiny_cfg()))
    with pytest.raises(SystemExit):
        sample_t2i.main(["--config", str(tmp_path / "flux.yaml"), "--device", "cpu"])


def test_av_paths_import_nothing_of_flux():
    """The AV cells' entry points and the benchmark's sampling driver load
    no Flux module: the lazily imported family adds nothing to their
    set-up."""
    code = ("import sys; import multimodal_diffusion_torch.infer.sample_clip, "
            "multimodal_diffusion_torch.infer.sample_t2i, benchmark.drivers.sample; "
            "bad = [m for m in sys.modules if 'flux' in m]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
