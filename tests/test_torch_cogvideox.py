"""CogVideoX on the CPU at a tiny size (2 blocks, 2 heads of 32, 8 text
tokens, 5 latent frames of 4 x 6, decoder channels [8, 16, 16, 32] in 4
groups, so the decoder runs a 3-frame batch and then a 2-frame batch through
its convolution cache), held to the plain float32 reference
(``benchmark/reference/cogvideox_sampling.py``) on seeded weights: the
transformer, the sampler's passes, the decoder, the schedule's closed forms,
RoPE on the video rows only, the published parameter names, the CLI, and
the faults the reference must catch."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from benchmark.chunked_weights import make_weights_by_tensor
from benchmark.reference import cogvideox_sampling as ref
from multimodal_diffusion_torch.infer import sample_cogvideox as sampler
from multimodal_diffusion_torch.models import cogvideox
from multimodal_diffusion_torch.models import cogvideox_vae
from multimodal_diffusion_torch.models.cogvideox_vae import frame_batches
from multimodal_diffusion_torch.ops import schedule as S

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = json.loads((ROOT / "benchmark" / "configs" / "cogvideox-5b.json").read_text())["config"]
TOL = 1e-4  # fp32 on both sides: summation order only


def tiny_cfg(steps=4):
    cfg = copy.deepcopy(PUBLISHED)
    cfg["mixed_precision"] = "fp32"
    cfg["model"]["core"].update(d_model=64, n_heads=2, n_layers=2, text_embed_dim=16,
                                time_embed_dim=24, axes_dim=[8, 12, 12])
    cfg["model"]["vae"].update(block_out_channels=[8, 16, 16, 32], norm_num_groups=4)
    cfg["text"]["max_sequence_length"] = 8
    cfg["sampling"].update(frames=17, height=32, width=48, steps=steps)
    return cfg


def rel(got, want):
    return float((got.float() - want).norm() / want.norm())


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    cfg = tiny_cfg()
    W = make_weights_by_tensor(ref.param_shapes(cfg), 2**35 + 7, "cpu", ref.is_norm_scale,
                               torch.float32)
    model, vae = sampler.build_cogvideox(cfg, "cpu", W)
    return cfg, W, model, vae


def inputs(seed=3):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, 5, 16, 4, 6, generator=g), torch.randn(2, 8, 16, generator=g),
            torch.randn(1, 8, 16, generator=g), torch.randn(1, 8, 16, generator=g))


class Passes:
    """Keeps each forward's input latent (the first half of its CFG batch)
    and the latent handed to the decoder."""

    def __init__(self, model, vae):
        self.forward, self.decode = model.forward, vae.decode
        model.forward, vae.decode = self.model_forward, self.vae_decode
        self.seen, self.z = [], None

    def model_forward(self, x, ctx, t):
        self.seen.append(x[:x.shape[0] // 2].clone())
        return self.forward(x, ctx, t)

    def vae_decode(self, z, *a):
        self.z = z.permute(0, 2, 1, 3, 4).clone()
        return self.decode(z, *a)


def test_transformer_matches_the_reference(tiny):
    cfg, W, model, _ = tiny
    x, ctx, _, _ = inputs()
    with torch.no_grad():
        got = model(x, ctx, torch.tensor([999, 419]))
    assert rel(got[:1], ref.velocity(W, cfg, x[:1], ctx[:1], 999)) < TOL
    assert rel(got[1:], ref.velocity(W, cfg, x[1:], ctx[1:], 419)) < TOL


def test_sampler_passes_latent_and_video_match_the_reference(tiny):
    cfg, W, model, vae = tiny
    _, _, text, negative = inputs(4)
    m2, v2 = sampler.build_cogvideox(cfg, "cpu", W)
    taps = Passes(m2, v2)
    out = sampler.sample_cogvideox(cfg, m2, v2, text, negative, "cpu",
                                   torch.Generator().manual_seed(9))["video"]
    noise = torch.randn(sampler.latent_shape(cfg, 1), generator=torch.Generator().manual_seed(9))
    z_ref, seen = ref.sample(W, cfg, noise, text, negative, keep=range(1, 5))
    assert len(taps.seen) == 4
    for k in range(1, 5):
        assert rel(taps.seen[k - 1], seen[k][0]) < TOL
    assert rel(taps.z, z_ref) < TOL
    want = ref.video_values(ref.decode(W, cfg, z_ref))
    assert out.shape == (1, 17, 32, 48, 3) and out.dtype == np.uint8
    # one rounding to uint8 (0.5), plus the summation order at a tie
    assert float(np.abs(out.astype(np.float32) - want.numpy()).max()) <= 0.51


def test_decoder_matches_the_reference_in_frame_batches(tiny):
    cfg, W, _, vae = tiny
    z = torch.randn(1, 5, 16, 4, 6, generator=torch.Generator().manual_seed(5))
    assert frame_batches(5) == ((0, 3), (3, 5)) and len(frame_batches(13)) == 6
    with torch.no_grad():
        got = vae.decode(z.permute(0, 2, 1, 3, 4))
    assert got.shape == (1, 3, 17, 32, 48)
    assert rel(got, ref.decode(W, cfg, z)) < TOL


def test_rope_rotates_the_video_rows_only():
    ids = cogvideox.position_ids(8, 5, 2, 3, "cpu")
    cos, sin = cogvideox.rope_tables(ids, (8, 12, 12), 10_000.0)
    assert bool((cos[:8] == 1).all()) and bool((sin[:8] == 0).all())
    q = torch.randn(1, 2, 8 + 30, 32)
    out = cogvideox.apply_rope(q, cos, sin)
    assert torch.equal(out[:, :, :8], q[:, :, :8])  # text rows: exactly unrotated
    assert float((out[:, :, 9:] - q[:, :, 9:]).abs().max()) > 0.1  # video rows past (0, 0, 0)
    # the joint tables give what rotating the video rows alone gives
    alone = cogvideox.apply_rope(q[:, :, 8:], cos[8:], sin[8:])
    assert torch.equal(out[:, :, 8:], alone)
    # the axes: a token's pairs are its (frame, row, col) angles in that order
    assert ids[8 + 6 * 2 + 3 * 1 + 2].tolist() == [2.0, 1.0, 2.0]


@pytest.mark.parametrize("fault", ["mod", "rope", "update", "one_batch"])
def test_planted_faults_fail_the_reference(tiny, fault, monkeypatch):
    """Each fault moves what the reference compares by far more than the
    tolerance: swapped text and video modulation chunks, rotate-half RoPE,
    epsilon in place of v in the DDIM update, and a decode in one batch
    (another GroupNorm statistic and no cache)."""
    cfg, W, _, _ = tiny
    model, vae = sampler.build_cogvideox(cfg, "cpu", W)
    x, ctx, text, negative = inputs(6)
    if fault == "one_batch":
        z = x[:1]
        want = ref.decode(W, cfg, z)
        monkeypatch.setattr(cogvideox_vae, "frame_batches", lambda f: ((0, f),))
        with torch.no_grad():
            got = vae.decode(z.permute(0, 2, 1, 3, 4))
        assert rel(got, want) > 100 * TOL
        monkeypatch.setattr(ref, "FRAME_BATCH", 5)  # the reference's own decode in one batch
        assert rel(ref.decode(W, cfg, z), want) > 100 * TOL
        return
    if fault == "mod":
        for block in model.transformer_blocks:
            for norm in (block.norm1, block.norm2):
                f = norm.linear.forward
                monkeypatch.setattr(norm.linear, "forward",
                                    lambda e, f=f: torch.cat(f(e).chunk(2, -1)[::-1], -1))
    if fault == "rope":
        def rotate_half(q, cos, sin):
            q0, q1 = q.chunk(2, dim=-1)
            return torch.cat([cos * q0 - sin * q1, sin * q0 + cos * q1], dim=-1)

        monkeypatch.setattr(cogvideox, "apply_rope", rotate_half)
    if fault == "update":
        step = sampler.ddim_step
        monkeypatch.setattr(sampler, "ddim_step", lambda *a, **k: step(*a, **dict(k, param="eps")))
        taps = Passes(model, vae)
        sampler.sample_cogvideox(cfg, model, vae, text, negative, "cpu",
                                 torch.Generator().manual_seed(2))
        noise = torch.randn(sampler.latent_shape(cfg, 1),
                            generator=torch.Generator().manual_seed(2))
        _, seen = ref.sample(W, cfg, noise, text, negative, keep=[2])
        assert rel(taps.seen[1], seen[2][0]) > 100 * TOL
        return
    with torch.no_grad():
        got = model(x[:1], ctx[:1], torch.tensor([799]))
    assert rel(got, ref.velocity(W, cfg, x[:1], ctx[:1], 799)) > 100 * TOL


def test_schedule_closed_forms():
    betas = S.make_beta_schedule(1000, "scaled_linear", 0.00085, 0.012)
    want = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000) ** 2
    np.testing.assert_allclose(betas, want, rtol=1e-6)
    abar = S.alphas_cumprod_from_betas(betas)[1]
    z = S.rescale_zero_terminal_snr(abar)
    assert z[-1] == 0.0 and z[0] == pytest.approx(abar[0], rel=1e-6)
    # sqrt(alpha_bar) is an affine map of the original's: shifted to 0 at T,
    # scaled to keep the first
    s, s0 = np.sqrt(abar.astype(np.float64)), np.sqrt(z.astype(np.float64))
    np.testing.assert_allclose(s0, (s - s[-1]) * s[0] / (s[0] - s[-1]), rtol=1e-5, atol=1e-7)
    ts = S.make_sampling_schedule(1000, 50, "trailing")
    assert ts.tolist() == list(range(999, 0, -20)) + [-1]
    assert S.make_sampling_schedule(1000, 50).tolist() == \
        np.round(np.linspace(999, -1, 51)).astype(int).tolist()  # the default, unchanged
    abar_c, ts_c = sampler.schedule(PUBLISHED, 50)
    ref_abar, ref_ts = ref.schedule(PUBLISHED)
    assert ts_c.tolist() == ref_ts
    np.testing.assert_allclose(abar_c, ref_abar, rtol=2e-5, atol=1e-8)
    # the v-prediction DDIM step where alpha_bar is 0 (the first step)
    x, v = torch.randn(3, 4), torch.randn(3, 4)
    t, tp = torch.full((3,), 999), torch.full((3,), 979)
    got = S.ddim_step(x, t, tp, v, torch.as_tensor(abar_c), param="v")
    want = ref.ddim_update(x, v, float(ref_abar[999]), float(ref_abar[979]))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_published_parameter_names_and_sizes():
    """The names and shapes of diffusers' CogVideoXTransformer3DModel and
    AutoencoderKLCogVideoX decoder at the 5B's widths, on the meta device."""
    with torch.device("meta"):
        model = cogvideox.CogVideoXTransformer(cogvideox.CogVideoXConfig.from_config(PUBLISHED))
        vae = sampler.CogVideoXVAEDecoder(sampler.VAEConfig.from_config(PUBLISHED))
    sd = {**{k: tuple(v.shape) for k, v in model.state_dict().items()},
          **{"vae." + k: tuple(v.shape) for k, v in vae.state_dict().items()}}
    assert sd == ref.param_shapes(PUBLISHED)
    for name, shape in {"patch_embed.proj.weight": (3072, 16, 2, 2),
                        "patch_embed.text_proj.weight": (3072, 4096),
                        "time_embedding.linear_1.weight": (512, 3072),
                        "transformer_blocks.41.norm1.linear.weight": (18432, 512),
                        "transformer_blocks.0.attn1.norm_q.weight": (64,),
                        "transformer_blocks.0.attn1.to_out.0.bias": (3072,),
                        "transformer_blocks.0.ff.net.0.proj.weight": (12288, 3072),
                        "transformer_blocks.0.ff.net.2.weight": (3072, 12288),
                        "norm_out.linear.weight": (6144, 512), "proj_out.weight": (64, 3072),
                        "vae.decoder.conv_in.conv.weight": (512, 16, 3, 3, 3),
                        "vae.decoder.mid_block.resnets.0.norm1.conv_y.conv.weight":
                            (512, 16, 1, 1, 1),
                        "vae.decoder.up_blocks.1.resnets.0.conv_shortcut.weight":
                            (256, 512, 1, 1, 1),
                        "vae.decoder.up_blocks.2.upsamplers.0.conv.weight": (256, 256, 3, 3),
                        "vae.decoder.norm_out.norm_layer.weight": (128,),
                        "vae.decoder.conv_out.conv.weight": (3, 128, 3, 3, 3)}.items():
        assert sd[name] == shape, name
    n = sum(int(np.prod(s)) for k, s in sd.items() if not k.startswith("vae."))
    assert n == pytest.approx(5.57e9, rel=3e-3)
    assert "vae.decoder.up_blocks.3.upsamplers.0.conv.weight" not in sd


def test_cli_writes_the_videos(tmp_path, tiny):
    cfg, _, _, _ = tiny
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    g = np.random.default_rng(0)
    np.savez(tmp_path / "e.npz", text=g.standard_normal((2, 8, 16), np.float32),
             negative=g.standard_normal((8, 16), np.float32))
    paths = sampler.main(["--config", str(tmp_path / "tiny.yaml"), "--text-embeds",
                          str(tmp_path / "e.npz"), "--steps", "2", "--device", "cpu",
                          "--out-dir", str(tmp_path / "out")])
    assert len(paths) == 2 and len(list(paths[1].glob("frame_*.jpg"))) == 17
    flux_cfg = dict(cfg, model=dict(cfg["model"], family="flux"))
    (tmp_path / "flux.yaml").write_text(yaml.safe_dump(flux_cfg))
    with pytest.raises(SystemExit):
        sampler.main(["--config", str(tmp_path / "flux.yaml"), "--text-embeds",
                      str(tmp_path / "e.npz"), "--device", "cpu"])
