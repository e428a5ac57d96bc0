"""The port's modules against the JAX modules on weights carried across by
utils/convert.py, fp32: 1e-5, and 1e-4 for the 3-D convolutions (longer
sums over 27*C taps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_model_and_params, perturb, shrunk_cfg, t2n, torch_model
from multimodal_diffusion_torch.models import adapters as TA
from multimodal_diffusion_torch.models import mmdit as TM
from multimodal_diffusion_torch.utils.convert import jax_params_to_state_dict
from multimodal_diffusion_tpu.models import adapters as JA
from multimodal_diffusion_tpu.models import mmdit as JM


@pytest.fixture(scope="module")
def models():
    cfg = shrunk_cfg()
    jm, params = jax_model_and_params(cfg)
    return cfg, jm, params, torch_model(cfg, params)


def _apply(jm, params, *args, method):
    return np.array(jm.apply({"params": params}, *args, method=method))


def _rand(shape, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def test_rmsnorm_including_zero_rows():
    x = _rand((2, 5, 64), 0)
    x[0, 1] = 0.0
    x[1, :] = 0.0
    jn = JM.RMSNorm()
    params = perturb(jn.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tn = TM.RMSNorm(64)
    tn.load_state_dict(jax_params_to_state_dict(params))
    out = t2n(tn(torch.from_numpy(x)))
    np.testing.assert_allclose(out, np.asarray(jn.apply({"params": params}, x)),
                               rtol=1e-5, atol=1e-5)
    assert np.all(out[1] == 0.0) and np.all(out[0, 1] == 0.0)


def _core_cfg(**kw):
    base = dict(d_model=64, n_layers=2, n_heads=4, mlp_ratio=2.0, dropout=0.0)
    base.update(kw)
    return base


@pytest.mark.parametrize("kw,masked", [
    ({}, False),
    ({}, True),
    ({"seq_multiple": 8}, False),
    ({"seq_multiple": 8}, True),
    ({"norm": "layernorm", "gelu_exact": False}, True),
    ({"rope": True}, False),
])
def test_mmdit(kw, masked):
    B, N = 2, 29
    x = _rand((B, N, 64), 1)
    kpm = None
    if masked:
        kpm = np.zeros((B, N), bool)
        kpm[0, 20:] = True
        kpm[1, :3] = True
    jcore = JM.MMDiT(JM.MMDiTConfig.from_dict(_core_cfg(**kw)))
    params = perturb(jcore.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    jout = np.asarray(jcore.apply({"params": params}, jnp.asarray(x),
                                  None if kpm is None else jnp.asarray(kpm)))
    tcore = TM.MMDiT(TM.MMDiTConfig.from_dict(_core_cfg(**kw)))
    sd = jax_params_to_state_dict({"core": params})
    tcore.load_state_dict({k[len("core."):]: v for k, v in sd.items()}, strict=True)
    tout = t2n(tcore(torch.from_numpy(x),
                     None if kpm is None else torch.from_numpy(kpm)))
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)


def test_mmdit_quant_raises():
    """int8 is ported (tests/test_torch_quant.py); an unknown value raises
    the JAX package's ValueError."""
    with pytest.raises(ValueError, match="quant"):
        TM.MMDiT(TM.MMDiTConfig.from_dict(_core_cfg(quant="fp4")))
    TM.MMDiT(TM.MMDiTConfig.from_dict(_core_cfg(quant="int8")))


def test_heads(models):
    _, jm, params, tm = models
    hv, ha = _rand((2, 16, 64), 2), _rand((2, 12, 64), 3)
    j = jm.apply({"params": params}, {"video": hv, "audio": ha},
                 method=lambda m, x: m.head(x, deterministic=True))
    t = tm.head({"video": torch.from_numpy(hv), "audio": torch.from_numpy(ha)})
    for m in ("video", "audio"):
        np.testing.assert_allclose(t2n(t[m]), np.asarray(j[m]), rtol=1e-5, atol=1e-5)


def test_adapters_and_embeddings(models):
    """LinearAdapter, ModalityEmbedding and learned 1-D/3-D positions through
    the joint model's embed_tokens (timestep ADD and keep-mask included)."""
    _, jm, params, tm = models
    tv, ta = _rand((2, 16, 16), 4), _rand((2, 12, 32), 5)
    t_v, t_a = np.array([0, 500], np.int32), np.array([999, 3], np.int32)
    keep = np.array([1.0, 0.0], np.float32)
    jx, _ = jm.apply({"params": params}, tv, ta, t_v, t_a, (2, 4, 2), keep, None,
                     method=jm.embed_tokens)
    tx, nv = tm.embed_tokens(torch.from_numpy(tv), torch.from_numpy(ta),
                             torch.from_numpy(t_v), torch.from_numpy(t_a), (2, 4, 2),
                             torch.from_numpy(keep), None)
    assert nv == 16
    np.testing.assert_allclose(t2n(tx), np.asarray(jx), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [7, 37])
def test_sin_positional_embeddings(n):
    j1 = np.asarray(JA.PositionalEmbedding1D(64, mode="sin").apply({}, n))
    np.testing.assert_allclose(t2n(TA.PositionalEmbedding1D(64, mode="sin")(n)), j1,
                               rtol=1e-6, atol=1e-6)
    j3 = np.asarray(JA.PositionalEmbedding3D(64, mode="sin").apply({}, 1, 1, n))
    np.testing.assert_allclose(t2n(TA.PositionalEmbedding3D(64, mode="sin")(1, 1, n)), j3,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["sin", "mlp"])
def test_timestep_embedder(mode):
    t = np.array([0, 10, 999], np.int32)
    je = JA.TimestepEmbedder(dim=64, mode=mode)
    params = perturb(je.init(jax.random.PRNGKey(0), jnp.asarray(t)).get("params", {}))
    te = TA.TimestepEmbedder(dim=64, mode=mode)
    te.load_state_dict(jax_params_to_state_dict(params), strict=True)
    np.testing.assert_allclose(t2n(te(torch.from_numpy(t))),
                               np.asarray(je.apply({"params": params}, t)),
                               rtol=1e-5, atol=1e-5)


def test_video_vae_encode(models):
    _, jm, params, tm = models
    x = _rand((2, 3, 8, 32, 32), 6, 0.0, 1.0)
    j = _apply(jm, params, x, method=jm.encode_video)
    t = t2n(tm.encode_video(torch.from_numpy(x)))
    assert t.shape == (2, 8, 2, 4, 4)
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def test_video_vae_decode(models):
    _, jm, params, tm = models
    z = _rand((2, 8, 2, 4, 4), 7)
    j = _apply(jm, params, z, method=jm.decode_video)
    t = t2n(tm.decode_video(torch.from_numpy(z)))
    assert t.shape == (2, 3, 8, 32, 32)
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size", [(8, 32, 32), (12, 40, 24)])
def test_trilinear_upsample_matches_jax_image_resize(size):
    """F.interpolate(align_corners=False) == jax.image.resize('trilinear')
    when upsampling, edges included (both clamp to the border sample)."""
    h = _rand((2, 5, 2, 4, 4), 8)
    j = jax.image.resize(jnp.asarray(h.transpose(0, 2, 3, 4, 1)), (2, *size, 5),
                         method="trilinear")
    t = torch.nn.functional.interpolate(torch.from_numpy(h), size=size,
                                        mode="trilinear", align_corners=False)
    np.testing.assert_allclose(t2n(t), np.asarray(j).transpose(0, 4, 1, 2, 3),
                               rtol=1e-6, atol=1e-6)


def test_audio_codec_encode_decode(models):
    _, jm, params, tm = models
    wav = _rand((2, 1, 8000), 9, -1.0, 1.0)
    jz = _apply(jm, params, wav, method=jm.encode_audio)
    tz = tm.encode_audio(torch.from_numpy(wav))
    assert tz.shape == (2, 8, 50)
    np.testing.assert_allclose(t2n(tz), jz, rtol=1e-5, atol=1e-5)
    jw = _apply(jm, params, jz, method=jm.decode_audio)
    tw = t2n(tm.decode_audio(torch.from_numpy(jz)))
    assert tw.shape == (2, 1, 8000)
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-5)


def test_denoise_latents(models):
    _, jm, params, tm = models
    z_v, z_a = _rand((2, 8, 2, 4, 4), 10), _rand((2, 8, 50), 11)
    t_v, t_a = np.array([0, 0], np.int32), np.array([700, 20], np.int32)
    keep_v = np.array([1.0, 0.0], np.float32)
    j = jm.apply({"params": params}, z_v, z_a, t_v, t_a, keep_v, None, True,
                 method=jm.denoise_latents)
    t = tm.denoise_latents(*(torch.from_numpy(a) for a in (z_v, z_a, t_v, t_a, keep_v)))
    for key in ("eps_v", "eps_a", "h_v", "h_a"):
        np.testing.assert_allclose(t2n(t[key]), np.asarray(j[key]), rtol=1e-5, atol=1e-5)
