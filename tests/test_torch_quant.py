"""The port's W8A8 int8 core and bf16 serving weights against the JAX package,
on the CPU at small sizes. The first case of each group mirrors the JAX
package's own test of the same contract (tests/test_quant.py):

  * ``quantize_rowwise``: integers and scales bit-equal for fp32 and bf16
    inputs, within the round-trip bound absmax / 254;
  * ``int8_linear`` against a flax ``Dense(dot_general=int8_dot_general)``
    on the same weights: bit-equal at fp32 and bf16 compute (under bf16 the
    bf16-rounded weight is quantized, as flax promotes it before the dot);
    the non-Dense pattern raises;
  * the int8 MMDiT against JAX's int8 MMDiT on converted weights, and each
    within 5e-2 of its unquantized model; a training pass bit-equal with and
    without int8; an unknown ``quant`` raises ``ValueError``;
  * ``model.core.quant`` through both families' configs and the
    ``configs/int8.yaml`` overlay;
  * the sync-guided gradient under int8 against the JAX sampler's
    ``sync_loss_of`` gradient;
  * ``cast_params_bf16`` bit-equal to JAX's through ``utils/convert.py``,
    and the bf16-compute model on cast weights against JAX's.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import linen as nn
from flax.core import meta

from _torch_parity import (jax_model_and_params, shrunk_cfg, shrunk_flagship_cfg, t2n,
                           torch_model)
from multimodal_diffusion_torch.infer import sample_clip as TSC
from multimodal_diffusion_torch.models import latent_text2image as TL
from multimodal_diffusion_torch.models import mmdit as TM
from multimodal_diffusion_torch.models.diffusion import AVDiffusionConfig as TAVConfig
from multimodal_diffusion_torch.ops import quant as TQ
from multimodal_diffusion_torch.train import losses as TLS
from multimodal_diffusion_torch.train.checkpoint import cast_params_bf16
from multimodal_diffusion_torch.utils.convert import (jax_params_to_state_dict,
                                                      load_jax_params)
from multimodal_diffusion_torch.utils.io import load_config as t_load_config
from multimodal_diffusion_tpu.models import mmdit as JM
from multimodal_diffusion_tpu.models.diffusion import AVDiffusionConfig as JAVConfig
from multimodal_diffusion_tpu.models.diffusion import AVDiffusionModel as JAVModel
from multimodal_diffusion_tpu.ops import quant as JQ
from multimodal_diffusion_tpu.train import checkpoint as JCK
from multimodal_diffusion_tpu.train import losses as JLS
from multimodal_diffusion_tpu.utils.io import load_config

REPO = Path(__file__).resolve().parents[1]
T = torch.from_numpy
JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jnp(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def _np(x) -> np.ndarray:
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# quantize_rowwise and int8_linear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_quantize_rowwise_roundtrip_bound_and_bits_match_jax(tdt):
    """JAX's test_quantize_rowwise_roundtrip_bound on its own input, then the
    same input in the working dtype: integers and scales bit-equal."""
    x = jax.random.normal(jax.random.PRNGKey(0), (64, 128), jnp.float32).astype(JAX_DT[tdt])
    jq, js = JQ.quantize_rowwise(x, axis=-1)
    tx = T(_np(x)).to(tdt)
    q, s = TQ.quantize_rowwise(tx, dim=-1)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (64, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = q.float() * s
    bound = np.broadcast_to(np.abs(tx.float().numpy()).max(axis=-1, keepdims=True) / 254.0
                            + 1e-7, x.shape)
    np.testing.assert_array_less(np.abs((back - tx.float()).numpy()), bound)
    # along the other axis (the weight's per-output-channel scales)
    jq0, js0 = JQ.quantize_rowwise(x, axis=0)
    q0, s0 = TQ.quantize_rowwise(tx, dim=0)
    np.testing.assert_array_equal(q0.numpy(), np.asarray(jq0))
    np.testing.assert_array_equal(s0.numpy(), np.asarray(js0))


def test_quantize_rowwise_rounds_half_to_even_and_clips():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]])
    q, s = TQ.quantize_rowwise(x)
    assert float(s) == 1.0 and q.tolist() == [[127, 0, 2, 2, 0, -2]]
    q, s = TQ.quantize_rowwise(torch.zeros(2, 8))  # eps keeps the scale positive
    assert (q == 0).all() and torch.all(s == torch.tensor(1e-8) / 127.0)


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows", [256, 5])
def test_int8_linear_matches_flax_dense(tdt, rows):
    """JAX's test_int8_dot_general_matches_fp32 (within 2e-2 of the exact
    product), then against flax Dense(dot_general=int8_dot_general) with a
    bias on the same weights: bit-equal in both compute dtypes."""
    k0, k1 = jax.random.split(jax.random.PRNGKey(1))
    x = np.array(jax.random.normal(k0, (rows, 128), jnp.float32))
    w = np.array(jax.random.normal(k1, (128, 192), jnp.float32)) / np.sqrt(128)
    b = np.random.default_rng(2).normal(size=(192,)).astype(np.float32)
    tw = T(np.ascontiguousarray(w.T))
    if tdt == torch.float32:
        got = TQ.int8_linear(T(x), tw, None, torch.float32)
        assert _rel(got.numpy(), x @ w) < 2e-2
    dense = nn.Dense(192, dtype=JAX_DT[tdt], dot_general=JQ.int8_dot_general)
    want = dense.apply({"params": {"kernel": w, "bias": b}}, jnp.asarray(x))
    got = TQ.int8_linear(T(x), tw, T(b), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    # the weight quantized once ahead (Int8Weight) gives the same bits
    cached = TQ.Int8Weight()(tw, tdt)
    np.testing.assert_array_equal(TQ.int8_linear(T(x), tw, T(b), tdt, cached).float().numpy(),
                                  _np(want))


def test_int8_linear_rejects_non_dense_pattern():
    """JAX's test_int8_dot_general_rejects_non_dense_pattern: a contraction
    other than x's last dim against the weight's input dim raises."""
    with pytest.raises(NotImplementedError):
        JQ.int8_dot_general(jnp.zeros((4, 8, 8)), jnp.zeros((4, 8, 8)), (((0,), (0,)), ((), ())))
    with pytest.raises(NotImplementedError, match="Dense pattern"):
        TQ.int8_linear(torch.zeros(4, 8, 8), torch.zeros(4, 8, 8), None, torch.float32)
    with pytest.raises(NotImplementedError, match="Dense pattern"):
        TQ.int8_linear(torch.zeros(4, 8), torch.zeros(16, 4), None, torch.float32)


def test_int_mm_shapes_the_card_serves():
    """torch._int_mm takes K and N in multiples of 8 (M is padded to 17
    rows); anything else raises ValueError on the card, with no fallback."""
    assert TQ.int_mm_unservable(1024, 3072) is None
    assert TQ.int_mm_unservable(2048, 512) is None
    assert "K=12" in TQ.int_mm_unservable(12, 64)
    assert "N=20" in TQ.int_mm_unservable(64, 20)
    assert TQ.INT_MM_MIN_ROWS == 17


def test_int8_weight_is_remade_only_when_the_parameter_changes():
    w = torch.nn.Parameter(torch.randn(16, 8))
    cache = TQ.Int8Weight()
    with torch.inference_mode():
        q1, s1 = cache(w, torch.float32)
    assert not q1.is_inference() and not s1.is_inference()  # usable under autograd
    assert cache(w, torch.float32)[0] is q1
    with torch.no_grad():
        w.mul_(2.0)  # an in-place update bumps the version
    q2, s2 = cache(w, torch.float32)
    assert q2 is not q1 and torch.equal(s2, 2 * s1)
    assert cache(w, torch.bfloat16)[0] is not q2


# ---------------------------------------------------------------------------
# the int8 MMDiT
# ---------------------------------------------------------------------------

CORE = dict(d_model=64, n_layers=2, n_heads=4, mlp_ratio=2.0, dropout=0.0, attn_dropout=0.0,
            norm="rmsnorm", token_dropout=0.0)


def _jax_core(seed=3, **kw):
    x = jax.random.normal(jax.random.PRNGKey(2), (2, 96, 64), jnp.float32)
    ref = JM.MMDiT(JM.MMDiTConfig(**{**CORE, **kw}))
    params = meta.unbox(ref.init({"params": jax.random.PRNGKey(seed)}, x)["params"])
    return x, params


def _torch_core(params, **kw):
    from multimodal_diffusion_torch.utils.convert import jax_params_to_state_dict as conv

    core = TM.MMDiT(TM.MMDiTConfig(**{**CORE, **kw}))
    sd = {k[len("core."):]: v for k, v in conv({"core": params}).items()}
    core.load_state_dict(sd, strict=True)
    return core.eval()


def test_mmdit_int8_eval_matches_jax_int8():
    """Deterministic passes of both int8 cores on the same weights: the first
    projection's weight integers and scales are bit-equal, and so are its
    activation integers (the RMSNorm outputs differ in the last fp32 ulp of
    about a third of their elements, the mean being summed in another
    order, and no integer flips at this input). Later, such an ulp can flip
    an activation's rounding by one step: one flip moves that row's output
    by about 1/127 of the step's scale, so the outputs are held within 5e-3
    of their largest magnitude (the reading: 6.2e-4)."""
    x, params = _jax_core()
    jout = JM.MMDiT(JM.MMDiTConfig(**CORE, quant="int8")).apply({"params": params}, x,
                                                                deterministic=True)
    core = _torch_core(params, quant="int8")
    with torch.no_grad():
        tout = core(T(np.array(x)))
        qkv = core.blocks[0].attn.qkv
        w8, s_w = qkv.int8_weight(qkv.weight, torch.float32)
        h = core.blocks[0].norm1(T(np.array(x)))
    kernel = params["block_0"]["attn"]["qkv"]["kernel"]
    jw8, js_w = JQ.quantize_rowwise(kernel, axis=0)
    np.testing.assert_array_equal(w8.numpy(), np.asarray(jw8).T)
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(js_w)[0])
    jh = JM.RMSNorm().apply({"params": params["block_0"]["RMSNorm_0"]}, x)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(TQ.quantize_rowwise(h)[0].numpy(),
                                  np.asarray(JQ.quantize_rowwise(jh)[0]))
    jo = np.asarray(jout)
    np.testing.assert_allclose(tout.numpy(), jo, rtol=0, atol=5e-3 * np.abs(jo).max())


def test_mmdit_int8_tracks_unquantized_in_each_framework():
    """JAX's test_mmdit_int8_inference_tracks_fp32, and the port's pair on the
    same weights: within 5e-2 relative and not equal."""
    x, params = _jax_core()
    j_ref = JM.MMDiT(JM.MMDiTConfig(**CORE)).apply({"params": params}, x, deterministic=True)
    j_q = JM.MMDiT(JM.MMDiTConfig(**CORE, quant="int8")).apply({"params": params}, x,
                                                                deterministic=True)
    with torch.no_grad():
        t_ref = _torch_core(params)(T(np.array(x))).numpy()
        t_q = _torch_core(params, quant="int8")(T(np.array(x))).numpy()
    for ref, q in ((np.asarray(j_ref), np.asarray(j_q)), (t_ref, t_q)):
        assert _rel(q, ref) < 5e-2
        assert not np.allclose(q, ref)


def test_mmdit_int8_training_pass_is_exactly_unquantized():
    """JAX's test of the same name on the port: under train() (dropout on,
    the same generator state) outputs and every grad are bit-equal with and
    without quant int8."""
    x, params = _jax_core(seed=5)
    kw = dict(dropout=0.1, attn_dropout=0.1, token_dropout=0.1)
    outs, grads = [], []
    for quant in ("none", "int8"):
        core = _torch_core(params, quant=quant, **kw).train()
        TM.set_dropout_generator(core, torch.Generator().manual_seed(6))
        out = core(T(np.array(x)))
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out ** 2).sum(), list(core.parameters())))
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_mmdit_rejects_unknown_quant():
    m = JM.MMDiT(JM.MMDiTConfig(**CORE, quant="fp4"))
    with pytest.raises(ValueError, match="quant"):
        m.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8, 64)), deterministic=True)
    with pytest.raises(ValueError, match="quant"):
        TM.MMDiT(TM.MMDiTConfig(**CORE, quant="fp4"))


@pytest.mark.parametrize("family", ["av", "t2i"])
def test_config_plumbs_quant_to_core(family):
    """model.core.quant reaches the denoiser core (JAX's
    test_config_plumbs_quant_to_core) and the configs/int8.yaml overlay works
    for both families; the t2i text encoder's core stays unquantized."""
    if family == "av":
        from tests._tiny import tiny_cfg

        cfg = tiny_cfg()
        cfg["model"]["core"]["quant"] = "int8"
        assert JAVConfig.from_config(cfg).core.quant == "int8"
        assert TAVConfig.from_config(cfg).core.quant == "int8"
        files = (REPO / "configs" / "mvp.yaml", REPO / "configs" / "int8.yaml")
        t_cfg = TAVConfig.from_config(t_load_config(*files))
        assert t_cfg.core.quant == JAVConfig.from_config(load_config(*files)).core.quant == "int8"
        model = TSC.AVDiffusionModel(TAVConfig.from_config(cfg))
        core = model.core
    else:
        from multimodal_diffusion_tpu.models.latent_text2image import Text2ImageConfig

        files = (REPO / "configs" / "t2i_512.yaml", REPO / "configs" / "int8.yaml")
        t_cfg = TL.Text2ImageConfig.from_config(t_load_config(*files))
        j_cfg = Text2ImageConfig.from_config(load_config(*files))
        assert t_cfg.core.quant == j_cfg.core.quant == "int8"
        assert t_cfg.text.core.quant == j_cfg.text.core.quant == "none"
        small = dataclasses.replace(
            t_cfg, core=dataclasses.replace(t_cfg.core, d_model=32, n_layers=1, n_heads=2),
            text=dataclasses.replace(
                t_cfg.text, width=32,
                core=dataclasses.replace(t_cfg.text.core, d_model=32, n_layers=1, n_heads=2)),
            width=32)
        model = TL.Text2ImageModel(small)
        core = model.core
        assert all(m.int8_weight is None for m in model.text_encoder.modules()
                   if isinstance(m, TM.HotDense))
    hot = [m for m in core.modules() if isinstance(m, TM.HotDense)]
    assert len(hot) == 4 * len(core.blocks) and all(m.int8_weight is not None for m in hot)


# ---------------------------------------------------------------------------
# the sync-guided gradient under int8
# ---------------------------------------------------------------------------


def test_guided_gradient_under_int8_matches_jax():
    """The guided sampler's gradient: d InfoNCE(h_m, h_a) / d z of one
    deterministic B-sized pass (the JAX sampler's ``sync_loss_of``) on the
    int8 core, at the shrunk flagship config. Round and the int8 cast pass no
    gradient in either framework, so it flows through the activation scales
    only (absmax ties shared evenly); the two agree within 1e-3 of the
    gradient's largest magnitude, and differ from the unquantized gradient."""
    cfg = shrunk_flagship_cfg()
    cfg["model"]["core"]["quant"] = "int8"
    jm, params = jax_model_and_params(cfg, seed=5)
    tm = torch_model(cfg, params)
    B, tau = 2, 0.1
    rng = np.random.default_rng(40)
    video = rng.uniform(0, 1, (B, 3, 8, 32, 32)).astype(np.float32)
    z = rng.normal(size=(B, 8, 50)).astype(np.float32)
    var = {"params": params}
    z_prompt = jm.apply(var, jnp.asarray(video), method=jm.encode_video)
    tok_prompt = jm.apply(var, z_prompt, method=jm.tokenize_video)
    grid = tm.video_grid(z_prompt.shape)
    tok_m = jm.apply(var, jnp.asarray(video), method=jm.mouth_tokens)
    mgrid = tm.mouth_grid(8)
    onesB, tzB, t_tgt = jnp.ones((B,)), jnp.zeros((B,), jnp.int32), jnp.full((B,), 500)

    def j_grad(model, p):
        def sync_loss_of(z_x):
            tok_t = model.apply({"params": p}, z_x, method=model.tokenize_audio)
            out1 = model.apply({"params": p}, tok_prompt, tok_t, tzB, t_tgt, grid, onesB,
                               onesB, True, method=model.denoise_tokens, tok_m=tok_m,
                               keep_m=onesB, mouth_grid=mgrid)
            return JLS.sync_contrastive_loss(out1["h_m"], out1["h_a"], mgrid[0], weight=1.0,
                                             tau=tau)
        return np.asarray(jax.grad(sync_loss_of)(jnp.asarray(z)))

    def t_grad(model):
        z_x = T(z.copy()).requires_grad_(True)
        out1 = model.denoise_tokens(T(np.array(tok_prompt)), model.tokenize_audio(z_x),
                                    T(np.asarray(tzB)).long(), T(np.asarray(t_tgt)).long(),
                                    tuple(grid), torch.ones(B), torch.ones(B),
                                    tok_m=T(np.asarray(tok_m)), keep_m=torch.ones(B),
                                    mouth_grid=tuple(mgrid))
        loss = TLS.sync_contrastive_loss(out1["h_m"], out1["h_a"], mgrid[0], weight=1.0,
                                         tau=tau)
        return torch.autograd.grad(loss, z_x)[0].numpy()

    jg = j_grad(jm, params)
    tg = t_grad(tm)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-3 * np.abs(jg).max())
    assert all(p.grad is None for p in tm.parameters())
    plain = dict(cfg, model={**cfg["model"], "core": {**cfg["model"]["core"], "quant": "none"}})
    tg_plain = t_grad(torch_model(plain, params))
    assert not np.allclose(tg, tg_plain, rtol=0, atol=1e-3 * np.abs(jg).max())


# ---------------------------------------------------------------------------
# bf16 serving weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make_cfg", [shrunk_cfg, shrunk_flagship_cfg], ids=["mvp", "flagship"])
def test_cast_params_bf16_matches_jax(make_cfg):
    """The port's cast of the fp32 model, bit for bit the JAX package's
    cast_params_bf16 of the same params tree carried through
    utils/convert.py (leaf dtypes kept)."""
    cfg = make_cfg()
    _, params = jax_model_and_params(cfg, seed=7)
    want = jax_params_to_state_dict(JCK.cast_params_bf16(params), dtype=None)
    model = cast_params_bf16(torch_model(cfg, params))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.bfloat16 and v.dtype == torch.bfloat16, k
        assert torch.equal(got[k], v), k


def _bf16_cfg(make_cfg):
    cfg = make_cfg()
    cfg["mixed_precision"] = "bf16"
    return cfg


@pytest.mark.parametrize("make_cfg", [shrunk_cfg, shrunk_flagship_cfg], ids=["mvp", "flagship"])
def test_bf16_model_on_cast_weights_matches_jax(make_cfg):
    """Every module of the AV model at bf16 compute on bf16 serving weights
    (fp32 norms upcast them): the VideoVAE encode and decode, the codec, and
    one denoise_tokens (mouth tokens at the flagship), against the JAX model
    applied to cast_params_bf16(params) (not the conv VideoVAE's encode here:
    torch's CPU avg_pool3d has no bf16 kernel). Both frameworks
    round activations to bf16 (2^-8 relative) after every layer, in places
    that differ: denoise_tokens agrees within 3e-2 of its largest magnitude
    (readings 1.2e-2, 1.6e-2), the VAE and the codec, four bf16
    convolutions deep with GELU between, within 5e-2 (readings up to
    3.3e-2 for the codec's decode). The bf16 layers compute the same with
    and without the cast (the per-use cast rounds as the cast does); the
    fp32 norms read the rounded weights, as JAX's promote_dtype does."""
    cfg = _bf16_cfg(make_cfg)
    jm0, params = jax_model_and_params(cfg, seed=9)
    jm = JAVModel(JAVConfig.from_config(cfg, dtype=jnp.bfloat16))
    jp = JCK.cast_params_bf16(params)
    tm = TSC.AVDiffusionModel(TAVConfig.from_config(cfg, dtype=torch.bfloat16))
    load_jax_params(tm, params)
    cast_params_bf16(tm).eval()
    var = {"params": jp}
    rng = np.random.default_rng(41)
    B = 2
    video = rng.uniform(0, 1, (B, 3, 8, 32, 32)).astype(np.float32)
    wav = rng.uniform(-0.5, 0.5, (B, 1, 8000)).astype(np.float32)

    def close(t, j, what):
        j = _np(j)
        err = float(np.abs(t2n(t) - j).max() / max(np.abs(j).max(), 1e-6))
        assert err <= (5e-2 if what.startswith(("encode", "decode")) else 3e-2), (what, err)

    with torch.no_grad():
        zv = jm.apply(var, jnp.asarray(video), method=jm.encode_video)
        if tm.cfg.vae.arch == "patch":  # the CPU's avg_pool3d has no bf16 kernel
            close(tm.encode_video(T(video)), zv, "encode_video")
        close(tm.decode_video(T(_np(zv))), jm.apply(var, zv, method=jm.decode_video),
              "decode_video")
        za = jm.apply(var, jnp.asarray(wav), method=jm.encode_audio)
        close(tm.encode_audio(T(wav)), za, "encode_audio")
        close(tm.decode_audio(T(_np(za))), jm.apply(var, za, method=jm.decode_audio),
              "decode_audio")
        tok_v = jm.apply(var, zv, method=jm.tokenize_video)
        tok_a = jm.apply(var, za, method=jm.tokenize_audio)
        grid = tm.video_grid(zv.shape)
        t_v, t_a = np.array([0, 0]), np.array([10, 700])
        keep = np.array([1.0, 0.0], np.float32)
        kw_j, kw_t = {}, {}
        if tm.cfg.mouth_enabled:
            tok_m = jm.apply(var, jnp.asarray(video), method=jm.mouth_tokens)
            mgrid = tm.mouth_grid(8)
            kw_j = {"tok_m": tok_m, "keep_m": jnp.asarray(keep), "mouth_grid": mgrid}
            kw_t = {"tok_m": T(_np(tok_m)), "keep_m": T(keep), "mouth_grid": tuple(mgrid)}
        jo = jm.apply(var, tok_v, tok_a, jnp.asarray(t_v), jnp.asarray(t_a), grid,
                      jnp.asarray(keep), None, True, method=jm.denoise_tokens, **kw_j)
        to = tm.denoise_tokens(T(_np(tok_v)), T(_np(tok_a)), T(t_v), T(t_a), tuple(grid),
                               T(keep), None, **kw_t)
        for key in ("eps_v", "eps_a"):
            assert to[key].dtype == torch.bfloat16
            close(to[key], jo[key], key)


@pytest.mark.parametrize("direction", ["v2a", "a2v"])
def test_build_components_and_cli_take_bf16_params(tmp_path, direction):
    """build_components(bf16_params=True) casts once (bf16 compute configs
    only) and both directions sample; the CLI takes --bf16-params."""
    cfg = _bf16_cfg(shrunk_flagship_cfg)
    cfg["paths"] = {}
    model = TSC.build_components(cfg, device="cpu", bf16_params=True)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    fp32 = TSC.build_components({**cfg, "mixed_precision": "fp32"}, device="cpu",
                                bf16_params=True)
    assert all(p.dtype == torch.float32 for p in fp32.parameters())
    cfg["sampling"]["prompt_modality"] = "video" if direction == "v2a" else "audio"
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    from multimodal_diffusion_torch.media.audio_io import read_wav, write_wav
    from multimodal_diffusion_torch.media.video_io import write_frames

    rng = np.random.default_rng(3)
    if direction == "v2a":
        write_frames(rng.integers(0, 255, (8, 32, 32, 3), dtype=np.uint8), tmp_path / "in")
        out = tmp_path / "out.wav"
        TSC.main(["--config", str(cfg_path), "--frames", str(tmp_path / "in"),
                  "--out-audio", str(out), "--device", "cpu", "--bf16-params"])
        wav, _ = read_wav(out)
        assert wav.shape == (8000,) and np.isfinite(wav).all()
    else:
        write_wav(tmp_path / "in.wav", rng.uniform(-0.5, 0.5, 8000).astype(np.float32), 8000)
        TSC.main(["--config", str(cfg_path), "--audio", str(tmp_path / "in.wav"),
                  "--out-frames", str(tmp_path / "frames"), "--device", "cpu",
                  "--bf16-params"])
        assert len(list((tmp_path / "frames").glob("frame_*.jpg"))) == 8
