"""The text-conditioned families of the port against the JAX package, on the
CPU at tiny sizes (d=32, one layer; the denoiser cores pad their sequence to
a multiple of 8, so the masked tail is exercised):

* exact: ``tokenize_text``, ``pad_to_multiple``, ``patch_image`` /
  ``unpatch_image``, the uint8 conversion of decoded images;
* ``TextEncoder`` (tokens, pooled) within 1e-5; ``ImageVAE`` encode and
  decode (the variational mu / logv / kld too) within 1e-4, and its
  stride-2 "SAME" padding;
* ``Text2ImageModel.denoise`` / ``Text2AudioModel.denoise`` within 1e-5 with
  padded text; sampled latents and mels (ddim, ddim with eta, dpmpp_2m) from
  the JAX sampler's own draws within 1e-4 of their magnitude;
* the t2i train step: loss, every grad, and the parameters after one AdamW
  step against optax;
* the weight carry both ways, bit for bit; the kernels' plain version
  against the Pallas kernel in interpret mode at the t2i mask layout
  (N = 1152, Dh = 128);
* the ``sample_t2i`` CLI restoring a JAX orbax checkpoint and the port's own.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax.core import meta

from _torch_parity import perturb, t2n
from multimodal_diffusion_torch.infer import sample_t2i
from multimodal_diffusion_torch.models import image_diffusion as TI
from multimodal_diffusion_torch.models import latent_text2image as TL
from multimodal_diffusion_torch.models import text2audio_mel as TA
from multimodal_diffusion_torch.models import text_encoder as TE
from multimodal_diffusion_torch.models import vae_image2d as TV
from multimodal_diffusion_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from multimodal_diffusion_torch.ops import flash_attention as t_fa
from multimodal_diffusion_torch.ops import tokenize as TT
from multimodal_diffusion_torch.train.checkpoint import CheckpointManager
from multimodal_diffusion_torch.train.trainer import AdamW
from multimodal_diffusion_torch.utils.convert import (_leaves, jax_params_to_state_dict,
                                                      load_jax_params,
                                                      state_dict_to_jax_params)
from multimodal_diffusion_tpu.models import image_diffusion as JI
from multimodal_diffusion_tpu.models import latent_text2image as JL
from multimodal_diffusion_tpu.models import text2audio_mel as JA
from multimodal_diffusion_tpu.models import text_encoder as JE
from multimodal_diffusion_tpu.models import vae_image2d as JV
from multimodal_diffusion_tpu.models.mmdit import MMDiTConfig as JMMDiTConfig
from multimodal_diffusion_tpu.ops import schedule as JS
from multimodal_diffusion_tpu.ops import tokenize as JT
from multimodal_diffusion_tpu.ops.flash_attention import _flash_forward

PROMPTS = ["a red fox", "hello world, a longer prompt"]
NEGATIVE = ["blurry", ""]
MAX_LEN = 16


def t2i_cfg(variational: bool = False) -> dict:
    """A tiny configs/t2i_512.yaml: 16x16 images, a VAE of 2 stages (4x4x2
    latents, 4 image tokens of patch 2), text and core d=32, one layer, 2
    heads; the core pads 16 + 4 = 20 tokens to 24."""
    return {
        "seed": 3, "mixed_precision": "fp32",
        "image": {"size": 16, "variational": variational,
                  "latent": {"channels": 2, "s_down": 4},
                  "encoder": {"base": 8, "max_ch": 16, "blocks": 1}},
        "tokenizer": {"image": {"patch": 2}},
        "model": {"text": {"d_model": 32, "n_layers": 1, "n_heads": 2, "mlp_ratio": 2.0,
                           "max_len": MAX_LEN, "dropout": 0.0},
                  "core": {"d_model": 32, "n_layers": 1, "n_heads": 2, "mlp_ratio": 2.0,
                           "dropout": 0.0, "seq_multiple": 8}},
        "diffusion": {"image": {"steps": 20, "sampler_steps": 3, "schedule": "cosine"}},
        "sampling": {"guidance_scale": 4.0},
        "paths": {},
    }


def t2a_cfgs():
    """A tiny Text2AudioConfig in both frameworks: 16 mels x 12 frames at
    patch 4 (12 tokens; 16 + 12 = 28 padded to 32)."""
    kw = dict(n_mels=16, frames=12, patch_f=4, patch_t=4, width=32, steps=10, n_fft=256,
              hop=64, sr=8000)
    core = dict(d_model=32, n_layers=1, n_heads=2, mlp_ratio=2.0, dropout=0.0)
    jc = JA.Text2AudioConfig(
        text=JE.TextEncoderConfig(width=32, max_len=MAX_LEN, core=JMMDiTConfig(**core)),
        core=JMMDiTConfig(**core, seq_multiple=8), **kw)
    tc = TA.Text2AudioConfig(
        text=TE.TextEncoderConfig(width=32, max_len=MAX_LEN, core=TMMDiTConfig(**core)),
        core=TMMDiTConfig(**core, seq_multiple=8), **kw)
    return jc, tc


def _ids(prompts=PROMPTS):
    return JE.tokenize_text(prompts, MAX_LEN)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def t2i():
    """(cfg, JAX model, perturbed JAX params, port model on them, images)."""
    cfg = t2i_cfg()
    jm = JL.Text2ImageModel(JL.Text2ImageConfig.from_config(cfg))
    c = jm.cfg
    images = np.random.default_rng(0).uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    abar = JS.alphas_cumprod_from_betas(JS.make_beta_schedule(c.steps))[1]
    params = perturb(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(images),
                                      jnp.asarray(_ids()), jnp.zeros((2,), jnp.int32),
                                      jnp.zeros((2, c.vae.lat_ch, c.latent_hw, c.latent_hw)),
                                      jnp.asarray(abar))["params"], seed=4)
    tm = TL.Text2ImageModel(TL.Text2ImageConfig.from_config(cfg))
    load_jax_params(tm, params).eval()
    return cfg, jm, params, tm, images


@pytest.fixture(scope="module")
def t2a():
    jc, tc = t2a_cfgs()
    jm = JA.Text2AudioModel(jc)
    mels = np.random.default_rng(1).normal(size=(2, 1, 16, 12)).astype(np.float32)
    abar = JS.alphas_cumprod_from_betas(JS.make_beta_schedule(jc.steps))[1]
    params = perturb(jax.jit(jm.init)({"params": jax.random.PRNGKey(2)}, jnp.asarray(mels),
                             jnp.asarray(_ids()), jnp.zeros((2,), jnp.int32),
                             jnp.zeros_like(mels), jnp.asarray(abar))["params"], seed=5)
    tm = load_jax_params(TA.Text2AudioModel(tc), params).eval()
    return jm, params, tm, mels


# ---------------------------------------------------------------------------
# exact helpers
# ---------------------------------------------------------------------------


def test_tokenize_text_is_the_jax_package_s():
    texts = ["", "hi", "a photo of a tpu", "überraschung – ünïcödé", "x" * 40]
    for max_len in (8, 16, 77):
        np.testing.assert_array_equal(TE.tokenize_text(texts, max_len),
                                      JE.tokenize_text(texts, max_len))
    assert (TE.PAD_ID, TE.BOS_ID, TE.EOS_ID, TE.VOCAB) == (JE.PAD_ID, JE.BOS_ID, JE.EOS_ID,
                                                            JE.VOCAB)


@pytest.mark.parametrize("shape,multiple,axis,value", [
    ((2, 1101, 8), 128, 1, 0.0), ((3, 5), 4, -1, 1.5), ((2, 7, 3), 7, 1, 0.0),
    ((4, 6), 5, 0, -2.0)])
def test_pad_to_multiple_is_the_jax_package_s(shape, multiple, axis, value):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    j, j_amt = JT.pad_to_multiple(jnp.asarray(x), multiple, axis, value)
    t, t_amt = TT.pad_to_multiple(_t(x), multiple, axis, value)
    assert t_amt == j_amt
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_pad_to_multiple_pads_a_bool_mask_with_true():
    mask = np.zeros((2, 1101), bool)
    j, _ = JT.pad_to_multiple(jnp.asarray(mask), 128, -1, True)
    t, amt = TT.pad_to_multiple(_t(mask), 128, -1, True)
    assert amt == 51 and t.dtype == torch.bool
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("C,H,W,p", [(4, 8, 8, 2), (1, 16, 12, 4), (3, 6, 6, 3)])
def test_patch_and_unpatch_image_are_the_jax_package_s(C, H, W, p):
    x = np.random.default_rng(C).normal(size=(2, C, H, W)).astype(np.float32)
    jt = np.asarray(JI.patch_image(jnp.asarray(x), p))
    tt = TI.patch_image(_t(x), p)
    np.testing.assert_array_equal(tt.numpy(), jt)
    back = TI.unpatch_image(tt, C, H, W, p)
    np.testing.assert_array_equal(back.numpy(), np.asarray(JI.unpatch_image(jnp.asarray(jt),
                                                                             C, H, W, p)))
    np.testing.assert_array_equal(back.numpy(), x)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_text_encoder_matches_jax(t2i):
    _, jm, params, tm, _ = t2i
    ids = _ids(PROMPTS + [""])
    j_tok, j_pool = jm.apply({"params": params}, jnp.asarray(ids), method=jm.encode_text)
    with torch.no_grad():
        t_tok, t_pool = tm.encode_text(_t(ids))
    np.testing.assert_allclose(t_tok.numpy(), np.asarray(j_tok), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_pool.numpy(), np.asarray(j_pool), rtol=1e-5, atol=1e-5)


def _vae_pair(variational: bool, seed: int):
    cfg = t2i_cfg(variational)
    jcfg = JV.ImageVAEConfig.from_dict(cfg["image"])
    jv = JV.ImageVAE(jcfg)
    x = np.random.default_rng(seed).uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    params = perturb(jv.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"], seed)
    tv = load_jax_params(TV.ImageVAE(TV.ImageVAEConfig.from_dict(cfg["image"])), params)
    return jv, params, tv.eval(), x


@pytest.mark.parametrize("variational", [False, True], ids=["plain", "variational"])
def test_image_vae_matches_jax(variational):
    """encode (z = mu without noise; with the JAX draw, mu + noise * exp(logv
    / 2), so logv too), kld and decode within 1e-4."""
    jv, params, tv, x = _vae_pair(variational, seed=7 + variational)
    var = {"params": params}
    j_z, j_kld = jv.apply(var, jnp.asarray(x), method=jv.encode_with_kld)
    with torch.no_grad():
        t_z, t_kld = tv.encode_with_kld(_t(x))
        t_dec = tv.decode(_t(np.asarray(j_z)))
    assert t_z.shape == (2, 2, 4, 4)
    np.testing.assert_allclose(t_z.numpy(), np.asarray(j_z), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(jv.apply(var, j_z, method=jv.decode)),
                               rtol=1e-4, atol=1e-4)
    if not variational:
        assert t_kld is None and j_kld is None
        return
    np.testing.assert_allclose(float(t_kld), float(j_kld), rtol=1e-4, atol=1e-4)
    rng = jax.random.PRNGKey(11)
    j_zs, _ = jv.apply(var, jnp.asarray(x), rng, method=jv.encode_with_kld)
    noise = np.asarray(jax.random.normal(rng, (2, 4, 4, 2))).transpose(0, 3, 1, 2)  # NHWC draw
    with torch.no_grad():
        t_zs, _ = tv.encode_with_kld(_t(x), noise=_t(noise))
        drawn, _ = tv.encode_with_kld(_t(x), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(t_zs.numpy(), np.asarray(j_zs), rtol=1e-4, atol=1e-4)
    assert not torch.equal(drawn, t_z)


def test_strided_conv_pads_as_flax_same():
    """A stride-2 3x3 "SAME" convolution on an even size pads (0, 1) as flax
    does; nn.Conv2d(padding=1)'s symmetric (1, 1) reads other rows and
    disagrees."""
    import flax.linen as fnn

    x = np.random.default_rng(3).normal(size=(1, 16, 16, 4)).astype(np.float32)
    conv = fnn.Conv(6, (3, 3), strides=(2, 2), padding="SAME")
    params = perturb(conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 3)
    j = np.asarray(conv.apply({"params": params}, jnp.asarray(x))).transpose(0, 3, 1, 2)
    t = TV.Conv2d(4, 6, 3, stride=2)
    t.load_state_dict(jax_params_to_state_dict(params), strict=True)
    xt = _t(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        np.testing.assert_allclose(t(xt).numpy(), j, rtol=1e-5, atol=1e-5)
        symmetric = torch.nn.functional.conv2d(xt, t.weight, t.bias, 2, 1)
    assert symmetric.shape == t(xt).shape
    assert float((symmetric - _t(j)).abs().max()) > 1e-2
    assert TV.same_padding(16, 3, 2) == (0, 1) and TV.same_padding(15, 3, 2) == (1, 1)


def _denoise_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=shape).astype(np.float32)
    t = np.array([3, 17], np.int32)
    text = rng.normal(size=(2, MAX_LEN, 32)).astype(np.float32)
    keep = np.array([1.0, 0.0], np.float32)
    return z, t, text, _ids() == JE.PAD_ID, keep


@pytest.mark.parametrize("family", ["t2i", "t2a"])
def test_denoise_matches_jax(family, t2i, t2a):
    """The denoiser on padded text (and one sample's text dropped) within
    1e-5."""
    if family == "t2i":
        _, jm, params, tm, _ = t2i
        shape = (2, 2, 4, 4)
    else:
        jm, params, tm, _ = t2a
        shape = (2, 1, 16, 12)
    z, t, text, pad, keep = _denoise_inputs(shape, seed=21)
    j = jm.apply({"params": params}, *(jnp.asarray(a) for a in (z, t, text, pad, keep)),
                 method=jm.denoise)
    with torch.no_grad():
        out = tm.denoise(*(_t(a) for a in (z, t, text, pad, keep)))
    assert out.shape == shape
    np.testing.assert_allclose(out.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def _jax_draws(rng, shape, steps):
    """The JAX samplers' draws: the initial noise from the first split of
    `rng`, then one split of the carried key per step."""
    key, k0 = jax.random.split(rng)
    z0 = np.asarray(jax.random.normal(k0, shape, jnp.float32))
    noises = []
    for _ in range(steps):
        key, kz = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(kz, shape, jnp.float32)))
    return z0, np.stack(noises)


def _assert_close_to_magnitude(a, b, tol=1e-4):
    err = float(np.max(np.abs(a - b)))
    assert err <= tol * float(np.max(np.abs(b))), (err, float(np.max(np.abs(b))))


@pytest.mark.parametrize("sampler,eta", [("ddim", 0.0), ("ddim", 0.5), ("dpmpp_2m", 0.0)])
def test_t2i_sampler_matches_jax(t2i, sampler, eta):
    _, jm, params, tm, _ = t2i
    steps, g = 3, 4.0
    ids, neg = _ids(), _ids(NEGATIVE)
    rng = jax.random.PRNGKey(9)
    j = JL.make_t2i_sampler(jm, steps, g, eta=eta, sampler=sampler)(
        params, jnp.asarray(ids), jnp.asarray(neg), rng)
    z0, noises = _jax_draws(rng, (2, 2, 4, 4), steps)
    z = TL.make_t2i_sampler(tm, steps, g, eta=eta, sampler=sampler)(
        ids, neg, z_init=_t(z0), step_noise=_t(noises))
    _assert_close_to_magnitude(t2n(z), np.asarray(j))


def test_t2a_sampler_matches_jax(t2a):
    jm, params, tm, _ = t2a
    ids, neg = _ids(), _ids(NEGATIVE)
    rng = jax.random.PRNGKey(13)
    for eta in (0.0, 0.5):
        j = JA.make_t2a_sampler(jm, 3, 2.0, eta=eta)(params, jnp.asarray(ids),
                                                     jnp.asarray(neg), rng)
        m0, noises = _jax_draws(rng, (2, 1, 16, 12), 3)
        m = TA.make_t2a_sampler(tm, 3, 2.0, eta=eta)(ids, neg, m_init=_t(m0),
                                                     step_noise=_t(noises))
        _assert_close_to_magnitude(t2n(m), np.asarray(j))


def test_sampler_guards_and_random_draws(t2i):
    tm = t2i[3]
    with pytest.raises(ValueError, match="ddim|dpmpp_2m"):
        TL.make_t2i_sampler(tm, 3, sampler="euler")
    with pytest.raises(ValueError, match="deterministic"):
        TL.make_t2i_sampler(tm, 3, eta=0.5, sampler="dpmpp_2m")
    sample = TL.make_t2i_sampler(tm, 2, 4.0, eta=0.5)
    a = sample(_ids(), _ids(NEGATIVE), generator=torch.Generator().manual_seed(1))
    b = sample(_ids(), _ids(NEGATIVE), generator=torch.Generator().manual_seed(1))
    c = sample(_ids(), _ids(NEGATIVE), generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_images_from_the_same_latents_match_jax(t2i):
    """The uint8 conversion (clip, (x + 1) * 127.5, truncation) of the same
    decoded images is exact; through both decoders, the same latents give
    the same images."""
    _, jm, params, tm, _ = t2i
    z = np.random.default_rng(5).normal(size=(2, 2, 4, 4)).astype(np.float32) * 2
    x = jm.apply({"params": params}, jnp.asarray(z), method=jm.decode_image)
    xn = np.asarray(jax.device_get(jnp.clip(x, -1, 1)))
    j_img = ((xn.transpose(0, 2, 3, 1) + 1.0) * 127.5).astype(np.uint8)
    np.testing.assert_array_equal(TL.images_to_uint8(_t(np.asarray(x))), j_img)
    with torch.no_grad():
        t_img = TL.images_to_uint8(tm.decode_image(_t(z)))
    assert t_img.shape == (2, 16, 16, 3) and t_img.dtype == np.uint8
    np.testing.assert_array_equal(t_img, j_img)


def test_sample_images_negative_prompt_and_dpmpp(t2i):
    """sample_images: uint8 [B, H, W, 3]; a real negative prompt and the
    dpmpp_2m sampler each change the images (as the JAX family's tests)."""
    tm = t2i[3]
    z0 = torch.from_numpy(np.random.default_rng(8).normal(size=(1, 2, 4, 4)).astype(np.float32))
    kw = dict(sampler_steps=3, guidance_scale=4.0, z_init=z0)
    a = TL.sample_images(tm, ["a cat"], negative=["blurry"], **kw)
    b = TL.sample_images(tm, ["a cat"], **kw)
    c = TL.sample_images(tm, ["a cat"], sampler="dpmpp_2m", **kw)
    assert a.shape == (1, 16, 16, 3) and a.dtype == np.uint8
    assert not np.array_equal(a, b) and not np.array_equal(b, c)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def test_t2i_train_step_matches_jax(t2i):
    """Same t, noise and keep: the loss within 1e-5 relative; every grad
    within 2e-4 of its largest magnitude, the VAE encoder's and the text
    encoder's non-zero, the decoder's exactly zero; the parameters after one
    step of the port's AdamW against optax (clip 1.0, adamw) within 1e-6."""
    cfg, jm, params, tm, images = t2i
    c = jm.cfg
    ids = _ids()
    rng = np.random.default_rng(17)
    t = np.array([4, 15], np.int32)
    noise = rng.normal(size=(2, 2, 4, 4)).astype(np.float32)
    keep = np.array([1.0, 0.0], np.float32)
    abar = JS.alphas_cumprod_from_betas(JS.make_beta_schedule(c.steps))[1]

    def loss_fn(p):
        eps_hat, eps = jm.apply({"params": p}, jnp.asarray(images), jnp.asarray(ids),
                                jnp.asarray(t), jnp.asarray(noise), jnp.asarray(abar),
                                jnp.asarray(keep), False, rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(jnp.square(eps_hat.astype(jnp.float32) - eps.astype(jnp.float32)))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    lr, wd = 1e-3, 0.01
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd))
    updates, _ = tx.update(j_grads, tx.init(params), params)
    j_after = jax_params_to_state_dict(optax.apply_updates(params, updates))

    model = copy.deepcopy(tm)
    draws = {"t": _t(t).long(), "noise": _t(noise), "keep": _t(keep)}
    abar_t = _t(abar)
    loss = TL.t2i_loss(model.train(), _t(images), _t(ids), draws, abar_t)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    j_g = jax_params_to_state_dict(j_grads)
    # a conv bias ahead of a GroupNorm of one channel per group (conv1 of a
    # ResBlock of at most 8 channels) has a gradient of exactly 0 in exact
    # arithmetic: both frameworks must give rounding noise there, under 1e-6
    # of the largest grad
    top = max(float(g.abs().max()) for g in j_g.values())
    for (name, _), g in zip(named, grads):
        if name.startswith("vae.dec"):
            assert g is None and not np.any(j_g[name].numpy()), name
            continue
        assert g is not None, name
        if name.endswith("conv1.bias") and g.numel() <= 8:
            assert max(float(g.abs().max()), float(j_g[name].abs().max())) <= 1e-6 * top, name
            continue
        scale = float(j_g[name].abs().max())
        assert float((g - j_g[name]).abs().max()) <= 2e-4 * scale, name
    nonzero = {n: g for (n, _), g in zip(named, grads) if g is not None and bool(g.any())}
    assert any(n.startswith("vae.enc_") for n in nonzero)
    assert any(n.startswith("text_encoder.core.blocks.0.attn") for n in nonzero)

    def adamw(model):
        return AdamW(list(model.named_parameters()), lambda count: lr, b1=0.9, b2=0.999,
                     eps=1e-8, weight_decay=wd, clip_norm=1.0)

    # the port's AdamW on JAX's grads: every parameter within 1e-6 of optax
    model = copy.deepcopy(tm)
    opt = adamw(model)
    opt.step([j_g[n] for n, _ in model.named_parameters()])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), j_after[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    # the port's whole step: the same where JAX's gradient is above 1e-6 of
    # the largest; below, Adam's first step g / (|g| + eps) turns rounding
    # differences of a gradient that is 0 in exact arithmetic (the conv1
    # biases above; the key third of each qkv bias, which adds one constant
    # to a query's scores) into steps of up to lr
    model = copy.deepcopy(tm)
    step = TL.make_t2i_train_step(model, adamw(model))
    np.testing.assert_allclose(float(step(_t(images), ids, draws)), float(j_loss), rtol=1e-5)
    for name, p in model.named_parameters():
        held = j_g[name].abs().numpy() > 1e-6 * top
        if name.startswith("vae.dec"):
            held[...] = True
        np.testing.assert_allclose(p.detach().numpy()[held], j_after[name].numpy()[held],
                                   rtol=0, atol=1e-6, err_msg=name)
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, tm.state_dict()[n])]
    assert any(n.startswith("vae.dec_out") for n in moved)  # weight decay moves the decoder


def test_draw_t2i_randomness_shapes_and_keep():
    c = TL.Text2ImageConfig.from_config(t2i_cfg())
    d = TL.draw_t2i_randomness(torch.Generator().manual_seed(0), c, 64, cfg_drop_prob=0.25)
    assert d["t"].shape == (64,) and int(d["t"].max()) < c.steps and int(d["t"].min()) >= 0
    assert d["noise"].shape == (64, 2, 4, 4)
    assert set(d["keep"].tolist()) == {0.0, 1.0}


# ---------------------------------------------------------------------------
# the weight carry and the kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["t2i", "t2i_variational", "t2a"])
def test_weight_carry_is_bit_exact_both_ways(family, t2i, t2a):
    if family == "t2a":
        params = t2a[1]
        port = TA.Text2AudioModel(t2a_cfgs()[1])
    else:
        cfg = t2i_cfg(family == "t2i_variational")
        if family == "t2i":
            params = t2i[2]
        else:
            jm = JL.Text2ImageModel(JL.Text2ImageConfig.from_config(cfg))
            params = meta.unbox(jax.eval_shape(
                lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 3, 16, 16)),
                                jnp.asarray(_ids(["a"])), jnp.zeros((1,), jnp.int32),
                                jnp.zeros((1, 2, 4, 4)), jnp.ones((20,))))["params"])
            params = jax.tree_util.tree_map(
                lambda s: np.random.default_rng(s.size).normal(size=s.shape).astype(np.float32),
                params)
        port = TL.Text2ImageModel(TL.Text2ImageConfig.from_config(cfg))
    leaves = dict(_leaves(params))
    sd = jax_params_to_state_dict(params)
    assert len(sd) == len(leaves)
    port.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in port.parameters()) == sum(np.size(v) for v in leaves.values())
    back = dict(_leaves(state_dict_to_jax_params(port.state_dict())))
    assert back.keys() == leaves.keys()
    for k, v in leaves.items():
        assert back[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg="/".join(k))
    names = set(sd)
    assert {"text_encoder.token_embed.embedding", "text_encoder.pos",
            "text_encoder.core.blocks.0.norm1.weight", "text_encoder.core.blocks.0.norm2.weight",
            "head.blocks.0.norm.bias", "head.out.weight"} <= names
    if family != "t2a":
        assert {"vae.enc_0_0.norm1.weight", "vae.enc_0_0.conv2.weight", "vae.dec_mid.norm2.bias",
                "vae.enc_down_1.weight", "vae.dec_norm.weight", "core.blocks.0.norm1.weight"} \
            <= names
        assert sd["vae.enc_in.weight"].shape == (8, 3, 3, 3)
        assert ("vae.to_mu.weight" in names) == (family == "t2i_variational")


def test_a_resblock_that_widens_carries_its_skip_conv():
    """ResBlock2D's third automatic conv (the 1x1 skip, flax Conv_2) is conv3."""
    import flax.linen as fnn

    class Wrap(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return JV.ResBlock2D(8, name="enc_0_0")(x)

    x = np.random.default_rng(0).normal(size=(1, 6, 6, 4)).astype(np.float32)
    params = perturb(Wrap().init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    sd = jax_params_to_state_dict(params)
    assert {"enc_0_0.conv3.weight", "enc_0_0.norm1.weight", "enc_0_0.norm2.bias"} <= set(sd)
    blk = torch.nn.Module()
    blk.enc_0_0 = TV.ResBlock2D(4, 8)
    blk.load_state_dict(sd, strict=True)
    back = dict(_leaves(state_dict_to_jax_params(blk.state_dict())))
    assert ("enc_0_0", "Conv_2", "kernel") in back and ("enc_0_0", "GroupNorm_1", "scale") in back
    with torch.no_grad():
        out = blk.enc_0_0(_t(x.transpose(0, 3, 1, 2).copy()))
    j = np.asarray(Wrap().apply({"params": params}, jnp.asarray(x))).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(out.numpy(), j, rtol=1e-5, atol=1e-5)


def test_plain_flash_version_matches_pallas_interpret_at_the_t2i_layout():
    """The kernels' plain version against the Pallas kernel in interpret mode
    at the t2i core's mask: 77 text keys with 60 pads, 1024 image keys, 51
    masked tail keys (N = 1152, Dh = 128, one head)."""
    N, Dh = 1152, 128
    rng = np.random.default_rng(77)
    q, k, v = (rng.normal(size=(1, 1, N, Dh)).astype(np.float32) for _ in range(3))
    kpad = np.zeros((1, N), bool)
    kpad[0, 17:77] = True
    kpad[0, 1101:] = True
    j_out, j_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(kpad), interpret=True)
    t_out, t_lse = t_fa.flash_forward_reference(_t(q), _t(k), _t(v), _t(~kpad))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[:, :N, 0].reshape(1, 1, N),
                               rtol=2e-5, atol=2e-5)


def test_core_sends_the_text_and_tail_mask_to_attention_as_one_row(t2i, monkeypatch):
    """The denoiser's key mask reaches the attention op as one [B, N] row:
    the text pads, the image tokens valid, the seq_multiple tail masked."""
    from multimodal_diffusion_torch.models import mmdit

    _, _, _, tm, _ = t2i
    seen = []
    real = mmdit.multi_head_attention

    def spy(q, k, v, *, key_padding_mask=None):
        seen.append(key_padding_mask.clone())
        return real(q, k, v, key_padding_mask=key_padding_mask)

    monkeypatch.setattr(mmdit, "multi_head_attention", spy)
    z, t, text, pad, _ = _denoise_inputs((2, 2, 4, 4), seed=2)
    with torch.no_grad():
        tm.denoise(_t(z), _t(t), _t(text), _t(pad))
    want = np.concatenate([pad, np.zeros((2, 4), bool), np.ones((2, 4), bool)], axis=1)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0].numpy(), want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _write_cfg(tmp_path, ckpt_dir):
    cfg = t2i_cfg()
    cfg["paths"] = {"ckpt_dir": str(ckpt_dir)}
    path = tmp_path / "t2i_tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, path


def test_cli_restores_a_jax_orbax_checkpoint_and_writes_pngs(t2i, tmp_path, capsys):
    from PIL import Image

    from multimodal_diffusion_tpu.train.checkpoint import CheckpointManager as JaxManager

    params = t2i[2]
    mgr = JaxManager(tmp_path / "ckpt")
    mgr.save(5, {"params": params}, wait=True)
    mgr.close()
    cfg, path = _write_cfg(tmp_path, tmp_path / "ckpt")
    model = sample_t2i.build_t2i(cfg, device="cpu")
    want = jax_params_to_state_dict(params)
    for name, value in model.state_dict().items():
        assert torch.equal(value, want[name]), name
    assert "restored step 5" in capsys.readouterr().out
    out = sample_t2i.main(["--config", str(path), "--prompt", "a red fox", "a cat",
                           "--negative", "blurry", "noisy", "--steps", "2",
                           "--out-dir", str(tmp_path / "png"), "--device", "cpu"])
    assert [p.name for p in out] == ["t2i_0000.png", "t2i_0001.png"]
    for p in out:
        with Image.open(p) as im:
            assert im.size == (16, 16) and im.mode == "RGB"


def test_cli_restores_the_port_s_checkpoint_and_else_samples_random_weights(t2i, tmp_path,
                                                                           capsys):
    tm = t2i[3]
    cfg, path = _write_cfg(tmp_path, tmp_path / "ckpt")
    model = sample_t2i.build_t2i(cfg, device="cpu")
    assert "no checkpoint; sampling with random weights" in capsys.readouterr().out
    again = sample_t2i.build_t2i(cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    CheckpointManager(tmp_path / "ckpt").save(2, {"params": tm.state_dict()})
    model = sample_t2i.build_t2i(cfg, device="cpu")
    assert "restored step 2" in capsys.readouterr().out
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in model.state_dict().items())
