"""The flagship (specificity8) options of the port against the JAX package, at
the shrunk flagship config (d=64, 2 layers, 4 heads, the patch VideoVAE, a
48-token mouth-crop stream, x0 audio, encoder stop-gradient, reconstruction
every 2nd step), fp32, on converted weights and the same numpy inputs:

  * the patch VideoVAE (encode, decode, out_size, a non-divisible input);
  * the mouth-crop stream through mouth_tokens, denoise_tokens and forward;
  * the train loss and every parameter grad on a reconstruction step and on
    a step without the decode, with the sync loss on either stream;
  * the optimizer across a recon_every boundary against optax, the trainer's
    step across it, and the eval step with the stream on;
  * dpmpp_2m_step, and the v2a pipeline under ddim, dpmpp_2m and sync
    guidance.

Tolerances: fp32 modules 1e-5, 3-D convolutions 1e-4, losses 1e-5 relative,
grads 2e-4 of each grad's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import jax_model_and_params, shrunk_flagship_cfg, t2n, torch_model
from multimodal_diffusion_torch.infer.ddim import sampler_from_config as t_sampler
from multimodal_diffusion_torch.infer.sample_clip import sample_one_direction
from multimodal_diffusion_torch.ops import schedule as TS
from multimodal_diffusion_torch.ops.attention import attention_path
from multimodal_diffusion_torch.train import trainer as TT
from multimodal_diffusion_torch.utils.convert import jax_params_to_state_dict
from multimodal_diffusion_tpu.infer.ddim import sampler_from_config as j_sampler
from multimodal_diffusion_tpu.ops import schedule as JS
from multimodal_diffusion_tpu.train import losses as JL
from multimodal_diffusion_tpu.train import trainer as JT

B = 2
T = torch.from_numpy


def _rand(shape, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _abar():
    return JS.alphas_cumprod_from_betas(JS.make_beta_schedule(1000, "cosine", 1e-4, 0.02))[1]


@pytest.fixture(scope="module")
def models():
    cfg = shrunk_flagship_cfg()
    jm, params = jax_model_and_params(cfg, seed=5)
    return cfg, jm, params, torch_model(cfg, params)


# ---------------------------------------------------------------------------
# the patch VideoVAE
# ---------------------------------------------------------------------------


def test_patch_vae_encode(models):
    """The tubelet vector order (t, h, w, C) and LayerNorm eps 1e-6 carry the
    JAX weights across: 1e-4 (3-D convolutions at latent resolution)."""
    _, jm, params, tm = models
    x = _rand((B, 3, 8, 32, 32), 0, 0.0, 1.0)
    j = np.asarray(jm.apply({"params": params}, x, method=jm.encode_video))
    t = t2n(tm.encode_video(T(x)))
    assert t.shape == (B, 8, 2, 4, 4)
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def test_patch_vae_encode_center_crops_a_non_divisible_input(models):
    _, jm, params, tm = models
    x = _rand((B, 3, 9, 35, 33), 1, 0.0, 1.0)
    j = np.asarray(jm.apply({"params": params}, x, method=jm.encode_video))
    with pytest.warns(UserWarning, match="center-cropping"):
        t = t2n(tm.encode_video(T(x)))
    assert t.shape == (B, 8, 2, 4, 4)
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("out_size", [None, (8, 32, 32), (9, 35, 33)])
def test_patch_vae_decode(models, out_size):
    """decode, and decode enlarged to an uncropped clip's size (trilinear,
    half-pixel centres, applied before the sigmoid)."""
    _, jm, params, tm = models
    z = _rand((B, 8, 2, 4, 4), 2)
    j = np.asarray(jm.apply({"params": params}, z, out_size, method=jm.decode_video))
    t = t2n(tm.decode_video(T(z), out_size))
    assert t.shape == (B, 3) + (out_size or (8, 32, 32))
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["patch", "conv"])
def test_vae_decode_refuses_to_shrink(models, arch):
    """Shrinking is ported (it raised ValueError before): an out_size
    smaller than the decoded size antialiases as the JAX package's
    jax.image.resize does, here together with an enlarged axis, within 1e-4
    of the JAX decode on the same weights: the patch arch's frames (natural
    8x32x32), the conv arch's hidden grid (the latent grid 2x4x4)."""
    from _torch_parity import shrunk_cfg

    if arch == "patch":
        _, jm, params, tm = models
        out_size = (8, 31, 36)
    else:
        jm, params = jax_model_and_params(shrunk_cfg(), seed=2)
        tm = torch_model(shrunk_cfg(), params)
        out_size = (1, 3, 6)
    z = _rand((B, 8, 2, 4, 4), 4)
    j = np.asarray(jm.apply({"params": params}, z, out_size, method=jm.decode_video))
    t = t2n(tm.decode_video(T(z), out_size))
    assert t.shape == (B, 3) + out_size
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def test_conv_vae_decode_out_size_matches_jax():
    """The conv arch resizes the features to out_size before its blocks."""
    from _torch_parity import shrunk_cfg

    cfg = shrunk_cfg()
    jm, params = jax_model_and_params(cfg, seed=2)
    tm = torch_model(cfg, params)
    z = _rand((B, 8, 2, 4, 4), 3)
    j = np.asarray(jm.apply({"params": params}, z, (9, 35, 33), method=jm.decode_video))
    np.testing.assert_allclose(t2n(tm.decode_video(T(z), (9, 35, 33))), j, rtol=1e-4, atol=1e-4)


def test_variational_vae_still_raises():
    """The variational VideoVAE is ported now (tests/test_torch_remat_profiling.py
    holds it against JAX): it builds to_mu / to_logv in place of to_lat. An
    unknown arch still raises."""
    from multimodal_diffusion_torch.models.vae_video3d import VideoVAE, VideoVAEConfig

    vae = VideoVAE(VideoVAEConfig(variational=True))
    assert hasattr(vae, "to_mu") and hasattr(vae, "to_logv") and not hasattr(vae, "to_lat")
    with pytest.raises(ValueError, match="conv'|'patch"):
        VideoVAE(VideoVAEConfig(arch="unet"))


# ---------------------------------------------------------------------------
# the mouth-crop stream
# ---------------------------------------------------------------------------


def test_mouth_tokens_and_grid(models):
    """Crop, minus 0.5, tube-patch of pixels: exact (a layout change and one
    subtraction)."""
    _, jm, params, tm = models
    x = _rand((B, 3, 8, 32, 32), 4, 0.0, 1.0)
    j = np.asarray(jm.apply({"params": params}, x, method=jm.mouth_tokens))
    t = t2n(tm.mouth_tokens(T(x)))
    assert t.shape == (B, 48, 96) and tm.cfg.token_dim_mouth == 96
    np.testing.assert_array_equal(t, j)
    assert tm.mouth_grid(8) == jm.mouth_grid(8) == (8, 3, 2)
    assert tm.cfg.mouth_crop_hw == (12, 16)


@pytest.mark.parametrize("keep_m", [None, (1.0, 0.0)])
def test_denoise_tokens_with_mouth_tokens(models, keep_m):
    """The three-stream sequence [video; audio; mouth], the mouth tokens
    embedded at t = 0 under their own modality row and positions; h_m is
    returned. 1e-5."""
    _, jm, params, tm = models
    tok_v, tok_a = _rand((B, 32, 8), 5), _rand((B, 12, 32), 6)
    tok_m = _rand((B, 48, 96), 7, -0.5, 0.5)
    t_v, t_a = np.array([0, 0], np.int32), np.array([700, 20], np.int32)
    keep_v = np.array([1.0, 0.0], np.float32)
    km = None if keep_m is None else np.array(keep_m, np.float32)
    j = jm.apply({"params": params}, tok_v, tok_a, t_v, t_a, (2, 4, 4), keep_v, None, True,
                 tok_m, km, (8, 3, 2), method=jm.denoise_tokens)
    t = tm.denoise_tokens(T(tok_v), T(tok_a), T(t_v), T(t_a), (2, 4, 4), T(keep_v), None,
                          tok_m=T(tok_m), keep_m=None if km is None else T(km),
                          mouth_grid=(8, 3, 2))
    assert t["h_m"].shape == (B, 48, 64)
    for key in ("eps_v", "eps_a", "h_v", "h_a", "h_m"):
        np.testing.assert_allclose(t2n(t[key]), np.asarray(j[key]), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_mouth_tokens_without_the_stream_raise():
    from _torch_parity import shrunk_cfg
    from multimodal_diffusion_torch.models.diffusion import AVDiffusionConfig, AVDiffusionModel

    model = AVDiffusionModel(AVDiffusionConfig.from_config(shrunk_cfg()))
    z = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="mouth_crop.enabled"):
        model.embed_tokens(z, torch.zeros(1, 4, 32), torch.zeros(1, dtype=torch.long),
                           torch.zeros(1, dtype=torch.long), (1, 2, 2), tok_m=z)


def _forward_inputs(seed=8):
    s = JT.latent_shapes_from_config(shrunk_flagship_cfg(), B)
    rng = np.random.default_rng(seed)
    return s, {"video": rng.uniform(0, 1, s["video"]).astype(np.float32),
               "audio": rng.uniform(-1, 1, s["audio"]).astype(np.float32),
               "t_v": np.array([10, 900]), "t_a": np.array([500, 3]),
               "noise_v": rng.normal(size=s["z_video"]).astype(np.float32),
               "noise_a": rng.normal(size=s["z_audio"]).astype(np.float32)}


@pytest.mark.parametrize("keep_m,with_recon", [(None, False), ((1.0, 0.0), False),
                                               ((0.0, 1.0), True)])
def test_forward_with_keep_m_and_recon(models, keep_m, with_recon):
    """The training forward: keep_m defaults to zeros with the stream on;
    with_recon decodes the clean latents (recon_v at the input's size).
    1e-5, and 1e-4 on the decoded video."""
    _, jm, params, tm = models
    _, x = _forward_inputs()
    abar = _abar()
    km = None if keep_m is None else np.array(keep_m, np.float32)
    keep = np.array([1.0, 0.0], np.float32)
    j = jm.apply({"params": params}, x["video"], x["audio"], x["t_v"], x["t_a"], x["noise_v"],
                 x["noise_a"], jnp.asarray(abar), jnp.asarray(abar), keep, None,
                 deterministic=True, keep_m=km, with_recon=with_recon)
    t = tm(T(x["video"]), T(x["audio"]), T(x["t_v"]), T(x["t_a"]), T(x["noise_v"]),
           T(x["noise_a"]), T(abar), T(abar), T(keep), None,
           keep_m=None if km is None else T(km), with_recon=with_recon)
    assert set(t) == set(j)
    assert ("recon_v" in t) == with_recon
    for key in t:
        tol = 1e-4 if key == "recon_v" else 1e-5
        np.testing.assert_allclose(t2n(t[key]), np.asarray(j[key]), rtol=tol, atol=tol,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# the train loss and its gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parity(models):
    """One batch and one set of draws: sample 0's conditioning is CFG-dropped
    and sample 1's timestep is forced clean; sample 1 has no audio."""
    cfg, jm, params, _ = models
    s, x = _forward_inputs(seed=9)
    batch = {"video": x["video"], "audio": x["audio"],
             "has_video": np.array([True, True]), "has_audio": np.array([True, False])}
    draws = {"t_v": x["t_v"], "t_a": x["t_a"], "noise_v": x["noise_v"], "noise_a": x["noise_a"],
             "cfg_u": np.array([0.05, 0.9], np.float32),
             "clean_u": np.array([0.7, 0.2], np.float32)}
    return cfg, jm, params, s, batch, draws, _abar()


def _step_config(cfg, s, **kw):
    t = cfg["training"]
    base = dict(z_video_shape=s["z_video"], z_audio_shape=s["z_audio"], T_v=1000, T_a=1000,
                cfg_drop_prob=0.1, clean_cond_prob=t["clean_cond_prob"],
                align_weight=t["align_loss_weight"], sync_weight=t["sync_loss_weight"],
                sync_tau=t["sync_tau"], video_time_chunks=2, mouth_time_chunks=8,
                recon_weight=t["recon_loss_weight"], recon_every=t["recon_every"])
    base.update(kw)
    return TT.StepConfig(**base)


def _jax_loss_fn(parity, target_is_video, with_recon, sync_source):
    """The JAX train step's loss (train/trainer.py::build_train_step.loss_fn)
    as a function of the params, under the given draws, deterministic."""
    cfg, jm, _, s, batch, d, abar = parity
    t = cfg["training"]
    w = target_is_video
    clean = d["clean_u"] < t["clean_cond_prob"]
    t_v = np.where(clean & (w == 0.0), 0, d["t_v"])
    t_a = np.where(clean & (w == 1.0), 0, d["t_a"])
    keep_nt = 1.0 - (d["cfg_u"] < 0.1).astype(np.float32)
    keep_v, keep_a = w + (1 - w) * keep_nt, w * keep_nt + (1 - w)
    keep_m = ((1 - w) * keep_nt).astype(np.float32)
    hv, ha = jnp.asarray(batch["has_video"]), jnp.asarray(batch["has_audio"])

    def loss_fn(p):
        out = jm.apply({"params": p}, batch["video"], batch["audio"], t_v, t_a, d["noise_v"],
                       d["noise_a"], jnp.asarray(abar), jnp.asarray(abar),
                       jnp.asarray(keep_v, jnp.float32), jnp.asarray(keep_a, jnp.float32),
                       deterministic=True, keep_m=jnp.asarray(keep_m), with_recon=with_recon)
        loss = JL.mse_targets_only(out["eps_v"], out["eps_a"], out["eps_true_v"],
                                   out["eps_true_a"], jnp.asarray(w), hv, ha)
        loss += JL.alignment_loss(out["h_v"], out["h_a"], weight=t["align_loss_weight"])
        if sync_source == "mouth":
            loss += JL.sync_contrastive_loss(out["h_m"], out["h_a"], 8,
                                             weight=t["sync_loss_weight"], tau=t["sync_tau"],
                                             sample_weight=jnp.asarray(keep_m))
        else:
            loss += JL.sync_contrastive_loss(out["h_v"], out["h_a"], 2,
                                             weight=t["sync_loss_weight"], tau=t["sync_tau"])
        if with_recon:
            loss += JL.reconstruction_loss(out["recon_v"], batch["video"], out["recon_a"],
                                           batch["audio"], weight=t["recon_loss_weight"],
                                           has_video=hv, has_audio=ha)
        return loss

    return loss_fn


_JAX_GRADS = {}


def _jax_loss_and_grads(parity, with_recon, sync_source, params=None):
    key = (with_recon, sync_source)
    if params is None and key in _JAX_GRADS:
        return _JAX_GRADS[key]
    fn = jax.jit(jax.value_and_grad(_jax_loss_fn(parity, 0.0, with_recon, sync_source)))
    loss, grads = fn(parity[2] if params is None else params)
    if params is not None:
        return float(loss), grads
    _JAX_GRADS[key] = float(loss), jax_params_to_state_dict(grads)
    return _JAX_GRADS[key]


def _torch_draws(draws):
    return {k: T(v) for k, v in draws.items()}


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("sync_source", ["video", "mouth"])
@pytest.mark.parametrize("with_recon", [True, False])
def test_flagship_train_loss_and_every_grad_match_jax(parity, with_recon, sync_source, kernel):
    """The audio-target loss (the stream on for sample 1, CFG-dropped for
    sample 0) within 1e-5 relative and every parameter's grad within 2e-4 of
    its largest magnitude, through the kernels' plain versions and through
    dense attention. On a step without the decode, under encoder_stopgrad,
    the encoders and decoders get no gradient at all on either side."""
    cfg, _, params, s, batch, draws, abar = parity
    j_loss, j_grads = _jax_loss_and_grads(parity, with_recon, sync_source)
    tm = torch_model(cfg, params)
    sc = _step_config(cfg, s, sync_source=sync_source)
    ab = T(abar)
    with attention_path("kernel" if kernel else "dense"):
        loss, parts = TT.train_loss(tm, sc, ab, ab,
                                    TT.batch_to_device(batch, torch.device("cpu")), 0.0,
                                    _torch_draws(draws), with_recon)
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=1e-5)
    parts = {k: float(v.detach()) for k, v in parts.items()}
    assert (parts["loss_recon"] > 0.0) == with_recon
    assert parts["loss_sync"] > 0.0 and parts["loss_align"] > 0.0
    for name, p in tm.named_parameters():
        ref = j_grads[name].numpy()
        codec = name.startswith(("vid_vae.", "aud_codec."))
        if codec and not with_recon:
            assert p.grad is None and not ref.any(), name
            continue
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        assert np.all(np.isfinite(g)), name
        if codec:
            assert np.abs(g).max() > 0.0, name
        np.testing.assert_allclose(g, ref, rtol=0, atol=2e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=name)


def test_video_target_zeroes_the_mouth_stream(parity):
    """With video as the target keep_m is 0 for every sample: the mouth
    stream must not leak the clean target. Loss 1e-5 relative."""
    cfg, _, params, s, batch, draws, abar = parity
    fn = _jax_loss_fn(parity, 1.0, True, "mouth")
    j_loss = float(jax.jit(fn)(params))
    tm = torch_model(cfg, params)
    ab = T(abar)
    loss, parts = TT.train_loss(tm, _step_config(cfg, s, sync_source="mouth"), ab, ab,
                                TT.batch_to_device(batch, torch.device("cpu")), 1.0,
                                _torch_draws(draws))
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=1e-5)
    assert float(parts["loss_sync"].detach()) == 0.0  # every sample's weight is 0


# ---------------------------------------------------------------------------
# the optimizer and the trainer across a recon_every boundary
# ---------------------------------------------------------------------------


def _adam_state(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


@pytest.mark.parametrize("mv_dtype", ["fp32", "bf16"])
def test_optimizer_across_a_recon_boundary_matches_optax(parity, mv_dtype):
    """Three updates (no decode, decode, no decode) of the whole model with
    the JAX grads: optax takes the encoders' and decoders' zero grads of a
    step without the decode, the port takes None for them, as its backward
    gives. Both decay those weights and their moments alike. fp32 moments:
    parameters and moments within 1e-6. bf16 moments (the flagship's): the
    stored moments within one bf16 ulp (2^-8 relative; the two frameworks
    round b * m + (1 - b) * g from fp32 sums that differ in the last bit, so
    a tie can fall either way), and the parameters within 1.5 * 2^-8 of the
    LRs summed over the updates (0 + lr/2 + lr in this warmup): one ulp of m
    moves m_hat / sqrt(v_hat), which is at most ~1, by 2^-8, one ulp of v by
    2^-9."""
    cfg, _, params, *_ = parity
    lr = 0.05
    cfg = {**cfg, "training": {**cfg["training"], "max_steps": 6,
                               "optimizer": {**cfg["training"]["optimizer"], "lr": lr,
                                             "mv_dtype": mv_dtype}}}
    tx, _ = JT.make_optimizer(cfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = tx.init(j_params)
    tm = torch_model(cfg, params)
    named = list(tm.named_parameters())
    opt = TT.make_optimizer(cfg, named)
    assert opt.mv_dtype == (torch.bfloat16 if mv_dtype == "bf16" else torch.float32)
    before = {n: p.detach().clone() for n, p in named}
    for with_recon in (False, True, False):
        _, grads = _jax_loss_and_grads(parity, with_recon, "video", params=params)
        updates, j_state = tx.update(grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        sd = jax_params_to_state_dict(grads)
        opt.step([None if (not with_recon and n.startswith(("vid_vae.", "aud_codec.")))
                  else sd[n] for n, _ in named])
    want = jax_params_to_state_dict(j_params)
    p_tol = 1e-6 if mv_dtype == "fp32" else 1.5 * lr * 1.5 * 2 ** -8
    for n, p in named:
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6, atol=p_tol,
                                   err_msg=n)
    assert not torch.equal(dict(named)["vid_vae.patch_embed.weight"],
                           before["vid_vae.patch_embed.weight"])
    adam = _adam_state(j_state)
    m_tol = 1e-6 if mv_dtype == "fp32" else 2 ** -8
    for stored, ref in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
        ref = jax_params_to_state_dict(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), ref))
        for (n, _), m in zip(named, stored):
            r = ref[n].numpy()
            np.testing.assert_allclose(m.float().numpy(), r, rtol=m_tol,
                                       atol=m_tol * np.abs(r).max() + 1e-30, err_msg=n)


def test_a_step_without_the_decode_only_decays_the_codecs():
    """The trainer's own step, at recon_every 2: step 1 (LR 0) moves nothing,
    step 2 decodes (loss_recon > 0, the encoders get a gradient), step 3 does
    not (loss_recon 0): its update of an encoder weight is the moments'
    decay and the weight decay alone, -lr * (m_hat / (sqrt(v_hat) + eps) +
    wd * p), as optax applies to a zero grad."""
    cfg = shrunk_flagship_cfg()
    cfg["training"]["optimizer"]["mv_dtype"] = "fp32"
    bundle = TT.create_trainer(cfg, device="cpu", batch_size=B)
    assert bundle.step_config.recon_every == 2 and bundle.step_config.recon_weight == 1.0
    s = bundle.latent_shapes
    rng = np.random.default_rng(3)
    batch = {"video": rng.uniform(0, 1, s["video"]).astype(np.float32),
             "audio": rng.uniform(-1, 1, s["audio"]).astype(np.float32),
             "has_video": np.ones(B, bool), "has_audio": np.ones(B, bool)}
    opt = bundle.state.optimizer
    idx = opt.names.index("vid_vae.patch_embed.weight")
    p = opt.params[idx]
    recon = []
    for step in range(3):
        if step == 2:
            p0, m0, v0 = p.detach().clone(), opt.mu[idx].clone(), opt.nu[idx].clone()
        recon.append(float(bundle.train_step(bundle.state, batch, 0.0)["loss_recon"]))
    assert recon[0] == 0.0 and recon[1] > 0.0 and recon[2] == 0.0
    assert float(m0.abs().max()) > 0.0  # the decode step reached the encoder
    o = cfg["training"]["optimizer"]
    b1, b2 = o["betas"]
    m, v = b1 * m0, b2 * v0
    upd = (m / (1 - b1 ** 3)) / (torch.sqrt(v / (1 - b2 ** 3)) + o["eps"]) + o["weight_decay"] * p0
    want = p0 - opt.lr_schedule(2) * upd
    torch.testing.assert_close(p.detach(), want, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(opt.mu[idx], m, rtol=1e-6, atol=0)


def test_run_training_logs_the_interval_mean_of_loss_recon():
    """Through create_trainer + run_training on the CPU, log_every 1: the
    decode runs on every 2nd step only; with log_every 2 the logged
    loss_recon is the interval's mean, half a decode step's."""
    cfg = shrunk_flagship_cfg()
    cfg["training"].update(log_every=1, ckpt_every=100)

    def batches(shapes):
        rng = np.random.default_rng(0)
        while True:
            yield {"video": rng.uniform(0, 1, shapes["video"]).astype(np.float32),
                   "audio": rng.uniform(-1, 1, shapes["audio"]).astype(np.float32),
                   "has_video": np.ones(B, bool), "has_audio": np.ones(B, bool)}

    runs = {}
    for log_every in (1, 2):
        cfg["training"]["log_every"] = log_every
        logs = []
        with attention_path("kernel"):
            bundle = TT.create_trainer(cfg, device="cpu", batch_size=B)
            TT.run_training(cfg, bundle, batches(bundle.latent_shapes), max_steps=4,
                            log_fn=lambda step, m: logs.append(m))
        runs[log_every] = [m["loss_recon"] for m in logs]
        assert all(np.isfinite([m["loss"] for m in logs]))
    each, mean = runs[1], runs[2]
    assert each[0] == 0.0 and each[2] == 0.0 and each[1] > 0.0 and each[3] > 0.0
    np.testing.assert_allclose(mean, [each[1] / 2, each[3] / 2], rtol=1e-5)


@pytest.mark.parametrize("key,value,error", [
    ("recon_every", 0, "recon_every"),
    ("sync_loss_source", "audio", "video|mouth"),
])
def test_trainer_config_checks(key, value, error):
    cfg = shrunk_flagship_cfg()
    cfg["training"][key] = value
    with pytest.raises(ValueError, match=error):
        TT.create_trainer(cfg, device="cpu", batch_size=B)


def test_mouth_sync_source_needs_the_stream():
    from _torch_parity import shrunk_cfg

    cfg = shrunk_cfg()
    cfg["training"].update(sync_loss_source="mouth", sync_loss_weight=0.2)
    with pytest.raises(ValueError, match="mouth_crop.enabled"):
        TT.create_trainer(cfg, device="cpu", batch_size=B)


def test_eval_step_with_the_stream_on(parity):
    """The video loss from a forward with the stream zeroed, the audio loss
    from a second one with keep_m = 1, as the JAX eval step: 1e-5 relative,
    on the port's own draws handed to the JAX model."""
    cfg, jm, params, s, batch, _, abar = parity
    tm = torch_model(cfg, params)
    sc = _step_config(cfg, s)
    ab = T(abar)
    got = TT.build_eval_step(sc, ab, ab)(tm, batch, torch.Generator().manual_seed(11))
    d = TT.draw_step_randomness(torch.Generator().manual_seed(11), sc)
    d = {k: v.numpy() for k, v in d.items()}
    hv, ha = jnp.asarray(batch["has_video"]), jnp.asarray(batch["has_audio"])

    def jax_loss(keep_m, w):
        out = jm.apply({"params": params}, batch["video"], batch["audio"], d["t_v"], d["t_a"],
                       d["noise_v"], d["noise_a"], jnp.asarray(abar), jnp.asarray(abar),
                       deterministic=True, keep_m=keep_m)
        return float(JL.mse_targets_only(out["eps_v"], out["eps_a"], out["eps_true_v"],
                                         out["eps_true_a"], jnp.asarray(w), hv, ha))

    want_v, want_a = jax_loss(None, 1.0), jax_loss(jnp.ones((B,), jnp.float32), 0.0)
    np.testing.assert_allclose(float(got["val_loss_video"]), want_v, rtol=1e-5)
    np.testing.assert_allclose(float(got["val_loss_audio"]), want_a, rtol=1e-5)
    np.testing.assert_allclose(float(got["val_loss"]), 0.5 * (want_v + want_a), rtol=1e-5)
    assert abs(want_a - jax_loss(None, 0.0)) > 1e-6  # the stream changes the audio loss


# ---------------------------------------------------------------------------
# dpmpp_2m
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("param", ["eps", "x0", "v"])
def test_dpmpp_2m_step_matches_jax(param):
    """A first step (h_prev = 0), a second-order step and the final step
    (t_prev = -1), per-sample timesteps: x_prev, x0_now and h within 1e-5
    relative (fp32 logs and exps of alpha_bar)."""
    abar = _abar()
    x, pred, x0_prev = _rand((3, 8, 50), 20), _rand((3, 8, 50), 21), _rand((3, 8, 50), 22)
    t_now, t_prev = np.array([999, 500, 20]), np.array([749, 250, -1])
    for h_prev in (np.zeros((3, 1, 1), np.float32), np.full((3, 1, 1), 0.8, np.float32)):
        j = JS.dpmpp_2m_step(jnp.asarray(x), jnp.asarray(t_now), jnp.asarray(t_prev),
                             jnp.asarray(pred), jnp.asarray(abar), jnp.asarray(x0_prev),
                             jnp.asarray(h_prev), param=param)
        t = TS.dpmpp_2m_step(T(x), T(t_now), T(t_prev), T(pred), T(abar), T(x0_prev),
                             T(h_prev), param=param)
        for a, b, name in zip(t, j, ("x_prev", "x0_now", "h")):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * np.abs(b).max(),
                                       err_msg=name)
        np.testing.assert_array_equal(t[0][2].numpy(), t[1][2].numpy())  # final: x_prev = x0


def _roll(solver, x, sched, abar, pred_fn, param="eps"):
    x0_prev = torch.zeros_like(x)
    h_prev = torch.zeros((x.shape[0],) + (1,) * (x.ndim - 1))
    for now, prev in zip(sched[:-1], sched[1:]):
        t_now = torch.full((x.shape[0],), int(now))
        t_prev = torch.full((x.shape[0],), int(prev))
        pred = pred_fn(x, t_now)
        if solver == "ddim":
            x = TS.ddim_step(x, t_now, t_prev, pred, abar, param=param)
        else:
            x, x0_prev, h_prev = TS.dpmpp_2m_step(x, t_now, t_prev, pred, abar, x0_prev, h_prev,
                                                  param=param)
    return x


def test_dpmpp_2m_beats_ddim_on_an_exact_ode():
    """Gaussian data N(0, 4): the optimal eps-predictor is linear, a 400-step
    DDIM run is the truth, and at 10 steps the 2nd-order solver's error is
    under half of DDIM's (the golden property of tests/test_dpmpp.py)."""
    abar = T(_abar())
    s2 = 4.0

    def eps_fn(x, t):
        a = abar[t].reshape(-1, 1)
        x0 = torch.sqrt(a) * s2 * x / (a * s2 + (1.0 - a))
        return (x - torch.sqrt(a) * x0) / torch.sqrt(torch.clamp(1.0 - a, min=1e-12))

    x_T = T(_rand((8, 16), 23))
    truth = _roll("ddim", x_T, TS.make_sampling_schedule(1000, 400), abar, eps_fn)
    sched10 = TS.make_sampling_schedule(1000, 10)
    err_ddim = float(torch.linalg.norm(_roll("ddim", x_T, sched10, abar, eps_fn) - truth))
    err_dpm = float(torch.linalg.norm(_roll("dpmpp_2m", x_T, sched10, abar, eps_fn) - truth))
    assert np.isfinite(err_dpm) and err_dpm < 0.5 * err_ddim, (err_dpm, err_ddim)


@pytest.mark.parametrize("param", ["eps", "x0", "v"])
def test_dpmpp_2m_perfect_predictor_lands_on_x0(param):
    abar = T(_abar())
    x0_true = T(_rand((4, 8), 24))

    def pred_fn(x, t):
        a = abar[t].reshape(-1, 1)
        if param == "x0":
            return x0_true
        eps = (x - torch.sqrt(a) * x0_true) / torch.sqrt(torch.clamp(1.0 - a, min=1e-12))
        if param == "eps":
            return eps
        return torch.sqrt(a) * eps - torch.sqrt(torch.clamp(1.0 - a, min=0.0)) * x0_true

    x = _roll("dpmpp_2m", T(_rand((4, 8), 25)), TS.make_sampling_schedule(1000, 8), abar,
              pred_fn, param)
    np.testing.assert_allclose(x.numpy(), x0_true.numpy(), atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# the v2a pipeline
# ---------------------------------------------------------------------------

SAMPLING_CASES = {
    "ddim": {},
    "ddim_rescale": {"cfg_rescale": 0.7},
    "dpmpp_2m": {"sampler": "dpmpp_2m"},
    "guided_mouth_rms": {"sync_guidance_scale": 0.5, "sync_guidance_source": "mouth"},
    "guided_mouth_raw": {"sync_guidance_scale": 0.5, "sync_guidance_source": "mouth",
                         "sync_guidance_norm": "raw"},
    "guided_video_rms": {"sync_guidance_scale": 0.5, "sync_guidance_source": "video",
                         "sync_tau": 0.2},
    "guided_video_raw_gated": {"sync_guidance_scale": 2.0, "sync_guidance_source": "video",
                               "sync_guidance_norm": "raw", "sync_guidance_min_abar": 0.3},
    "guided_auto_dpmpp_2m": {"sync_guidance_scale": 0.5, "sampler": "dpmpp_2m"},
}


@pytest.mark.parametrize("case", list(SAMPLING_CASES))
def test_flagship_v2a_pipeline_matches_jax(models, case):
    """encode_video -> mouth_tokens -> sampler (4 steps, batched CFG, x0
    audio) -> decode_audio on the same weights, frames and z_init. The
    latents agree to 1e-4 of their magnitude (four fp32 denoiser passes with
    guidance 3; the guided cases add a backward pass and, under rms, a
    division by the gradient's RMS) and the waveforms to 1e-4."""
    cfg, jm, params, tm = models
    cfg = {**cfg, "sampling": {**cfg["sampling"], **SAMPLING_CASES[case]}}
    rng = np.random.default_rng(30)
    video = rng.uniform(0, 1, (B, 3, 8, 32, 32)).astype(np.float32)
    z_init = rng.normal(size=(B, 8, 50)).astype(np.float32)

    var = {"params": params}
    j_sample, j_sched = j_sampler(jm, cfg, target="audio")
    z_prompt = jm.apply(var, jnp.asarray(video), method=jm.encode_video)
    j_tok_m = jm.apply(var, jnp.asarray(video), method=jm.mouth_tokens)
    j_z = np.asarray(j_sample(params, z_prompt, jnp.asarray(z_init), None, j_tok_m))
    j_wav = np.asarray(jm.apply(var, j_z, method=jm.decode_audio))

    t_sample, t_sched = t_sampler(cfg, target="audio")
    np.testing.assert_array_equal(t_sched, j_sched)
    with torch.inference_mode():
        t_prompt = tm.encode_video(T(video))
        t_z = t_sample(tm, t_prompt, T(z_init), tok_mouth=tm.mouth_tokens(T(video)))
        t_wav = t2n(tm.decode_audio(t_z))
    np.testing.assert_allclose(t2n(t_z), j_z, rtol=0, atol=1e-4 * max(1.0, np.abs(j_z).max()))
    np.testing.assert_allclose(t_wav, j_wav, rtol=1e-4, atol=1e-4)
    assert all(p.grad is None for p in tm.parameters())


def test_guidance_changes_the_sample_and_scale_zero_does_not(models):
    cfg, _, _, tm = models
    frames = np.random.default_rng(31).integers(0, 256, (B, 8, 32, 32, 3), dtype=np.uint8)

    def run(**sampling):
        c = {**cfg, "sampling": {**cfg["sampling"], **sampling}}
        return sample_one_direction(cfg=c, model=tm, prompt_modality="video",
                                    prompt_video=frames, device="cpu")["audio"]

    base = run()
    np.testing.assert_array_equal(run(sync_guidance_scale=0.0, sync_guidance_source="mouth"), base)
    guided = run(sync_guidance_scale=0.5)
    assert guided.shape == base.shape == (B, 8000) and np.all(np.isfinite(guided))
    assert np.abs(guided - base).max() > 1e-4
    assert all(p.grad is None for p in tm.parameters())


def test_a2v_with_the_stream_on_uses_zero_mouth_tokens(models):
    """a2v (and v2a without tokens) runs the three-stream layout with zero
    mouth tokens and keep 0, as training's dropped state; against the JAX
    sampler, 1e-4 of the latent's magnitude."""
    cfg, jm, params, tm = models
    z_prompt, z_init = _rand((B, 8, 50), 32), _rand((B, 8, 2, 4, 4), 33)
    j_sample, _ = j_sampler(jm, cfg, target="video")
    j_z = np.asarray(j_sample(params, jnp.asarray(z_prompt), jnp.asarray(z_init)))
    t_sample, _ = t_sampler(cfg, target="video")
    t_z = t2n(t_sample(tm, T(z_prompt), T(z_init)))
    np.testing.assert_allclose(t_z, j_z, rtol=0, atol=1e-4 * max(1.0, np.abs(j_z).max()))
    wav = _rand((8000,), 34, -1.0, 1.0)
    out = sample_one_direction(cfg=cfg, model=tm, prompt_modality="audio", prompt_audio=wav,
                               device="cpu")
    assert out["video"].shape == (8, 32, 32, 3) and out["video"].dtype == np.uint8


@pytest.mark.parametrize("sampling,error", [
    ({"sampler": "euler"}, "ddim|dpmpp_2m"),
    ({"sampler": "dpmpp_2m", "ddim_eta": 0.5}, "deterministic"),
    ({"sync_guidance_scale": 1.0, "sync_guidance_source": "lips"}, "auto|mouth|video"),
    ({"sync_guidance_scale": 1.0, "sync_guidance_norm": "l2"}, "rms|raw"),
])
def test_sampler_config_checks(sampling, error):
    cfg = shrunk_flagship_cfg()
    cfg["sampling"].update(sampling)
    with pytest.raises(ValueError, match=error):
        t_sampler(cfg, target="audio")
    if "sync_guidance_scale" in sampling and len(sampling) == 1:
        t_sampler(cfg, target="video")  # the a2v direction is built without it


def test_mouth_guidance_without_tokens_raises(models):
    cfg, _, _, tm = models
    c = {**cfg, "sampling": {**cfg["sampling"], "sync_guidance_scale": 1.0,
                             "sync_guidance_source": "mouth"}}
    sample, _ = t_sampler(c, target="audio")
    with pytest.raises(ValueError, match="needs conditioning.mouth_crop"):
        sample(tm, torch.zeros(B, 8, 2, 4, 4), torch.zeros(B, 8, 50))


def test_v2a_crops_frames_to_the_vae_and_mouth_tube(models):
    """T is center-cropped to a multiple of lcm(t_down, mouth tube t) before
    both the encode and the mouth tokens (9 frames -> the middle 8), and too
    few frames raise."""
    cfg, _, _, tm = models
    frames = np.random.default_rng(35).integers(0, 256, (B, 9, 32, 32, 3), dtype=np.uint8)
    out = sample_one_direction(cfg=cfg, model=tm, prompt_modality="video",
                               prompt_video=frames, device="cpu")
    ref = sample_one_direction(cfg=cfg, model=tm, prompt_modality="video",
                               prompt_video=frames[:, :8], device="cpu")
    np.testing.assert_array_equal(out["audio"], ref["audio"])
    with pytest.raises(ValueError, match="need at least 4"):
        sample_one_direction(cfg=cfg, model=tm, prompt_modality="video",
                             prompt_video=frames[:, :3], device="cpu")
    wide = {**cfg, "conditioning": {"mouth_crop": {**cfg["conditioning"]["mouth_crop"],
                                                   "tube": {"t": 3, "h": 4, "w": 8}}}}
    from multimodal_diffusion_torch.infer.sample_clip import build_components

    with pytest.raises(ValueError, match="need at least 12"):
        sample_one_direction(cfg=wide, model=build_components(wide, device="cpu"),
                             prompt_modality="video", prompt_video=frames, device="cpu")
