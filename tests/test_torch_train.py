"""The port's training slice against the JAX package, at the shrunk mvp
config (d=64, 2 layers, 4 heads, dropout 0, warmup 2), fp32:

  * the train loss and every parameter grad, on converted weights with the
    same numpy draws, through the kernels' plain versions and through dense
    attention;
  * the optimizer (clip -> AdamW -> warmup-cosine LR, bf16 moments, grad
    accumulation) and the EMA over three steps against optax;
  * the losses, the target schedule, dropout on its own terms;
  * run_training, validation, and a checkpoint round trip.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import jax_model_and_params, shrunk_cfg, torch_model
from multimodal_diffusion_torch.infer.sample_clip import build_components
from multimodal_diffusion_torch.models import mmdit as TM
from multimodal_diffusion_torch.ops.attention import attention_path
from multimodal_diffusion_torch.train import checkpoint as TC
from multimodal_diffusion_torch.train import losses as TL
from multimodal_diffusion_torch.train import trainer as TT
from multimodal_diffusion_torch.train.mask_schedule import Any2AnySchedule as TSchedule
from multimodal_diffusion_torch.utils.convert import jax_params_to_state_dict
from multimodal_diffusion_tpu.ops import schedule as JS
from multimodal_diffusion_tpu.train import losses as JL
from multimodal_diffusion_tpu.train import trainer as JT
from multimodal_diffusion_tpu.train.mask_schedule import Any2AnySchedule as JSchedule

B = 2


@pytest.fixture(scope="module")
def parity():
    """Shrunk config, JAX model + perturbed params, the port's model on the
    same weights, one batch and one set of draws (sample 0's conditioning is
    CFG-dropped, so exactly-zero token rows go through the core)."""
    cfg = shrunk_cfg()
    jm, params = jax_model_and_params(cfg, seed=4)
    s = JT.latent_shapes_from_config(cfg, B)
    rng = np.random.default_rng(0)
    batch = {"video": rng.uniform(0, 1, s["video"]).astype(np.float32),
             "audio": rng.uniform(-1, 1, s["audio"]).astype(np.float32),
             "has_video": np.array([True, True]), "has_audio": np.array([True, False])}
    draws = {"t_v": np.array([10, 900]), "t_a": np.array([500, 3]),
             "noise_v": rng.normal(size=s["z_video"]).astype(np.float32),
             "noise_a": rng.normal(size=s["z_audio"]).astype(np.float32),
             "cfg_u": np.array([0.05, 0.9], np.float32),
             "clean_u": np.array([0.5, 0.5], np.float32)}
    _, abar = JS.alphas_cumprod_from_betas(JS.make_beta_schedule(1000, "cosine", 1e-4, 0.02))
    return cfg, jm, params, s, batch, draws, abar


_JAX_CACHE = {}


def _jax_loss_and_grads(parity, target_is_video):
    """jax.value_and_grad of the JAX train loss (deterministic), once per
    target."""
    if target_is_video in _JAX_CACHE:
        return _JAX_CACHE[target_is_video]
    cfg, jm, params, _, batch, d, abar = parity
    keep_nt = 1.0 - (d["cfg_u"] < 0.1).astype(np.float32)
    w = target_is_video
    keep_v, keep_a = w + (1 - w) * keep_nt, w * keep_nt + (1 - w)

    def loss_fn(p):
        out = jm.apply({"params": p}, batch["video"], batch["audio"], d["t_v"], d["t_a"],
                       d["noise_v"], d["noise_a"], jnp.asarray(abar), jnp.asarray(abar),
                       jnp.asarray(keep_v), jnp.asarray(keep_a), deterministic=True)
        return JL.mse_targets_only(out["eps_v"], out["eps_a"], out["eps_true_v"],
                                   out["eps_true_a"], jnp.asarray(w),
                                   jnp.asarray(batch["has_video"]),
                                   jnp.asarray(batch["has_audio"]))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    _JAX_CACHE[target_is_video] = float(loss), jax_params_to_state_dict(grads)
    return _JAX_CACHE[target_is_video]


@pytest.mark.parametrize("target_is_video", [1.0, 0.0])
@pytest.mark.parametrize("kernel", [True, False])
def test_train_loss_and_every_grad_match_jax(parity, kernel, target_is_video):
    """Loss within 1e-5 relative; every parameter's grad within 2e-4 of its
    largest magnitude (fp32; the 3-D convolution grads sum over 27*C taps
    and B*T*H*W positions in another order: readings up to 3.2e-5). The
    decoders are not in the loss: their grads are zero on both sides, and
    every grad is finite although sample 0 is CFG-dropped."""
    cfg, jm, params, s, batch, draws, abar = parity
    j_loss, j_grads = _jax_loss_and_grads(parity, target_is_video)
    tm = torch_model(cfg, params)  # eval(): no dropout, as deterministic=True
    sc = TT.StepConfig(z_video_shape=s["z_video"], z_audio_shape=s["z_audio"], T_v=1000,
                       T_a=1000, cfg_drop_prob=0.1)
    ab = torch.from_numpy(abar)
    with attention_path("kernel" if kernel else "dense"):
        loss, parts = TT.train_loss(tm, sc, ab, ab,
                                    TT.batch_to_device(batch, torch.device("cpu")),
                                    target_is_video,
                                    {k: torch.from_numpy(v) for k, v in draws.items()})
        loss.backward()
    assert float(parts["loss_main"].detach()) == float(loss.detach())
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=1e-5)
    for name, p in tm.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        ref = j_grads[name].numpy()
        assert np.all(np.isfinite(g)), name
        np.testing.assert_allclose(g, ref, rtol=0, atol=2e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=name)


def _opt_cfg(mv_dtype="fp32", accum=1):
    cfg = shrunk_cfg()
    cfg["training"]["optimizer"].update(mv_dtype=mv_dtype, lr=0.05)
    cfg["training"]["max_steps"] = 6
    cfg["data"]["grad_accum_steps"] = accum
    return cfg


def _adam_state(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


@pytest.mark.parametrize("mv_dtype,accum", [("fp32", 1), ("bf16", 1), ("fp32", 2)])
def test_optimizer_and_ema_match_optax(mv_dtype, accum):
    """Three steps of the port's AdamW against make_optimizer(cfg)'s optax
    transform on the same grads (clipped at step 1, unclipped after), and
    the EMA of the 'core' subtree. fp32: 1e-6; bf16 moments: the same
    rounding on both sides, 1e-6 on the params and one bf16 ulp (2^-8
    relative) on the stored moments."""
    cfg = _opt_cfg(mv_dtype, accum)
    rng = np.random.default_rng(7)
    shapes = {"core": {"w": (8, 4), "b": (4,)}, "head": {"w": (3, 5)}}
    params = jax.tree_util.tree_map(lambda sh: rng.normal(size=sh).astype(np.float32), shapes,
                                    is_leaf=lambda x: isinstance(x, tuple))
    scales = [3.0, 0.2, 0.5]  # global grad norm above, then below, the clip of 1
    grads = [jax.tree_util.tree_map(lambda p, c=c: (c * rng.normal(size=p.shape) / np.sqrt(
        p.size * 3)).astype(np.float32), params) for c in scales]

    tx, _ = JT.make_optimizer(cfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = tx.init(j_params)
    j_ema = j_params["core"]
    names = ["core.w", "core.b", "head.w"]
    flat = lambda tree: [tree["core"]["w"], tree["core"]["b"], tree["head"]["w"]]  # noqa: E731
    t_params = [torch.tensor(np.array(x)) for x in flat(params)]
    opt = TT.make_optimizer(cfg, list(zip(names, t_params)))
    t_ema = [p.clone() for p in t_params[:2]]
    decay = 0.9
    for g in grads:
        updates, j_state = tx.update(g, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        j_ema = jax.tree_util.tree_map(lambda e, p: e * decay + p * (1 - decay), j_ema,
                                       j_params["core"])
        opt.step([torch.tensor(np.array(x)) for x in flat(g)])
        torch._foreach_mul_(t_ema, decay)
        torch._foreach_add_(t_ema, t_params[:2], alpha=1 - decay)
    for t, j in zip(t_params, flat(j_params)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    for t, j in zip(t_ema, [j_ema["w"], j_ema["b"]]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    adam = _adam_state(j_state)
    assert opt.count == int(adam.count) == 3 // accum
    tol = 1e-6 if mv_dtype == "fp32" else 2 ** -8
    for t, j in zip(opt.mu + opt.nu, flat(adam.mu) + flat(adam.nu)):
        assert t.dtype == (torch.float32 if mv_dtype == "fp32" else torch.bfloat16)
        jf = np.asarray(j, np.float32)
        np.testing.assert_allclose(t.float().numpy(), jf, rtol=tol, atol=tol * np.abs(jf).max())


def test_lr_schedule_matches_optax():
    cfg = shrunk_cfg()
    cfg["training"]["max_steps"] = 12
    j_sched = JT.make_lr_schedule(cfg)
    t_sched = TT.make_lr_schedule(cfg)
    for count in range(15):
        np.testing.assert_allclose(t_sched(count), float(j_sched(count)), rtol=1e-6,
                                   atol=1e-12)
    assert t_sched(0) == 0.0


def test_first_warmup_step_moves_no_parameter():
    """optax reads the LR at the count before the increment: a warmup run's
    first update has LR 0 and, with it, no weight decay either."""
    cfg = _opt_cfg()
    p = torch.ones(4)
    opt = TT.make_optimizer(cfg, [("w", p)])
    opt.step([torch.full((4,), 0.3)])
    assert torch.equal(p, torch.ones(4))
    opt.step([torch.full((4,), 0.3)])
    assert not torch.equal(p, torch.ones(4))


def _feats(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=sh).astype(np.float32) for sh in shapes]


@pytest.mark.parametrize("case", ["mse", "mse_masked", "align_cosine", "align_l2", "sync",
                                  "sync_weighted", "recon", "zero_weight"])
def test_losses_match_jax(case):
    """Each loss against the JAX one on the same numpy inputs, 1e-5; sync at
    the mvp token counts Nv=96 (6 time chunks) and Na=37, so the audio
    buckets are proportional (37 tokens into 6)."""
    T = torch.from_numpy
    if case.startswith("mse"):
        a, b, c, d = _feats(0, (3, 10, 8), (3, 5, 4), (3, 10, 8), (3, 5, 4))
        masks = ((np.array([True, False, True]), np.array([False, True, True]))
                 if case == "mse_masked" else (None, None))
        for w in (1.0, 0.0):
            j = JL.mse_targets_only(a, b, c, d, jnp.asarray(w),
                                    *(None if m is None else jnp.asarray(m) for m in masks))
            t = TL.mse_targets_only(T(a), T(b), T(c), T(d), w,
                                    *(None if m is None else T(m) for m in masks))
            np.testing.assert_allclose(float(t), float(j), rtol=1e-5)
        return
    if case.startswith("align"):
        hv, ha = _feats(1, (3, 96, 16), (3, 37, 16))
        method = case.split("_")[1]
        j = JL.alignment_loss(hv, ha, weight=0.7, method=method)
        t = TL.alignment_loss(T(hv), T(ha), weight=0.7, method=method)
    elif case.startswith("sync"):
        hv, ha = _feats(2, (3, 96, 16), (3, 37, 16))
        sw = np.array([1.0, 0.0, 1.0], np.float32) if case == "sync_weighted" else None
        j = JL.sync_contrastive_loss(hv, ha, 6, weight=0.5, tau=0.1,
                                     sample_weight=None if sw is None else jnp.asarray(sw))
        t = TL.sync_contrastive_loss(T(hv), T(ha), 6, weight=0.5, tau=0.1,
                                     sample_weight=None if sw is None else T(sw))
    elif case == "recon":
        rv, v, ra, a = _feats(3, (2, 3, 4, 8, 8), (2, 3, 4, 8, 8), (2, 1, 330), (2, 1, 320))
        m = np.array([True, False])
        j = JL.reconstruction_loss(rv, v, ra, a, weight=0.3, has_video=jnp.asarray(m))
        t = TL.reconstruction_loss(T(rv), T(v), T(ra), T(a), weight=0.3, has_video=T(m))
    else:
        hv, ha = _feats(4, (2, 8, 4), (2, 6, 4))
        for fn in (TL.alignment_loss, TL.sync_contrastive_loss):
            args = (T(hv), T(ha)) if fn is TL.alignment_loss else (T(hv), T(ha), 2)
            assert float(fn(*args, weight=0.0)) == 0.0
        return
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


@pytest.mark.parametrize("seed,probs", [(0, {"video": 0.5, "audio": 0.5}),
                                        (42, {"video": 0.8, "audio": 0.2}),
                                        (None, {"video": 1.0, "audio": 0.0})])
def test_any2any_schedule_is_the_jax_sequence(seed, probs):
    j, t = JSchedule(probs, seed=seed), TSchedule(probs, seed=seed)
    if seed is None:
        assert {t.sample_target() for _ in range(50)} == {"video"}
        return
    assert [t.sample_target() for _ in range(500)] == [j.sample_target() for _ in range(500)]


def test_q_sample_and_prediction_target_match_jax():
    """fp32 within 1e-6; bf16 latents come back in bf16 on both sides."""
    from multimodal_diffusion_torch.ops import schedule as TS

    rng = np.random.default_rng(5)
    x0, eps = _feats(5, (3, 8, 50), (3, 8, 50))
    t = rng.integers(0, 1000, 3)
    _, abar = JS.alphas_cumprod_from_betas(JS.make_beta_schedule(1000, "cosine", 1e-4, 0.02))
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tx0 = torch.from_numpy(x0).to(dtype)
        jx0 = jnp.asarray(x0, jdt)
        txt, teps = TS.q_sample(tx0, torch.from_numpy(t), torch.from_numpy(abar),
                                torch.from_numpy(eps))
        jxt, jeps = JS.q_sample(jx0, jnp.asarray(t), jnp.asarray(abar), eps=jnp.asarray(eps))
        assert txt.dtype == teps.dtype == dtype
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        np.testing.assert_allclose(txt.float().numpy(), np.asarray(jxt, np.float32),
                                   rtol=tol, atol=tol)
        for param in ("eps", "x0", "v"):
            tp = TS.prediction_target(tx0, teps, torch.from_numpy(t), torch.from_numpy(abar),
                                      param)
            jp = JS.prediction_target(jx0, jeps, jnp.asarray(t), jnp.asarray(abar), param)
            np.testing.assert_allclose(tp.float().numpy(), np.asarray(jp, np.float32),
                                       rtol=tol, atol=tol)
    with pytest.raises(ValueError):
        TS.prediction_target(tx0, teps, torch.from_numpy(t), torch.from_numpy(abar), "z")


def test_dropout_on_its_own_terms():
    """Zeroed share ~ rate, kept values scaled by 1/(1-rate), identity in
    eval mode, no draw without a generator; token dropout zeroes whole
    tokens without rescaling."""
    drop = TM.Dropout(0.25)
    x = torch.ones(200_000)
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(x)
    assert abs(float((y == 0).float().mean()) - 0.25) < 0.01
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
    assert torch.equal(drop.eval()(x), x)
    tok = TM.TokenDropout(0.5)
    tok.generator = torch.Generator().manual_seed(1)
    z = tok(torch.ones(4, 1000, 8))
    kept = z[..., 0]
    assert torch.equal(z, kept[..., None].expand_as(z)) and set(kept.unique().tolist()) == {0, 1}
    assert abs(float(kept.mean()) - 0.5) < 0.05


def test_model_dropout_follows_train_and_eval():
    """At dropout 0.1 the training forward draws from the trainer's
    generator (two passes differ), while eval() gives the deterministic
    forward."""
    cfg = shrunk_cfg()
    cfg["model"]["core"].update(dropout=0.1, attn_dropout=0.1, token_dropout=0.1)
    bundle = TT.create_trainer(cfg, device="cpu", batch_size=B)
    m = bundle.model
    rng = np.random.default_rng(1)
    tok_v = torch.from_numpy(rng.normal(size=(B, 16, 16)).astype(np.float32))
    tok_a = torch.from_numpy(rng.normal(size=(B, 12, 32)).astype(np.float32))
    t = torch.tensor([3, 700])
    run = lambda: m.denoise_tokens(tok_v, tok_a, t, t, (1, 4, 4))["eps_a"]  # noqa: E731
    with torch.no_grad():
        a, b = run(), run()
        m.eval()
        c, d = run(), run()
    assert not torch.equal(a, b)
    assert torch.equal(c, d)


def _synthetic_batches(shapes, seed=0):
    rng = np.random.default_rng(seed)
    Bn = shapes["video"][0]
    while True:
        yield {"video": rng.uniform(0, 1, shapes["video"]).astype(np.float32),
               "audio": rng.uniform(-1, 1, shapes["audio"]).astype(np.float32),
               "has_video": np.ones(Bn, bool), "has_audio": np.ones(Bn, bool)}


def test_run_training_loss_falls():
    """20 steps on the CPU through create_trainer + run_training, the
    kernels' plain versions: finite losses that fall, the EMA moves, and the
    log carries throughput."""
    cfg = shrunk_cfg()
    cfg["training"].update(log_every=1, ckpt_every=10, val_every=0)
    with attention_path("kernel"):
        bundle = TT.create_trainer(cfg, device="cpu", batch_size=B)
        ema0 = {k: v.clone() for k, v in bundle.state.ema.items()}
        logs, ckpts = [], []
        state = TT.run_training(cfg, bundle, _synthetic_batches(bundle.latent_shapes),
                                max_steps=20, log_fn=lambda s, m: logs.append(m),
                                checkpoint_fn=lambda s, st: ckpts.append(s))
        val = TT.run_validation(bundle, _synthetic_batches(bundle.latent_shapes, 3),
                                n_batches=2)
        again = TT.run_validation(bundle, _synthetic_batches(bundle.latent_shapes, 3),
                                  n_batches=2)
    assert state.step == 20 and ckpts == [10, 20]
    losses = [m["loss"] for m in logs]
    assert all(np.isfinite(losses)) and all(np.isfinite([m["grad_norm"] for m in logs]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert {"steps_per_sec", "clips_per_sec", "loss_main", "loss_sync"} <= set(logs[0])
    assert any(not torch.equal(v, ema0[k]) for k, v in state.ema.items())
    assert val == again and all(np.isfinite(list(val.values())))
    assert bundle.model.training


def test_run_training_validates_and_stops_on_request():
    """val_fn runs every val_every steps with the live state; should_stop
    ends the loop after the step that set it; a batch's own "target" is
    used in place of the schedule's pick."""
    cfg = shrunk_cfg()
    cfg["training"].update(log_every=100, ckpt_every=100, val_every=2)
    bundle = TT.create_trainer(cfg, device="cpu", batch_size=B)
    vals = []
    batches = ({**b, "target": "video"} for b in _synthetic_batches(bundle.latent_shapes))
    state = TT.run_training(cfg, bundle, batches, max_steps=10,
                            val_fn=lambda step, st: vals.append((step, st.step)),
                            should_stop=lambda: bundle.state.step >= 5)
    assert state.step == 5 and vals == [(2, 2), (4, 4)]


def test_uint8_video_is_normalised_on_the_device():
    """The host ships uint8 [B, T, H, W, 3]; the step sees [B, 3, T, H, W]
    in [0, 1], as the JAX step's on-device preprocessing."""
    frames = np.random.default_rng(4).integers(0, 256, (2, 4, 8, 8, 3), dtype=np.uint8)
    b = TT.batch_to_device({"video": frames, "audio": np.zeros((2, 1, 8), np.float32)},
                           torch.device("cpu"))
    expected = frames.astype(np.float32).transpose(0, 4, 1, 2, 3) / 255.0
    np.testing.assert_allclose(b["video"].numpy(), expected, rtol=1e-7)


def test_metric_writer_appends_jsonl(tmp_path):
    from multimodal_diffusion_torch.train.metrics import MetricWriter

    w = MetricWriter(tmp_path / "logs", use_tensorboard=False)
    w.write(5, {"loss": 1.5, "clips_per_sec": 20})
    w.write(10, {"loss": 1.25})
    w.close()
    recs = [json.loads(x) for x in (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["loss"]) for r in recs] == [(5, 1.5), (10, 1.25)]
    assert recs[0]["clips_per_sec"] == 20.0


def test_checkpoint_round_trip_continues_bit_identically(tmp_path):
    """Save after 2 steps; a trainer built with another seed and restored
    from the checkpoint takes a next step bit-identical to the original's
    (params, moments, EMA, generator). build_components then restores the
    same weights for sampling, with the EMA core swapped in on request."""
    cfg = shrunk_cfg()
    cfg["model"]["core"]["dropout"] = 0.1  # the generator state matters
    batches = _synthetic_batches(JT.latent_shapes_from_config(cfg, B), seed=2)
    a = TT.create_trainer(cfg, device="cpu", batch_size=B)
    for _ in range(2):
        a.train_step(a.state, next(batches), 1.0)
    mgr = TC.CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    mgr.save(a.state.step, TC.state_to_tree(a.state), meta={"note": "test"})
    mgr.save(a.state.step, TC.state_to_tree(a.state))  # idempotent
    assert mgr.latest_step() == 2 and mgr.meta(2) == {"note": "test"}

    b = TT.create_trainer(cfg, device="cpu", batch_size=B, seed=123)
    TC.restore_state(b.state, mgr.restore())
    batch = next(batches)
    ma = a.train_step(a.state, batch, 0.0)
    mb = b.train_step(b.state, batch, 0.0)
    assert a.state.step == b.state.step == 3
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    for x, y in zip(a.state.optimizer.mu + a.state.optimizer.nu,
                    b.state.optimizer.mu + b.state.optimizer.nu):
        assert torch.equal(x, y)
    assert all(torch.equal(a.state.ema[k], b.state.ema[k]) for k in a.state.ema)

    for step in (3, 4, 5):  # max_to_keep drops the oldest
        mgr.save(step, TC.state_to_tree(a.state))
    assert mgr.all_steps() == [4, 5]
    serve_cfg = {**cfg, "paths": {"ckpt_path": str(tmp_path / "ckpt" / "latest")}}
    model = build_components(serve_cfg, device="cpu")
    assert not model.training
    for n, p in model.named_parameters():
        assert torch.equal(p, dict(a.model.named_parameters())[n]), n
    ema_model = build_components(serve_cfg, device="cpu", use_ema=True)
    core_w = "core.blocks.0.attn.qkv.weight"
    assert torch.equal(dict(ema_model.named_parameters())[core_w], a.state.ema[core_w])
