"""The pixel-space DDPM family of the port against the JAX package, on the
CPU at a tiny size (8x8 images of patch 4: 4 tokens; core d=32, one layer,
2 heads; 20 diffusion steps):

* ``ddpm_step`` at t in {0, 1, 500, 999}, with and without clip_x0, within
  1e-6;
* the ``PixelDiT`` forward in fp32 within 1e-5; the weight carry both ways,
  bit for bit;
* one ``make_pixel_train_step`` with the JAX step's own t and noise and the
  port's AdamW against optax: the loss within 1e-5 relative, the
  parameters within 1e-6;
* the 20-step ancestral sampler from the JAX sampler's own x_T and z within
  1e-4 of the magnitude;
* ``iter_image_batches`` bit-equal for PNG (PIL crop and resize) and JPEG
  (the native decoder) folders;
* both CLIs end to end on ``--device cpu``, ``sample_pixel`` restoring a JAX
  orbax pixel checkpoint, and the entry points refusing a missing card;
* the JAX test's own properties: the loss falls on constant images and the
  samples lie in [-1, 1].
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from PIL import Image

from _torch_parity import native_loaders, perturb  # noqa: F401 (a fixture)
from multimodal_diffusion_torch.infer import sample_pixel as TSP
from multimodal_diffusion_torch.models import image_diffusion as TI
from multimodal_diffusion_torch.ops import schedule as TS
from multimodal_diffusion_torch.train import train_pixel as TTP
from multimodal_diffusion_torch.train.checkpoint import CheckpointManager
from multimodal_diffusion_torch.train.trainer import AdamW, make_optimizer
from multimodal_diffusion_torch.utils.convert import (_leaves, jax_params_to_state_dict,
                                                      load_jax_params,
                                                      state_dict_to_jax_params)
from multimodal_diffusion_tpu.models import image_diffusion as JI
from multimodal_diffusion_tpu.ops import schedule as JS
from multimodal_diffusion_tpu.train import train_pixel as JTP
from multimodal_diffusion_tpu.train.trainer import make_optimizer as j_make_optimizer

B = 4


def pixel_cfg(tmp_path=None) -> dict:
    """A tiny configs/pixel32.yaml (fp32, a constant LR so the first step
    moves the weights)."""
    root = tmp_path if tmp_path is not None else "unused"
    return {
        "seed": 3, "mixed_precision": "fp32",
        "paths": {"ckpt_dir": f"{root}/ckpt", "log_dir": f"{root}/logs"},
        "data": {"train_images": f"{root}/images", "batch_size": B},
        "image": {"size": 8, "channels": 3},
        "tokenizer": {"image": {"patch": 4}},
        "model": {"core": {"d_model": 32, "n_layers": 1, "n_heads": 2, "mlp_ratio": 2.0,
                           "dropout": 0.0, "norm": "rmsnorm"}},
        "diffusion": {"image": {"steps": 20, "schedule": "cosine", "min_beta": 1e-4,
                                "max_beta": 0.02}},
        "training": {"optimizer": {"lr": 1e-3, "weight_decay": 0.01, "betas": [0.9, 0.999],
                                   "eps": 1e-8},
                     "scheduler": {"name": "none"}, "max_steps": 3, "log_every": 1,
                     "ckpt_every": 2, "grad_clip_norm": 1.0},
    }


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pixel():
    """(cfg, JAX model, perturbed JAX params, port model on them, images)."""
    cfg = pixel_cfg()
    jm = JI.PixelDiT(JI.PixelDiTConfig.from_config(cfg))
    images = np.random.default_rng(0).uniform(-1, 1, (B, 3, 8, 8)).astype(np.float32)
    params = perturb(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(images),
                             jnp.zeros((B,), jnp.int32))["params"], seed=5)
    tm = TI.PixelDiT(TI.PixelDiTConfig.from_config(cfg))
    load_jax_params(tm, params).eval()
    return cfg, jm, params, tm, images


# ---------------------------------------------------------------------------
# ddpm_step, config, forward, weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [None, (-1.0, 1.0)], ids=["noclip", "clip"])
@pytest.mark.parametrize("t", [0, 1, 500, 999])
def test_ddpm_step_matches_jax(t, clip):
    """fp32 inputs (and a bf16 x_t cast back), the cosine 1000-step schedule,
    posterior and plain variance: within 1e-6; no noise at t == 0."""
    betas = JS.make_beta_schedule(1000, "cosine")
    abar = JS.alphas_cumprod_from_betas(betas)[1]
    rng = np.random.default_rng(t)
    x, eps, z = (rng.normal(size=(2, 3, 4, 4)).astype(np.float32) for _ in range(3))
    tt = np.array([t, t], np.int32)
    for posterior in (True, False):
        want = np.asarray(JS.ddpm_step(jnp.asarray(x), jnp.asarray(tt), jnp.asarray(eps),
                                       jnp.asarray(betas), jnp.asarray(abar), jnp.asarray(z),
                                       posterior_variance=posterior, clip_x0=clip))
        got = TS.ddpm_step(_t(x), _t(tt), _t(eps), _t(betas), _t(abar), _t(z),
                           posterior_variance=posterior, clip_x0=clip)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    got_bf16 = TS.ddpm_step(_t(x).bfloat16(), _t(tt), _t(eps), _t(betas), _t(abar), _t(z),
                            clip_x0=clip)
    assert got_bf16.dtype == torch.bfloat16
    if t == 0:
        again = TS.ddpm_step(_t(x), _t(tt), _t(eps), _t(betas), _t(abar), 5.0 * _t(z),
                             clip_x0=clip)
        assert torch.equal(again, TS.ddpm_step(_t(x), _t(tt), _t(eps), _t(betas), _t(abar),
                                               _t(z), clip_x0=clip))


def test_pixel_config_reads_pixel32_as_jax_does():
    from multimodal_diffusion_torch.utils.io import load_config

    cfg = load_config("configs/pixel32.yaml")
    j = JI.PixelDiTConfig.from_config(cfg, dtype=jnp.bfloat16)
    t = TI.PixelDiTConfig.from_config(cfg, dtype=torch.bfloat16)
    for f in ("image_size", "channels", "patch", "width", "steps", "schedule", "min_beta",
              "max_beta", "n_tokens", "token_dim"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("d_model", "n_layers", "n_heads", "mlp_ratio", "dropout", "norm"):
        assert getattr(t.core, f) == getattr(j.core, f), f
    assert (t.width, t.core.n_layers, t.core.n_heads, t.n_tokens) == (384, 12, 6, 64)
    assert t.core.dtype == torch.bfloat16


def test_pixel_dit_forward_matches_jax(pixel):
    cfg, jm, params, tm, images = pixel
    t = np.array([0, 5, 12, 19], np.int32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(t)))
    with torch.no_grad():
        got = tm(_t(images), _t(t))
    assert got.shape == (B, 3, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pixel_weight_carry_is_bit_exact_both_ways(pixel):
    params = pixel[2]
    leaves = dict(_leaves(params))
    sd = jax_params_to_state_dict(params)
    assert len(sd) == len(leaves)
    port = TI.PixelDiT(TI.PixelDiTConfig.from_config(pixel_cfg()))
    port.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in port.parameters()) == sum(np.size(v) for v in leaves.values())
    assert {"adapter.proj.weight", "pos.table", "core.blocks.0.norm1.weight",
            "core.blocks.0.attn.qkv.weight", "core.norm.weight", "head.blocks.0.dense.weight",
            "head.blocks.0.norm.bias", "head.out.weight"} <= set(sd)
    back = dict(_leaves(state_dict_to_jax_params(port.state_dict())))
    assert back.keys() == leaves.keys()
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg="/".join(k))


# ---------------------------------------------------------------------------
# train step and sampler
# ---------------------------------------------------------------------------


def test_pixel_train_step_matches_jax(pixel):
    """The JAX step with its own key against the port's step given the same
    t and noise (split from that key as the JAX step splits it): the loss
    within 1e-5 relative; the port's AdamW on JAX's grads within 1e-6 of
    optax on them everywhere, and the port's whole step (and optax on
    those grads) against the JAX step where JAX's gradient is
    above 1e-6 of the largest (below, Adam's first step g / (|g| + eps)
    turns rounding noise of a gradient that is 0 in exact arithmetic, the
    key third of the qkv bias, into steps of up to lr)."""
    cfg, jm, params, tm, images = pixel
    key = jax.random.PRNGKey(11)
    _, kt, kn = jax.random.split(key, 3)
    t = np.asarray(jax.random.randint(kt, (B,), 0, 20))
    noise = np.asarray(jax.random.normal(kn, images.shape, jnp.float32))
    tx, _ = j_make_optimizer(cfg)
    j_params, _, _, j_loss = jax.jit(JI.make_pixel_train_step(jm, tx))(
        params, tx.init(params), key, jnp.asarray(images))
    j_after = jax_params_to_state_dict(j_params)

    abar = JS.alphas_cumprod_from_betas(JS.make_beta_schedule(20))[1]

    def loss_fn(p):
        x_t, eps = JS.q_sample(jnp.asarray(images), jnp.asarray(t), jnp.asarray(abar),
                               jnp.asarray(noise))
        eps_hat = jm.apply({"params": p}, x_t, jnp.asarray(t), False)
        return jnp.mean(jnp.square(eps_hat - eps))

    j_grad_tree = jax.jit(jax.grad(loss_fn))(params)
    updates, _ = tx.update(j_grad_tree, tx.init(params), params)
    j_after_g = jax_params_to_state_dict(optax.apply_updates(params, updates))
    j_grads = jax_params_to_state_dict(j_grad_tree)
    top = max(float(g.abs().max()) for g in j_grads.values())

    model = copy.deepcopy(tm)
    opt = make_optimizer(cfg, list(model.named_parameters()))
    opt.step([j_grads[n] for n, _ in model.named_parameters()])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), j_after_g[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
        held = j_grads[name].abs().numpy() > 1e-6 * top  # the draws are the JAX step's
        np.testing.assert_allclose(j_after_g[name].numpy()[held], j_after[name].numpy()[held],
                                   rtol=0, atol=1e-6, err_msg=name)

    model = copy.deepcopy(tm)
    step = TI.make_pixel_train_step(model, make_optimizer(cfg, list(model.named_parameters())))
    loss = step(_t(images), {"t": _t(t).long(), "noise": _t(noise)})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for name, p in model.named_parameters():
        held = j_grads[name].abs().numpy() > 1e-6 * top
        np.testing.assert_allclose(p.detach().numpy()[held], j_after[name].numpy()[held],
                                   rtol=0, atol=1e-6, err_msg=name)
    assert not torch.equal(model.head.out.weight, tm.head.out.weight)


def test_draw_pixel_randomness_shapes():
    c = TI.PixelDiTConfig.from_config(pixel_cfg())
    d = TI.draw_pixel_randomness(torch.Generator().manual_seed(0), c, 64)
    assert d["t"].shape == (64,) and 0 <= int(d["t"].min()) and int(d["t"].max()) < 20
    assert d["noise"].shape == (64, 3, 8, 8) and d["noise"].dtype == torch.float32


def _jax_sampler_draws(seed: int, shape, steps: int):
    """x_T and the per-step z exactly as the JAX sampler draws them."""
    rng, k0 = jax.random.split(jax.random.PRNGKey(seed))
    x_T = np.asarray(jax.random.normal(k0, shape, jnp.float32))
    zs = []
    for _ in range(steps):
        rng, kz = jax.random.split(rng)
        zs.append(np.asarray(jax.random.normal(kz, shape, jnp.float32)))
    return x_T, np.stack(zs)


def test_ancestral_sampler_matches_jax(pixel):
    """20 steps from the JAX sampler's own draws: within 1e-4 of the
    magnitude; a generator's draws give another sample, in [-1, 1]."""
    cfg, jm, params, tm, _ = pixel
    want = np.asarray(jax.jit(JI.make_ancestral_sampler(jm), static_argnums=(2,))(
        params, jax.random.PRNGKey(2), 3))
    x_T, z = _jax_sampler_draws(2, (3, 3, 8, 8), 20)
    sample = TI.make_ancestral_sampler(tm)
    got = sample(3, x_T=_t(x_T), z=_t(z)).numpy()
    assert got.shape == (3, 3, 8, 8)
    assert float(np.abs(got - want).max()) <= 1e-4 * max(1.0, float(np.abs(want).max()))
    drawn = sample(3, torch.Generator().manual_seed(0)).numpy()
    assert np.isfinite(drawn).all() and drawn.min() >= -1.0 and drawn.max() <= 1.0
    assert not np.array_equal(drawn, got)
    with pytest.raises(ValueError, match="generator"):
        sample(3, x_T=_t(x_T))


def test_loss_falls_on_constant_images_and_samples_stay_in_range():
    """The JAX test's properties at its own size (8x8x1, one layer of d=32,
    Adam at 1e-3, 30 steps on four constant images)."""
    cfg = pixel_cfg()
    cfg["image"]["channels"] = 1
    cfg["training"]["optimizer"]["weight_decay"] = 0.0
    cfg["training"]["grad_clip_norm"] = 1e9
    model = TTP.build_pixel_model(cfg, "cpu")
    step = TI.make_pixel_train_step(model, make_optimizer(cfg, list(model.named_parameters())),
                                    torch.Generator().manual_seed(1))
    data = torch.stack([torch.full((1, 8, 8), v) for v in (0.5, -0.5, 0.0, 0.25)])
    losses = [float(step(data)) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    imgs = TI.make_ancestral_sampler(model)(2, torch.Generator().manual_seed(2)).numpy()
    assert imgs.shape == (2, 1, 8, 8)
    assert np.isfinite(imgs).all() and imgs.min() >= -1.0 and imgs.max() <= 1.0


# ---------------------------------------------------------------------------
# images in, the CLIs
# ---------------------------------------------------------------------------


def _write_images(root, kind: str, n: int = 10, size=(40, 30)):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    for i in range(n):
        arr = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / f"img_{i:03d}.{kind}", quality=90)
    return root


@pytest.mark.parametrize("kind,size", [("png", (40, 30)), ("jpg", (8, 8))])
def test_iter_image_batches_is_bit_equal_to_jax(tmp_path, kind, size, native_loaders):
    """PNGs of 40x30 (PIL: center crop to 30x30, bilinear to 8x8) and square
    JPEGs (the native decoder, built by each package and whole before the
    comparison: ``native_loaders``): three epochs' worth of batches of 4
    from 10 images, bit for bit."""
    TN, JN = native_loaders
    root = _write_images(tmp_path / kind, kind, size=size)
    if kind == "jpg":
        assert TN.available() and JN.available()
    got = TTP.iter_image_batches(root, 8, 4, seed=5)
    want = JTP.iter_image_batches(root, 8, 4, seed=5)
    for _ in range(6):
        a, b = next(got), next(want)
        assert a.dtype == np.float32 and a.shape == (4, 3, 8, 8)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        next(TTP.iter_image_batches(tmp_path / "empty", 8, 4))


def _write_cfg(tmp_path, cfg):
    path = tmp_path / "pixel_tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_cli_train_then_sample_on_the_cpu(tmp_path, capsys):
    """train_pixel: 3 steps, loss logged each step, checkpoints at 2 and 3;
    sample_pixel restores step 3 (the port's format) and writes 2 PNGs,
    the same bits for the same seed."""
    import json

    cfg = pixel_cfg(tmp_path)
    _write_images(tmp_path / "images", "png")
    path = _write_cfg(tmp_path, cfg)
    assert TTP.main(["--config", str(path), "--device", "cpu"]) == 3
    assert CheckpointManager(tmp_path / "ckpt").all_steps() == [2, 3]
    recs = [json.loads(line) for line in (tmp_path / "logs" / "metrics.jsonl").open()]
    assert [r["step"] for r in recs] == [1, 2, 3] and all(np.isfinite(r["loss"]) for r in recs)
    tree = CheckpointManager(tmp_path / "ckpt").restore(3)
    assert tree["step"] == 3
    capsys.readouterr()
    out = TSP.main(["--config", str(path), "--num", "2", "--out-dir", str(tmp_path / "png"),
                    "--device", "cpu"])
    assert "[ckpt] restored step 3" in capsys.readouterr().out
    assert [p.name for p in out] == ["sample_0000.png", "sample_0001.png"]
    first = [np.asarray(Image.open(p)) for p in out]
    assert first[0].shape == (8, 8, 3) and first[0].dtype == np.uint8
    again = TSP.main(["--config", str(path), "--num", "2", "--out-dir", str(tmp_path / "png2"),
                      "--device", "cpu"])
    assert all(np.array_equal(a, np.asarray(Image.open(p))) for a, p in zip(first, again))
    model = TSP.build_pixel(cfg, "cpu")
    assert all(torch.equal(v, tree["params"][k]) for k, v in model.state_dict().items())


def test_sample_pixel_restores_a_jax_orbax_checkpoint(pixel, tmp_path, capsys):
    """A step written by the JAX package's CheckpointManager as its
    train_pixel writes it ({step, params}); random weights, with the JAX
    package's messages, without one."""
    from multimodal_diffusion_tpu.train.checkpoint import CheckpointManager as JaxManager

    cfg = pixel_cfg(tmp_path)
    TSP.build_pixel(cfg, "cpu")
    assert "[info] no ckpt dir; random weights" in capsys.readouterr().out
    (tmp_path / "ckpt").mkdir()
    TSP.build_pixel(cfg, "cpu")
    assert "[warn] no checkpoints; random weights" in capsys.readouterr().out
    params = pixel[2]
    mgr = JaxManager(tmp_path / "ckpt")
    mgr.save(7, {"step": 7, "params": params}, wait=True)
    mgr.close()
    model = TSP.build_pixel(cfg, "cpu")
    assert "[ckpt] restored step 7" in capsys.readouterr().out
    want = jax_params_to_state_dict(params)
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    imgs, u8 = TSP.sample_pixel_images(model, 2, seed=1)
    assert imgs.shape == (2, 3, 8, 8) and u8.shape == (2, 8, 8, 3)
    np.testing.assert_array_equal(u8, ((imgs.transpose(0, 2, 3, 1) + 1.0) * 127.5)
                                  .astype(np.uint8))


def test_pixel_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write_cfg(tmp_path, pixel_cfg(tmp_path))
    for main in (TTP.main, TSP.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--config", str(path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSP.build_pixel(pixel_cfg(tmp_path))


def test_pixel_train_step_takes_a_bf16_model():
    """bf16 compute (mixed_precision bf16) with fp32 parameters: a finite
    loss, fp32 parameters after the step."""
    cfg = pixel_cfg()
    cfg["mixed_precision"] = "bf16"
    model = TTP.build_pixel_model(cfg, "cpu")
    assert model.cfg.core.dtype == torch.bfloat16
    opt = AdamW(list(model.named_parameters()), lambda count: 1e-3)
    step = TI.make_pixel_train_step(model, opt, torch.Generator().manual_seed(0))
    loss = step(torch.zeros((2, 3, 8, 8)))
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    assert all(p.dtype == torch.float32 for p in model.parameters())
