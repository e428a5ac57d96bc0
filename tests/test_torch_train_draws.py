"""``run_training``'s `draws`: each step's random values handed to the loop
(timesteps, latent noise, CFG and clean-conditioning uniforms), on the CPU
at a tiny flagship size (benchmark/tests/tiny.py). Without them the loop is
the one it was, bit for bit; with them it equals ``train_step`` fed the same
draws, and the plain training reference (benchmark/reference/av_training.py)
handed the same draws and the dropout uniforms the program drew."""

import math

import pytest
import torch

from benchmark.reference import av_sampling as avs
from benchmark.reference import av_training as ref
from benchmark.tests.tiny import tiny
from benchmark.weights import make_weights
from multimodal_diffusion_torch.models.mmdit import Dropout
from multimodal_diffusion_torch.train.trainer import (create_trainer, draw_step_randomness,
                                                      run_training)

B = 2


@pytest.fixture(scope="module")
def cfg():
    c = tiny("spec8")
    c["training"]["scheduler"]["warmup_steps"] = 1  # the second update moves the weights
    c["training"]["optimizer"]["mv_dtype"] = "fp32"
    c["training"]["log_every"] = 1
    return c


@pytest.fixture(scope="module")
def weights(cfg):
    return make_weights(avs.param_shapes(cfg), 2**35 + 9, "cpu", torch.float32)


def bundle_of(cfg, weights):
    b = create_trainer(cfg, device="cpu", batch_size=B, seed=5)
    b.model.load_state_dict(weights, strict=True)
    return b


def batches_of(cfg, n=2, seed=9):
    s = avs.sizes(cfg)
    g = torch.Generator().manual_seed(seed)
    return [{"video": torch.randint(0, 256, (B, s["T"], s["H"], s["W"], 3), generator=g,
                                    dtype=torch.uint8),
             "audio": torch.rand(B, 1, s["L"], generator=g) - 0.5,
             "target": ("audio", "video")[k % 2]} for k in range(n)]


def draws_of(bundle, n=2, seed=11):
    g = torch.Generator().manual_seed(seed)
    return [draw_step_randomness(g, bundle.step_config) for _ in range(n)]


def params(bundle):
    return {n: p.detach().clone() for n, p in bundle.model.named_parameters()}


def test_without_draws_the_loop_is_unchanged(cfg, weights):
    """The loop's own draws: each step draws from the trainer's generator,
    as train_step does when handed nothing."""
    batches = batches_of(cfg)
    a, b = bundle_of(cfg, weights), bundle_of(cfg, weights)
    run_training(cfg, a, iter(batches), max_steps=2)
    for batch in batches:
        b.train_step(b.state, batch, 1.0 if batch["target"] == "video" else 0.0)
    pa, pb = params(a), params(b)
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    assert a.state.step == b.state.step == 2


def test_handed_draws_equal_train_step_fed_them(cfg, weights):
    batches = batches_of(cfg)
    a, b = bundle_of(cfg, weights), bundle_of(cfg, weights)
    draws = draws_of(a)
    run_training(cfg, a, iter(batches), max_steps=2, draws=iter(draws))
    for batch, d in zip(batches, draws):
        b.train_step(b.state, batch, 1.0 if batch["target"] == "video" else 0.0, d)
    pa, pb = params(a), params(b)
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    # and they are not the generator's own draws
    c = bundle_of(cfg, weights)
    run_training(cfg, c, iter(batches), max_steps=2)
    assert not all(torch.equal(pa[n], p) for n, p in params(c).items())


def test_handed_draws_equal_the_training_reference(cfg, weights):
    """The losses of both steps within 1e-5 and the parameters' change
    within 2e-2 of its size (fp32 on both sides; Adam divides each
    gradient element by its own magnitude, so elements whose gradient is
    near zero carry the sums' rounding into the update)."""
    batches = batches_of(cfg, seed=13)
    bundle = bundle_of(cfg, weights)
    draws = draws_of(bundle, seed=17)
    masks = {}
    for name, mod in bundle.model.named_modules():
        if isinstance(mod, Dropout):
            def record(shape, device, _draw=mod._uniform, _name=name):
                u = _draw(shape, device)
                masks.setdefault(_name, []).append(u.clone())
                return u
            mod._uniform = record
    losses = []
    run_training(cfg, bundle, iter(batches), max_steps=2, draws=iter(draws),
                 log_fn=lambda step, m: losses.append(float(m["loss"])))
    assert {len(v) for k, v in masks.items() if k.startswith("core.")} == {2}
    steps = [(b["video"], b["audio"], 1.0 if b["target"] == "video" else 0.0, d)
             for b, d in zip(batches, draws)]
    run = ref.train(weights, cfg, steps, masks)
    ref_losses, ref_params = run.losses, run.params
    assert losses == pytest.approx(ref_losses, rel=1e-5)
    after = params(bundle)
    num = sum(float(((after[n] - weights[n]) - (ref_params[n] - weights[n])).pow(2).sum())
              for n in weights)
    den = sum(float((ref_params[n] - weights[n]).pow(2).sum()) for n in weights)
    assert den > 0 and math.sqrt(num / den) < 2e-2
