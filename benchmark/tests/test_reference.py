"""The plain reference against the program at a tiny size on the CPU, in
float32: the parameter layout, the schedule, and a whole v2a sampling call
through the program's entry point."""

import numpy as np
import pytest
import torch

from benchmark.drivers import sample as drv
from benchmark.reference import av_sampling as ref
from benchmark.tests.tiny import tiny
from benchmark.weights import make_weights

CONFIGS = ["spec8", "mvp-v2a"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CONFIGS)
def test_param_layout_is_the_programs(name):
    from multimodal_diffusion_torch.models.diffusion import AVDiffusionConfig, AVDiffusionModel

    for cfg in (tiny(name), tiny(name, "bf16")):
        with torch.device("meta"):
            model = AVDiffusionModel(AVDiffusionConfig.from_config(cfg))
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert ref.param_shapes(cfg) == want


@pytest.mark.parametrize("name", CONFIGS)
def test_schedule_is_the_programs(name):
    from multimodal_diffusion_torch.ops import schedule as S

    dc = tiny(name)["diffusion"]["audio"]
    betas = S.make_beta_schedule(1000, dc["schedule"], dc["min_beta"], dc["max_beta"])
    np.testing.assert_array_equal(ref.alpha_bar(dc), S.alphas_cumprod_from_betas(betas)[1])
    np.testing.assert_array_equal(ref.ddim_schedule(1000, 25), S.make_sampling_schedule(1000, 25))


@pytest.mark.parametrize("name", CONFIGS)
def test_v2a_sampling_matches_the_program(name):
    cfg = tiny(name)
    weights = make_weights(ref.param_shapes(cfg), 7, "cpu", torch.float32)
    model = drv.build_program(cfg, weights, torch.device("cpu"))
    passes = drv.checked_passes(cfg, 11)
    tap = drv.Tap(model, passes)
    inputs = drv.Inputs(cfg, {"batch": 2, "pool": 3}, 11)
    wav, kept = drv.call(model, inputs, 0, "cpu", tap)
    seen, z = kept
    numbers = drv.compare(weights, inputs, {0: (wav, kept)}, "cpu", passes)
    assert passes == (1, 2, 3) and sorted(seen) == [1, 2, 3]
    assert wav.shape == (2, ref.sizes(cfg)["L"]) and z.shape == (2, 8, 25)
    assert seen[1][1].shape == (2, 6, 32) and set(numbers) == {
        "eps_rel_err", "eps_later_rel_err", "latent_rel_err", "wav_rel_err"}
    # float32 on both sides: only the order of sums differs, which the eps
    # sampler's first step (1 / sqrt(alpha_bar) ~ 1e4 at t = 999) amplifies
    assert max(numbers.values()) < 1e-3, numbers


def test_the_checked_passes_are_drawn_from_the_seed():
    cfg = tiny("mvp-v2a", steps=60)
    mids = {drv.checked_passes(cfg, seed)[1] for seed in range(1000)}
    assert all(drv.checked_passes(cfg, seed)[::2] == (1, 60) for seed in range(20))
    assert min(mids) == 2 and max(mids) == 59
