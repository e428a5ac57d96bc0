"""The whole v2a slice, port against JAX on the same weights and inputs:
VideoVAE encode -> DDIM+CFG sampling (4 steps, batched cond+null) ->
AudioCodec decode, at the shrunk mvp config in fp32, as bench.py's pipeline
runs it. Then the port's entry point in both directions on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_model_and_params, shrunk_cfg, t2n, torch_model
from multimodal_diffusion_torch.infer.ddim import sampler_from_config as t_sampler
from multimodal_diffusion_torch.infer.sample_clip import sample_one_direction
from multimodal_diffusion_tpu.infer.ddim import sampler_from_config as j_sampler


@pytest.fixture(scope="module")
def models():
    cfg = shrunk_cfg(sampler_steps=4)
    jm, params = jax_model_and_params(cfg, seed=3)
    return cfg, jm, params, torch_model(cfg, params)


def _assert_latents_close(t_z, j_z):
    """Latents agree to 1e-4 of their magnitude: four fp32 denoiser passes
    with guidance 3 (and, under eps with random weights, a first step that
    divides by sqrt(alpha_bar[999]) = 4.9e-5, so the latent reaches ~1e5)."""
    np.testing.assert_allclose(t_z, j_z, rtol=0, atol=1e-4 * max(1.0, np.abs(j_z).max()))


@pytest.mark.parametrize("param,cfg_rescale", [("x0", 0.0), ("x0", 0.7), ("eps", 0.0)])
def test_v2a_pipeline_matches_jax(models, param, cfg_rescale):
    """encode_video -> sampler -> decode_audio on the same weights, inputs and
    z_init. Waveforms agree within atol 1e-4 where the latent stays bounded
    (the x0 parameterization); under eps the ~1e5 latent saturates the
    decoder's tanh, so only its latent is compared."""
    cfg, jm, params, tm = models
    cfg = {**cfg, "sampling": {**cfg["sampling"], "cfg_rescale": cfg_rescale},
           "diffusion": {**cfg["diffusion"],
                         "audio": {**cfg["diffusion"]["audio"], "param": param}}}
    rng = np.random.default_rng(0)
    B = 2
    video = rng.uniform(0, 1, (B, 3, 8, 32, 32)).astype(np.float32)
    z_init = rng.normal(size=(B, 8, 50)).astype(np.float32)

    var = {"params": params}
    j_sample, j_sched = j_sampler(jm, cfg, target="audio")
    z_prompt = jm.apply(var, jnp.asarray(video), method=jm.encode_video)
    j_z = j_sample(params, z_prompt, jnp.asarray(z_init))
    j_wav = np.asarray(jm.apply(var, j_z, method=jm.decode_audio))

    t_sample, t_sched = t_sampler(cfg, target="audio")
    np.testing.assert_array_equal(t_sched, j_sched)
    with torch.inference_mode():
        t_prompt = tm.encode_video(torch.from_numpy(video))
        t_z = t_sample(tm, t_prompt, torch.from_numpy(z_init))
        t_wav = t2n(tm.decode_audio(t_z))

    assert t_wav.shape == (B, 1, 8000)
    _assert_latents_close(t2n(t_z), np.asarray(j_z))
    if param == "x0":
        np.testing.assert_allclose(t_wav, j_wav, rtol=1e-4, atol=1e-4)


def test_a2v_sampler_matches_jax(models):
    cfg, jm, params, tm = models
    rng = np.random.default_rng(1)
    z_prompt = rng.normal(size=(2, 8, 50)).astype(np.float32)
    z_init = rng.normal(size=(2, 8, 2, 4, 4)).astype(np.float32)
    j_sample, _ = j_sampler(jm, cfg, target="video")
    j_z = np.asarray(j_sample(params, jnp.asarray(z_prompt), jnp.asarray(z_init)))
    t_sample, _ = t_sampler(cfg, target="video")
    t_z = t2n(t_sample(tm, torch.from_numpy(z_prompt), torch.from_numpy(z_init)))
    _assert_latents_close(t_z, j_z)


def test_sample_one_direction_v2a_on_cpu(models):
    cfg, _, _, tm = models
    frames = np.random.default_rng(2).integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8)
    out = sample_one_direction(cfg=cfg, model=tm, prompt_modality="video",
                               prompt_video=frames, device="cpu")
    assert out["sr"] == 8000
    assert out["audio"].shape == (2, 8000)
    assert np.all(np.isfinite(out["audio"])) and np.all(np.abs(out["audio"]) <= 1.0)
    single = sample_one_direction(cfg=cfg, model=tm, prompt_modality="video",
                                  prompt_video=frames[0], device="cpu")
    assert single["audio"].shape == (8000,)


def test_sample_one_direction_a2v_on_cpu(models):
    cfg, _, _, tm = models
    wav = np.random.default_rng(3).uniform(-1, 1, 8000).astype(np.float32)
    out = sample_one_direction(cfg=cfg, model=tm, prompt_modality="audio",
                               prompt_audio=wav, device="cpu")
    assert out["fps"] == 8
    assert out["video"].shape == (8, 32, 32, 3) and out["video"].dtype == np.uint8
