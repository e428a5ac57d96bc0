"""The port's schedule math and tokenizers against the JAX package, exactly
or at 1e-6 (fp32, the same operations in the same order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_diffusion_torch.ops import schedule as TS
from multimodal_diffusion_torch.ops import tokenize as TT
from multimodal_diffusion_tpu.ops import schedule as JS
from multimodal_diffusion_tpu.ops import tokenize as JT


@pytest.mark.parametrize("kind", ["cosine", "linear", "sigmoid"])
def test_beta_schedule_and_alpha_bar(kind):
    tb = TS.make_beta_schedule(1000, kind, 1e-4, 0.02)
    jb = JS.make_beta_schedule(1000, kind, 1e-4, 0.02)
    np.testing.assert_array_equal(tb, jb)
    for t, j in zip(TS.alphas_cumprod_from_betas(tb), JS.alphas_cumprod_from_betas(jb)):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("T,S", [(1000, 50), (1000, 60), (100, 4)])
def test_sampling_schedule(T, S):
    np.testing.assert_array_equal(TS.make_sampling_schedule(T, S),
                                  JS.make_sampling_schedule(T, S))


@pytest.mark.parametrize("dim", [64, 65, 512])
def test_timestep_embedding(dim):
    """atol 1e-4: XLA's and torch's fp32 exp differ in the last ulp, and a
    one-ulp change of a frequency moves an argument of up to 999 rad by up
    to 999 * 1.2e-7 = 1.2e-4 (measured: 3e-5 at dim 512)."""
    t = np.array([0, 1, 17, 500, 999], np.int32)
    np.testing.assert_allclose(
        TS.timestep_embedding(torch.from_numpy(t), dim).numpy(),
        np.asarray(JS.timestep_embedding(jnp.asarray(t), dim)), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("param", ["eps", "x0", "v"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_step(param, eta):
    _, abar = JS.alphas_cumprod_from_betas(JS.make_beta_schedule(1000, "cosine"))
    rng = np.random.default_rng(0)
    shape = (4, 8, 150)
    x, eps, noise = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    t_now = np.array([999, 579, 20, 0], np.int32)
    t_prev = np.array([979, 559, 0, -1], np.int32)  # includes the final step
    j = JS.ddim_step(jnp.asarray(x), jnp.asarray(t_now), jnp.asarray(t_prev),
                     jnp.asarray(eps), jnp.asarray(abar), eta=eta,
                     noise=jnp.asarray(noise), param=param)
    t = TS.ddim_step(torch.from_numpy(x), torch.from_numpy(t_now), torch.from_numpy(t_prev),
                     torch.from_numpy(eps), torch.from_numpy(abar), eta=eta,
                     noise=torch.from_numpy(noise), param=param)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,tube", [((2, 8, 12, 16, 16), (2, 4, 4)),
                                        ((1, 8, 2, 4, 4), (2, 1, 1))])
def test_tube_patch_roundtrip(shape, tube):
    z = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jt = np.asarray(JT.tube_patch_video(jnp.asarray(z), *tube))
    tt = TT.tube_patch_video(torch.from_numpy(z), *tube)
    np.testing.assert_array_equal(tt.numpy(), jt)
    back = TT.tube_unpatch_video(tt, *shape[1:], *tube)
    np.testing.assert_array_equal(back.numpy(), z)


def test_audio_fold_150_to_37_to_150():
    """150 frames fold to 37 tokens of 4; the unfold zero-pads the last 2."""
    z = np.random.default_rng(2).normal(size=(3, 8, 150)).astype(np.float32)
    jt = np.asarray(JT.audio_tokens_from_latent(jnp.asarray(z), 4, 4))
    tt = TT.audio_tokens_from_latent(torch.from_numpy(z), 4, 4)
    assert tt.shape == (3, 37, 32)
    np.testing.assert_array_equal(tt.numpy(), jt)
    jb = np.asarray(JT.audio_latent_from_tokens(jnp.asarray(jt), 8, 4, 150, 4))
    tb = TT.audio_latent_from_tokens(tt, 8, 4, 150, 4)
    np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(tb[..., :148].numpy(), z[..., :148])
    assert np.all(tb[..., 148:].numpy() == 0.0)


@pytest.mark.parametrize("length,stride", [(4, 2), (5, 3), (8, 8), (20, 4)])
def test_chunk_1d(length, stride):
    x = np.random.default_rng(3).normal(size=(2, 3, 17)).astype(np.float32)
    np.testing.assert_array_equal(
        TT.chunk_1d(torch.from_numpy(x), length, stride).numpy(),
        np.asarray(JT.chunk_1d(jnp.asarray(x), length, stride)))


@pytest.mark.parametrize("stride,hann", [(2, False), (2, True), (4, False)])
def test_overlap_add_1d(stride, hann):
    w = np.random.default_rng(4).normal(size=(2, 3, 9, 4)).astype(np.float32)
    np.testing.assert_allclose(
        TT.overlap_add_1d(torch.from_numpy(w), stride, apply_hann=hann).numpy(),
        np.asarray(JT.overlap_add_1d(jnp.asarray(w), stride, apply_hann=hann)),
        rtol=1e-6, atol=1e-6)
