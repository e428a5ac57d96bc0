"""The port's flash-attention forward against the JAX package: the plain
PyTorch version against the Pallas kernel in interpret mode (out and lse),
the dispatch function against the JAX one, and the wrapper's refusal to
fall back. The CUDA kernel itself is tested in test_torch_kernels_gpu.py."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_diffusion_torch.ops import attention as t_att
from multimodal_diffusion_torch.ops import flash_attention as t_fa
from multimodal_diffusion_tpu.ops import attention as j_att
from multimodal_diffusion_tpu.ops.flash_attention import _flash_forward

SHAPES = [(1, 2, 128, 64), (2, 2, 133, 64), (1, 1, 384, 32)]
MASKS = ["none", "keys", "row_all_masked"]


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype) for _ in range(3)]


def _key_padding(B, N, case, seed):
    """[B, N] bool, True = PAD."""
    if case == "none":
        return None
    rng = np.random.default_rng(seed + 100)
    kpad = rng.uniform(size=(B, N)) < 0.3
    kpad[:, 0] = False  # at least one valid key per row
    if case == "row_all_masked":
        kpad[0] = True
    return kpad


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_pallas_interpret(shape, mask):
    B, H, N, Dh = shape
    q, k, v = _qkv(shape, seed=N + Dh)
    kpad = _key_padding(B, N, mask, seed=N)
    j_out, j_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  None if kpad is None else jnp.asarray(kpad),
                                  interpret=True)
    valid = None if kpad is None else torch.from_numpy(~kpad)
    t_out, t_lse = t_fa.flash_forward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), valid)
    j_lse = np.asarray(j_lse)[:, :N, 0].reshape(B, H, N)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, rtol=2e-5, atol=2e-5)
    if mask == "row_all_masked":
        assert np.all(t_out[0].numpy() == 0.0)
        assert np.all(np.asarray(j_out)[0] == 0.0)


def test_reference_bf16_matches_pallas_interpret():
    shape = (2, 2, 133, 64)
    q, k, v = _qkv(shape, seed=7)
    kpad = _key_padding(2, 133, "keys", seed=7)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    j_out, j_lse = _flash_forward(*jb, jnp.asarray(kpad), interpret=True)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    t_out, t_lse = t_fa.flash_forward_reference(*tb, torch.from_numpy(~kpad))
    assert t_out.dtype == torch.bfloat16
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(t_lse.numpy(),
                               np.asarray(j_lse)[:, :133, 0].reshape(2, 2, 133),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("use_kernel", [None, False, True])
@pytest.mark.parametrize("mask", MASKS)
def test_multi_head_attention_matches_jax(mask, use_kernel):
    """use_kernel=True on CPU tensors runs the kernel's plain version; None
    and False run the dense path — all three agree with the JAX dispatch."""
    shape = (2, 4, 133, 32)
    q, k, v = _qkv(shape, seed=3)
    kpad = _key_padding(2, 133, mask, seed=3)
    j = j_att.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_padding_mask=None if kpad is None else jnp.asarray(kpad))
    t = t_att.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_padding_mask=None if kpad is None else torch.from_numpy(kpad),
        use_kernel=use_kernel)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5, atol=2e-5)
    if mask == "row_all_masked":
        assert np.all(t[0].numpy() == 0.0)


def test_cpu_tensors_never_touch_the_kernel():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 1, 16, 32), seed=0))
    with mock.patch.object(t_fa, "_library", side_effect=AssertionError("kernel path")):
        out, lse = t_fa.flash_forward(q, k, v)
    assert out.shape == q.shape and lse.shape == (1, 1, 16)


def test_wrapper_raises_for_a_cuda_tensor_without_a_kernel():
    """A CUDA tensor launches the kernel or raises: with no nvcc to build it,
    the wrapper raises and never runs the plain version."""
    q = torch.empty((1, 1, 16, 32), device="meta")
    reference = mock.Mock(side_effect=AssertionError("fell back to the plain path"))
    with mock.patch.object(t_fa, "_check_inputs"), \
            mock.patch.object(t_fa, "_nvcc", return_value=None), \
            mock.patch.object(t_fa, "flash_forward_reference", reference), \
            mock.patch.object(t_fa, "BUILD_DIR", t_fa.BUILD_DIR / "absent"):
        t_fa._library.cache_clear()
        try:
            with pytest.raises(RuntimeError, match="nvcc not found"):
                t_fa.flash_forward(q, q, q)
        finally:
            t_fa._library.cache_clear()
    reference.assert_not_called()


def test_wrapper_rejects_a_non_cuda_device():
    q = torch.empty((1, 1, 16, 32), device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        t_fa.flash_forward(q, q, q)
