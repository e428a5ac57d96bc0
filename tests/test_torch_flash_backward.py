"""The port's flash-attention backward against the JAX package: the plain
PyTorch version of the two backward kernels against the Pallas kernels in
interpret mode (the JAX package's own CPU route), and the differentiable
``flash_attention`` against autograd through dense attention. The CUDA
kernels themselves are tested in test_torch_kernels_gpu.py."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_diffusion_torch.ops import attention as t_att
from multimodal_diffusion_torch.ops import flash_attention as t_fa
from multimodal_diffusion_tpu.ops.flash_attention import _flash_backward, _flash_forward

# N = 133 is the mvp token count (not a multiple of the 128 tile); Dh 32 and 64
SHAPES = [(2, 2, 133, 64), (1, 2, 133, 32), (1, 1, 128, 64)]
# around the 16-row pieces of the tensor-core kernels' tiles: one row short of
# a piece, a whole one, one over, and one over nine
EDGE_N = [15, 16, 17, 145]
MASKS = ["none", "keys", "row_all_masked"]


def _arrays(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _key_padding(B, N, case, seed):
    """[B, N] bool, True = PAD."""
    if case == "none":
        return None
    rng = np.random.default_rng(seed + 100)
    kpad = rng.uniform(size=(B, N)) < 0.3
    kpad[:, 0] = False
    if case == "row_all_masked":
        kpad[0] = True
    return kpad


def _jax_fwd_bwd(q, k, v, g, kpad, dtype):
    """The JAX forward then backward, Pallas kernels in interpret mode;
    returns (out, lse [B, H, N], (dq, dk, dv)) as numpy fp32."""
    B, H, N, _ = q.shape
    jq, jk, jv, jg = (jnp.asarray(x, dtype) for x in (q, k, v, g))
    jm = None if kpad is None else jnp.asarray(kpad)
    out, lse = _flash_forward(jq, jk, jv, jm, interpret=True)
    grads = _flash_backward(jq, jk, jv, out, lse, jg, jm, interpret=True)
    lse_bhn = np.array(lse)[:, :N, 0].reshape(B, H, N)
    return (np.array(out, np.float32), lse_bhn,
            tuple(np.asarray(x, np.float32) for x in grads))


def _torch_bwd(q, k, v, g, kpad, out, lse, dtype):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v, g)]
    valid = None if kpad is None else torch.from_numpy(~kpad)
    return t_fa.flash_backward(t[0], t[1], t[2], torch.from_numpy(out).to(dtype),
                               torch.from_numpy(lse), t[3], valid)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_pallas_interpret_fp32(shape, mask):
    """fp32: 2e-5 (the same products, summed in another order)."""
    B, H, N, Dh = shape
    q, k, v, g = _arrays(shape, seed=N + Dh)
    kpad = _key_padding(B, N, mask, seed=N)
    out, lse, j_grads = _jax_fwd_bwd(q, k, v, g, kpad, jnp.float32)
    t_grads = _torch_bwd(q, k, v, g, kpad, out, lse, torch.float32)
    for name, t, j in zip(("dq", "dk", "dv"), t_grads, j_grads):
        np.testing.assert_allclose(t.numpy(), j, rtol=2e-5, atol=2e-5, err_msg=name)
        if mask == "row_all_masked":
            assert np.all(t[0].numpy() == 0.0) and np.all(j[0] == 0.0), name


@pytest.mark.parametrize("mask", ["none", "keys"])
@pytest.mark.parametrize("N", EDGE_N)
def test_reference_matches_pallas_interpret_fp32_at_the_16_row_edges(N, mask):
    """fp32: 2e-5, as the cases above."""
    shape = (1, 2, N, 64)
    q, k, v, g = _arrays(shape, seed=N)
    kpad = _key_padding(1, N, mask, seed=N)
    out, lse, j_grads = _jax_fwd_bwd(q, k, v, g, kpad, jnp.float32)
    t_grads = _torch_bwd(q, k, v, g, kpad, out, lse, torch.float32)
    for name, t, j in zip(("dq", "dk", "dv"), t_grads, j_grads):
        np.testing.assert_allclose(t.numpy(), j, rtol=2e-5, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("mask", ["none", "row_all_masked"])
def test_reference_matches_pallas_interpret_bf16(mask):
    """bf16 inputs and grads: 2e-2 of max(1, |grad|). Both round P to bf16
    before dV and dS before dK/dQ; a different fp32 sum order can move one
    of those roundings by an ulp (2^-8), and the grads are rounded to bf16."""
    shape = (2, 2, 133, 64)
    q, k, v, g = _arrays(shape, seed=11)
    kpad = _key_padding(2, 133, mask, seed=11)
    out, lse, j_grads = _jax_fwd_bwd(q, k, v, g, kpad, jnp.bfloat16)
    t_grads = _torch_bwd(q, k, v, g, kpad, out, lse, torch.bfloat16)
    for name, t, j in zip(("dq", "dk", "dv"), t_grads, j_grads):
        assert t.dtype == torch.bfloat16
        tol = 2e-2 * max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(t.float().numpy(), j, rtol=0, atol=tol, err_msg=name)


def test_reference_takes_a_given_delta():
    """delta (rowsum(dO * O)) handed in is used as given and never
    recomputed: a ring attention passes a global one."""
    shape = (1, 2, 133, 32)
    q, k, v, g = (torch.from_numpy(x) for x in _arrays(shape, seed=5))
    out, lse = t_fa.flash_forward_reference(q, k, v)
    delta = (g * out).sum(-1)
    base = t_fa.flash_backward(q, k, v, out, lse, g)
    given = t_fa.flash_backward(q, k, v, out, lse, g, delta=delta)
    shifted = t_fa.flash_backward(q, k, v, out, lse, g, delta=delta + 1.0)
    for a, b, c in zip(base, given, shifted):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(base[0], shifted[0])


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("Dh", [32, 64])
def test_flash_attention_grads_match_dense_autograd(Dh, mask):
    """The autograd.Function on CPU tensors (the kernels' plain versions,
    forward and backward) against autograd through dense attention, fp32:
    2e-5. A fully masked row has zero grads on both paths."""
    shape = (2, 2, 133, Dh)
    q, k, v, g = (torch.from_numpy(x) for x in _arrays(shape, seed=Dh))
    kpad = _key_padding(2, 133, mask, seed=Dh)
    kpm = None if kpad is None else torch.from_numpy(kpad)
    grads = {}
    for use_kernel in (True, False):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = t_att.multi_head_attention(*leaves, key_padding_mask=kpm, use_kernel=use_kernel)
        grads[use_kernel] = torch.autograd.grad(out, leaves, g)
    for name, a, b in zip(("dq", "dk", "dv"), grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5, msg=name)
        if mask == "row_all_masked":
            assert bool((a[0] == 0).all()) and bool((b[0] == 0).all()), name


def test_flash_attention_without_autograd_saves_nothing():
    """Sampling (no grad) is one flash_forward call; the output carries no
    graph."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _arrays((1, 1, 16, 32), 0, 3))
    with torch.no_grad():
        out = t_fa.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert t_fa.flash_attention(q, k, v).grad_fn is not None


def test_backward_wrapper_raises_for_a_cuda_tensor_without_a_kernel():
    """No fallback: with no nvcc to build the kernels, a tensor that is not
    on the CPU makes the wrapper raise; it never runs the plain version."""
    q = torch.empty((1, 1, 16, 32), device="meta")
    lse = torch.empty((1, 1, 16), device="meta")
    reference = mock.Mock(side_effect=AssertionError("fell back to the plain path"))
    with mock.patch.object(t_fa, "_check_inputs"), \
            mock.patch.object(t_fa, "_nvcc", return_value=None), \
            mock.patch.object(t_fa, "flash_backward_reference", reference), \
            mock.patch.object(t_fa, "BUILD_DIR", t_fa.BUILD_DIR / "absent"):
        t_fa._library.cache_clear()
        try:
            with pytest.raises(RuntimeError, match="nvcc not found"):
                t_fa.flash_backward(q, q, q, q, lse, q)
        finally:
            t_fa._library.cache_clear()
    reference.assert_not_called()


def test_backward_wrapper_rejects_a_non_cuda_device():
    q = torch.empty((1, 1, 16, 32), device="meta")
    lse = torch.empty((1, 1, 16), device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        t_fa.flash_backward(q, q, q, q, lse, q)


def _fused_qkv_views(B, N, H, Dh, dtype):
    qkv = torch.zeros((B, N, 3, H, Dh), dtype=dtype)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


def test_alignment_check_takes_the_train_step_operands():
    """q, k, v as head views of the fused qkv projection and dO as a
    [B, N, H, Dh] buffer seen as [B, H, N, Dh]: 16-byte aligned at every
    head dim the kernels take."""
    for Dh in t_fa.SUPPORTED_HEAD_DIMS:
        q, k, v = _fused_qkv_views(2, 133, 8, Dh, torch.bfloat16)
        dout = torch.zeros((2, 133, 8, Dh), dtype=torch.bfloat16).transpose(1, 2)
        assert t_fa.misaligned_operands(q=q, k=k, v=v, dout=dout) == []


def test_alignment_check_names_the_misaligned_operands():
    """A base address 8 bytes into a row, and a row stride of 33 elements,
    are named; a dim of length 1 may have any stride."""
    wide = torch.zeros((2, 2, 40, 72), dtype=torch.bfloat16)
    ok = wide[..., :64]
    off_base = wide[..., 4:68]
    assert off_base.data_ptr() % 16 == 8
    odd_rows = torch.zeros((2, 2, 40, 33), dtype=torch.bfloat16)[..., :32]
    assert t_fa.misaligned_operands(q=ok, k=off_base, v=odd_rows, dout=ok) == ["k", "v"]
    one_row = torch.zeros((2, 2, 1, 33), dtype=torch.bfloat16)[..., :32]
    assert one_row.stride(2) == 33
    assert t_fa.misaligned_operands(q=one_row[:1, :1]) == []
    # fp32 steps in units of 4 elements
    assert t_fa.misaligned_operands(q=torch.zeros((1, 2, 8, 34))[..., :32]) == ["q"]


def test_require_aligned_raises_and_names_the_operand():
    """No slow path behind the check: the wrapper's guard raises."""
    q = torch.zeros((1, 2, 16, 40), dtype=torch.bfloat16)[..., 4:36]
    ok = torch.zeros((1, 2, 16, 32), dtype=torch.bfloat16)
    t_fa.require_aligned("flash_backward", q=ok, dout=ok)
    with pytest.raises(ValueError, match=r"flash_backward: \['dout'\] not 16-byte aligned"):
        t_fa.require_aligned("flash_backward", q=ok, dout=q)


def test_build_tag_follows_the_source_and_its_headers(tmp_path):
    """The library is keyed by the .cu file and every header beside it: a
    change to a header alone gives a new tag, a change to another .cu file or
    no change at all does not."""
    src = tmp_path / "kernel.cu"
    other = tmp_path / "other.cu"
    header = tmp_path / "common.cuh"
    src.write_text('#include "common.cuh"\n__global__ void k() {}\n')
    other.write_text("__global__ void o() {}\n")
    header.write_text("#define TILE 64\n")
    tag = t_fa.source_tag(src)
    assert t_fa.source_tag(src) == tag
    other.write_text("__global__ void o2() {}\n")
    assert t_fa.source_tag(src) == tag
    header.write_text("#define TILE 32\n")
    tag_header = t_fa.source_tag(src)
    assert tag_header != tag
    src.write_text('#include "common.cuh"\n__global__ void k2() {}\n')
    assert t_fa.source_tag(src) not in (tag, tag_header)
    (tmp_path / "new.h").write_text("// a new header\n")
    assert t_fa.source_tag(src) not in (tag, tag_header)


def test_every_kernel_source_is_keyed_with_the_shared_header():
    """The real sources: csrc/flash_common.cuh is part of both tags."""
    header = t_fa.SOURCES["flash_bwd"].parent / "flash_common.cuh"
    assert header.exists()
    assert '#include "flash_common.cuh"' in t_fa.SOURCES["flash_bwd"].read_text()
