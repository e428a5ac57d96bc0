"""The port's CUDA kernels (flash forward, flash backward dK/dV and dQ)
against their plain PyTorch versions, on a CUDA card only (marker `gpu`;
every test skips without a card). Imports no JAX, so it runs where only the
port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from multimodal_diffusion_torch.ops import attention as t_att
from multimodal_diffusion_torch.ops import flash_attention as t_fa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, shape, dtype, n_masked, seed=0):
    B, H, N, Dh = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(3))
    valid = None
    if n_masked:
        valid = torch.ones((B, N), dtype=torch.bool, device=dev)
        valid[0, N - n_masked:] = False
    return q, k, v, valid


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_masked", [((16, 8, 133, 64), 0),
                                            ((8, 8, 421, 128), 0),
                                            ((2, 4, 1152, 128), 51),
                                            ((2, 2, 77, 32), 77),
                                            ((3, 2, 1, 64), 0)])
def test_flash_fwd_matches_reference(cuda, shape, n_masked, dtype):
    """fp32: 1e-4 (summation order only); bf16 out: 2e-2 (one bf16 rounding
    of out, |out| < 4); lse is fp32 on both paths."""
    q, k, v, valid = _inputs(cuda, shape, dtype, n_masked)
    out, lse = t_fa.flash_forward(q, k, v, valid)
    ref_out, ref_lse = t_fa.flash_forward_reference(q, k, v, valid)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    if n_masked == shape[2]:
        assert bool((out[0] == 0).all())


@pytest.mark.gpu
def test_flash_fwd_takes_strided_heads(cuda):
    """q, k, v as the denoiser hands them over: head views of one fused qkv
    projection [B, N, 3, H, Dh], unit stride along Dh only."""
    B, N, H, Dh = 4, 133, 8, 64
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((B, N, 3, H, Dh), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out, _ = t_fa.flash_forward(q, k, v)
    ref, _ = t_fa.flash_forward_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_dispatch_sends_cuda_tensors_to_the_kernel(cuda):
    q, k, v, _ = _inputs(cuda, (2, 2, 40, 32), torch.bfloat16, 0)
    kpm = torch.zeros((2, 40), dtype=torch.bool, device=cuda)
    kpm[1, 30:] = True
    before = t_fa.flash_forward.launches
    out = t_att.multi_head_attention(q, k, v, key_padding_mask=kpm)
    assert t_fa.flash_forward.launches == before + 1
    dense = t_att.multi_head_attention(q, k, v, key_padding_mask=kpm, use_kernel=False)
    assert t_fa.flash_forward.launches == before + 1
    torch.testing.assert_close(out.float(), dense.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_flash_fwd_rejects_what_it_does_not_take(cuda):
    q, k, v, _ = _inputs(cuda, (1, 1, 16, 48), torch.float32, 0)
    with pytest.raises(ValueError, match="Dh=48"):
        t_fa.flash_forward(q, k, v)
    q, k, v, _ = _inputs(cuda, (1, 1, 16, 32), torch.float16, 0)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        t_fa.flash_forward(q, k, v)


# the chip_smoke backward cases: the mvp training shape, the sampling shape,
# the flagship, t2i with 51 masked keys, a fully masked batch row, and N = 1
BWD_CASES = [((8, 8, 133, 64), 0), ((16, 8, 133, 64), 0), ((8, 8, 421, 128), 0),
             ((2, 4, 1152, 128), 51), ((2, 2, 77, 32), 77), ((3, 2, 1, 64), 0)]
# max |kernel - plain| / max(1, max |plain|): fp32 sums in another order
# (1e-4); bf16 P and dS are rounded to bf16 on both paths, and a different
# fp32 sum order can flip one rounding by an ulp (2^-8), so 2e-2
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel_err(a, b):
    return float((a.float() - b.float()).abs().max()) / max(1.0, float(b.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_masked", BWD_CASES)
def test_flash_bwd_matches_reference(cuda, shape, n_masked, dtype):
    q, k, v, valid = _inputs(cuda, shape, dtype, n_masked, seed=2)
    out, lse = t_fa.flash_forward(q, k, v, valid)
    dout = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(3),
                       device=cuda).to(dtype)
    before = (t_fa.flash_backward.dkdv_launches, t_fa.flash_backward.dq_launches)
    grads = t_fa.flash_backward(q, k, v, out, lse, dout, valid)
    assert (t_fa.flash_backward.dkdv_launches, t_fa.flash_backward.dq_launches) == (
        before[0] + 1, before[1] + 1)
    refs = t_fa.flash_backward_reference(q, k, v, out, lse, dout, valid)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.shape == shape and g.dtype == dtype
        err = _rel_err(g, r)
        assert err <= BWD_TOL[dtype], f"{name}: {err}"
        if n_masked == shape[2]:
            assert bool((g[0] == 0).all()), f"{name} of the fully masked row is not 0"


@pytest.mark.gpu
def test_flash_bwd_takes_strided_operands(cuda):
    """q, k, v as head views of one fused qkv projection [B, N, 3, H, Dh] and
    dO as the out projection's backward hands it over: a [B, N, H, Dh]
    buffer seen as [B, H, N, Dh]."""
    B, N, H, Dh = 4, 133, 8, 64
    g = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn((B, N, 3, H, Dh), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    dout = torch.randn((B, N, H, Dh), generator=g, device=cuda).to(torch.bfloat16)
    dout = dout.transpose(1, 2)
    out, lse = t_fa.flash_forward(q, k, v)
    grads = t_fa.flash_backward(q, k, v, out, lse, dout)
    qc, kc, vc, dc = (t.contiguous() for t in (q, k, v, dout))
    refs = t_fa.flash_backward_reference(qc, kc, vc, out.contiguous(), lse, dc)
    for name, gr, r in zip(("dq", "dk", "dv"), grads, refs):
        assert _rel_err(gr, r) <= BWD_TOL[torch.bfloat16], name


def _bwd_grads_and_refs(q, k, v, dout, valid):
    out, lse = t_fa.flash_forward(q, k, v, valid)
    grads = t_fa.flash_backward(q, k, v, out, lse, dout, valid)
    refs = t_fa.flash_backward_reference(q, k, v, out, lse, dout, valid)
    torch.cuda.synchronize()
    return grads, refs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_masked", [0, 5])
@pytest.mark.parametrize("N", [15, 16, 17, 145])
def test_flash_bwd_at_the_16_row_edges(cuda, N, n_masked, dtype):
    """The tensor-core kernels work in 16-row pieces: one row short of a
    piece, a whole one, one row over, and one over nine (144 + 1)."""
    shape = (2, 2, N, 64)
    q, k, v, valid = _inputs(cuda, shape, dtype, n_masked, seed=6)
    dout = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(7),
                       device=cuda).to(dtype)
    grads, refs = _bwd_grads_and_refs(q, k, v, dout, valid)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert bool(torch.isfinite(g.float()).all()), name
        assert _rel_err(g, r) <= BWD_TOL[dtype], f"{name}: {_rel_err(g, r)}"


@pytest.mark.gpu
def test_flash_bwd_takes_the_train_step_strides(cuda):
    """The mvp train step's operands at full width: q, k, v as head views of
    the fused qkv projection [8, 133, 3, 8, 64], dO a [B, N, H, Dh] buffer."""
    B, N, H, Dh = 8, 133, 8, 64
    g = torch.Generator(device=cuda).manual_seed(8)
    qkv = torch.randn((B, N, 3, H, Dh), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    dout = torch.randn((B, N, H, Dh), generator=g, device=cuda).to(torch.bfloat16)
    dout = dout.transpose(1, 2)
    assert not t_fa.misaligned_operands(q=q, k=k, v=v, dout=dout)
    grads, refs = _bwd_grads_and_refs(q, k, v, dout, None)
    for name, gr, r in zip(("dq", "dk", "dv"), grads, refs):
        assert _rel_err(gr, r) <= BWD_TOL[torch.bfloat16], name


@pytest.mark.gpu
def test_flash_bwd_raises_on_a_misaligned_view(cuda):
    """bf16 operands off the 16-byte grid are refused, not sent down a slower
    path: here q starts 8 bytes into a row of a wider buffer."""
    shape = (2, 2, 40, 64)
    q, k, v, _ = _inputs(cuda, shape, torch.bfloat16, 0, seed=9)
    wide = torch.zeros((2, 2, 40, 72), dtype=torch.bfloat16, device=cuda)
    wide[..., 4:68] = q
    q_off = wide[..., 4:68]
    assert q_off.stride(-1) == 1 and q_off.data_ptr() % 16 == 8
    out, lse = t_fa.flash_forward(q, k, v)
    before = (t_fa.flash_backward.dkdv_launches, t_fa.flash_backward.dq_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        t_fa.flash_backward(q_off, k, v, out, lse, q)
    assert (t_fa.flash_backward.dkdv_launches, t_fa.flash_backward.dq_launches) == before
    # fp32 goes through the FMA kernels, which take any alignment of 4 bytes
    wide32 = torch.zeros((2, 2, 40, 65), dtype=torch.float32, device=cuda)
    wide32[..., 1:] = q.float()
    grads, refs = _bwd_grads_and_refs(wide32[..., 1:], k.float(), v.float(), q.float(), None)
    for gr, r in zip(grads, refs):
        assert _rel_err(gr, r) <= BWD_TOL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,n_masked", [((8, 8, 133, 64), 0), ((8, 8, 421, 128), 0),
                                            ((2, 4, 1152, 128), 51)])
def test_flash_bwd_is_bit_identical_from_call_to_call(cuda, shape, n_masked):
    """Each grad element has one owner block and a fixed order of summation."""
    q, k, v, valid = _inputs(cuda, shape, torch.bfloat16, n_masked, seed=10)
    dout = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(11),
                       device=cuda).to(torch.bfloat16)
    out, lse = t_fa.flash_forward(q, k, v, valid)
    first = [g.clone() for g in t_fa.flash_backward(q, k, v, out, lse, dout, valid)]
    second = t_fa.flash_backward(q, k, v, out, lse, dout, valid)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_flash_bwd_rejects_what_it_does_not_take(cuda):
    q, k, v, _ = _inputs(cuda, (1, 1, 16, 48), torch.float32, 0)
    lse = torch.zeros((1, 1, 16), device=cuda)
    with pytest.raises(ValueError, match="Dh=48"):
        t_fa.flash_backward(q, k, v, q, lse, q)
    q, k, v, _ = _inputs(cuda, (1, 1, 16, 32), torch.float32, 0)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        t_fa.flash_backward(q, k, v, q, lse, q.half())
    with pytest.raises(ValueError, match="lse must be"):
        t_fa.flash_backward(q, k, v, q, lse.double(), q)


@pytest.mark.gpu
def test_flash_attention_autograd_launches_each_kernel_once(cuda):
    """One forward and one backward of the differentiable op: one launch of
    each kernel, and grads that agree with autograd through dense
    attention."""
    q, k, v, _ = _inputs(cuda, (2, 4, 133, 64), torch.float32, 0, seed=5)
    kpm = torch.zeros((2, 133), dtype=torch.bool, device=cuda)
    kpm[1, 100:] = True
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counts = lambda: (t_fa.flash_forward.launches, t_fa.flash_backward.dkdv_launches,  # noqa: E731
                      t_fa.flash_backward.dq_launches)
    before = counts()
    out = t_att.multi_head_attention(q, k, v, key_padding_mask=kpm)
    dout = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert counts() == tuple(c + 1 for c in before)
    dense = t_att.multi_head_attention(q, k, v, key_padding_mask=kpm, use_kernel=False)
    refs = torch.autograd.grad(dense, (q, k, v), dout)
    assert counts() == tuple(c + 1 for c in before)
    for g, r in zip(grads, refs):
        assert _rel_err(g, r) <= 1e-4
