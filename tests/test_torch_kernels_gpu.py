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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_masked", [0, 5])
@pytest.mark.parametrize("N", [15, 16, 17, 145])
def test_flash_fwd_at_the_16_row_edges(cuda, N, n_masked, dtype):
    """A warp of the tensor-core kernel owns 16 query rows and a product step
    takes 16 keys: one short of that, exactly that, one over, and one over
    nine (144 + 1, into a third 64-key stage)."""
    q, k, v, valid = _inputs(cuda, (2, 2, N, 64), dtype, n_masked, seed=12)
    out, lse = t_fa.flash_forward(q, k, v, valid)
    ref_out, ref_lse = t_fa.flash_forward_reference(q, k, v, valid)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_after_a_fully_masked_first_tile(cuda, dtype):
    """The first 64 keys masked, valid keys after them: the running max
    leaves the sentinel in the second stage, and exp(-1e30 - m) must read 0."""
    shape = (2, 2, 150, 64)
    q, k, v, _ = _inputs(cuda, shape, dtype, 0, seed=13)
    valid = torch.ones((2, 150), dtype=torch.bool, device=cuda)
    valid[0, :64] = False
    out, lse = t_fa.flash_forward(q, k, v, valid)
    ref_out, ref_lse = t_fa.flash_forward_reference(q, k, v, valid)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(lse).all())
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_flash_fwd_takes_the_sampler_strides(cuda):
    """The mvp sampler's operands at full width: q, k, v as head views of the
    fused qkv projection [16, 133, 3, 8, 64] (the CFG-doubled batch)."""
    B, N, H, Dh = 16, 133, 8, 64
    g = torch.Generator(device=cuda).manual_seed(14)
    qkv = torch.randn((B, N, 3, H, Dh), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not t_fa.misaligned_operands(q=q, k=k, v=v)
    out, lse = t_fa.flash_forward(q, k, v)
    assert out.transpose(1, 2).is_contiguous()  # a [B, N, H, Dh] buffer
    ref_out, ref_lse = t_fa.flash_forward_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_flash_fwd_raises_on_a_misaligned_view(cuda):
    """bf16 operands off the 16-byte grid are refused, not sent down a slower
    path; fp32 goes through the FMA kernel, which takes any alignment."""
    shape = (2, 2, 40, 64)
    q, k, v, _ = _inputs(cuda, shape, torch.bfloat16, 0, seed=15)
    wide = torch.zeros((2, 2, 40, 72), dtype=torch.bfloat16, device=cuda)
    wide[..., 4:68] = k
    k_off = wide[..., 4:68]
    assert k_off.stride(-1) == 1 and k_off.data_ptr() % 16 == 8
    before = t_fa.flash_forward.launches
    with pytest.raises(ValueError, match=r"flash_forward: \['k'\] not 16-byte aligned"):
        t_fa.flash_forward(q, k_off, v)
    assert t_fa.flash_forward.launches == before
    wide32 = torch.zeros((2, 2, 40, 65), dtype=torch.float32, device=cuda)
    wide32[..., 1:] = k.float()
    out, lse = t_fa.flash_forward(q.float(), wide32[..., 1:], v.float())
    ref_out, ref_lse = t_fa.flash_forward_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,n_masked", [((16, 8, 133, 64), 0), ((8, 8, 421, 128), 0),
                                            ((2, 4, 1152, 128), 51)])
def test_flash_fwd_is_bit_identical_from_call_to_call(cuda, shape, n_masked):
    """Each output row has one owner block and a fixed order of summation."""
    q, k, v, valid = _inputs(cuda, shape, torch.bfloat16, n_masked, seed=16)
    first = [t.clone() for t in t_fa.flash_forward(q, k, v, valid)]
    second = t_fa.flash_forward(q, k, v, valid)
    for name, a, b in zip(("out", "lse"), first, second):
        assert torch.equal(a, b), name


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


@pytest.mark.gpu
def test_flash_fwd_takes_the_flagship_sampler_strides(cuda):
    """The flagship sampler's operands at full width: head views of the fused
    qkv projection [16, 421, 3, 8, 128] (CFG-doubled batch; 96 video + 37
    audio + 288 mouth tokens), 16-byte aligned although N is odd."""
    B, N, H, Dh = 16, 421, 8, 128
    g = torch.Generator(device=cuda).manual_seed(15)
    qkv = torch.randn((B, N, 3, H, Dh), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not t_fa.misaligned_operands(q=q, k=k, v=v)
    out, lse = t_fa.flash_forward(q, k, v)
    assert out.transpose(1, 2).is_contiguous()
    ref_out, ref_lse = t_fa.flash_forward_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("outer", [torch.no_grad, torch.inference_mode])
def test_input_gradient_inside_a_gradless_sampler(cuda, outer):
    """What the sync-guided sampler does at each step: under an outer
    no_grad (or inference_mode), enable grad, send a fresh copy of the input
    through a qkv projection and flash_attention, and take autograd.grad
    w.r.t. that input only. Each kernel launches once, the gradient agrees
    with the kernels' plain versions (bf16: 2e-2 of its largest magnitude),
    and the weight gets no .grad."""
    B, N, H, Dh = 8, 421, 8, 128
    g = torch.Generator(device=cuda).manual_seed(16)
    w = (torch.randn((3 * H * Dh, 64), generator=g, device=cuda) * 0.2).requires_grad_()
    counts = lambda: (t_fa.flash_forward.launches, t_fa.flash_backward.dkdv_launches,  # noqa: E731
                      t_fa.flash_backward.dq_launches)

    def input_grad(x, attention):
        x = x.clone().requires_grad_(True)
        qkv = torch.nn.functional.linear(x.to(torch.bfloat16), w.to(torch.bfloat16))
        q, k, v = (t.transpose(1, 2) for t in qkv.reshape(B, N, 3, H, Dh).unbind(2))
        loss = attention(q, k, v).float().square().mean()
        (grad,) = torch.autograd.grad(loss, x)
        return grad

    def plain(q, k, v):
        with torch.no_grad():
            out, lse = t_fa.flash_forward_reference(q, k, v)
        return _PlainAttention.apply(q, k, v, out, lse)

    with outer():
        x = torch.randn((B, N, 64), generator=g, device=cuda)
        before = counts()
        with torch.inference_mode(False), torch.enable_grad():
            got = input_grad(x, t_fa.flash_attention)
            assert counts() == tuple(c + 1 for c in before)
            want = input_grad(x, plain)
            assert counts() == tuple(c + 1 for c in before)
    assert w.grad is None and bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= 2e-2


class _PlainAttention(torch.autograd.Function):
    """The kernels' plain versions as one differentiable op."""

    @staticmethod
    def forward(ctx, q, k, v, out, lse):
        ctx.save_for_backward(q, k, v, out, lse)
        return out.clone()

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = t_fa.flash_backward_reference(q, k, v, out, lse, dout.contiguous())
        return dq, dk, dv, None, None


@pytest.mark.gpu
@pytest.mark.parametrize("copy_delay", [0, 60_000_000], ids=["step_long", "copy_late"])
def test_device_prefetch_side_stream_copy(cuda, copy_delay):
    """Host batches go to the card on device_prefetch's side stream while a
    spin kernel holds the current stream: each consumed batch equals its host
    source. The host never waits for the card inside the loop, so every
    comparison is still queued behind the spins when the next batches are
    copied. copy_late holds each copy back behind a longer spin on the side
    stream: a consumer that did not wait for the copy's event would compare
    before the batch lands. step_long frees each batch while its comparison
    waits: a batch is one 32 MiB block (a segment of its own in the caching
    allocator), which a later copy would take and overwrite if the batch had
    not been marked as used on the consumer's stream."""
    import numpy as np

    from multimodal_diffusion_torch.datasets.loader import copy_to_device, device_prefetch

    rng = np.random.default_rng(0)
    hosts = [{"video": rng.integers(0, 256, (32, 1024, 1024), dtype=np.uint8),
              "has_video": np.ones(4, bool)} for _ in range(8)]
    refs = [{k: torch.from_numpy(v).to(cuda) for k, v in h.items()} for h in hosts]
    torch.cuda.synchronize()

    def put(h):
        if copy_delay:
            torch.cuda._sleep(copy_delay)  # on the side stream, before the copy
        return copy_to_device(h, cuda)

    copies = copy_to_device.batches
    mismatches = []
    for ref, b in zip(refs, device_prefetch(iter(hosts), put, depth=2, device=cuda)):
        assert b["video"].is_cuda and b["video"].dtype == torch.uint8
        assert b["has_video"].dtype == torch.bool
        torch.cuda._sleep(20_000_000 if copy_delay else 80_000_000)
        mismatches.append(sum((b[k] != ref[k]).sum() for k in ref))
        del b  # freed while the comparison still waits behind the spins
    assert len(mismatches) == len(hosts)
    assert int(torch.stack(mismatches).sum()) == 0
    assert copy_to_device.batches - copies == len(hosts)


@pytest.mark.gpu
@pytest.mark.parametrize("device_preprocess", [True, False])
def test_device_resident_upload_in_chunks(cuda, tmp_path, device_preprocess):
    """40 flagship-sized clips (94 MB of uint8 video: two 64 MB staging
    chunks) uploaded to the card hold what the CPU corpus holds, and the
    gathered batches are the CPU path's, each on the card."""
    import numpy as np

    from multimodal_diffusion_torch.datasets import records as TR
    from multimodal_diffusion_torch.datasets.loader import copy_to_device

    rng = np.random.default_rng(3)
    TR.write_record_shards(
        ({"video": rng.integers(0, 256, (48, 128, 128, 3), dtype=np.uint8),
          "audio": None if i == 5 else rng.standard_normal(48000).astype(np.float32)}
         for i in range(40)), tmp_path, video_shape=(48, 128, 128, 3), audio_shape=(48000,),
        clips_per_shard=16)
    ds = TR.RecordDataset(tmp_path, device_preprocess=device_preprocess)
    on_card = TR.device_resident_batches(ds, cuda, 8, seed=2, max_clips=36)
    up = TR.device_resident_batches.last_upload
    on_cpu = TR.device_resident_batches(ds, "cpu", 8, seed=2, max_clips=36)
    assert up["clips"] == 36
    copies = copy_to_device.batches
    for _ in range(10):
        a, b = next(on_card), next(on_cpu)
        assert a["video"].is_cuda
        assert a["video"].dtype == (torch.uint8 if device_preprocess else torch.float32)
        for k in b:
            assert torch.equal(a[k].cpu(), b[k]), k
    assert copy_to_device.batches == copies
