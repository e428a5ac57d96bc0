"""The port's CUDA kernels (flash forward, its warp-specialised design at
long N, flash backward dK/dV and dQ)
against their plain PyTorch versions, and the int8 W8A8 product
(torch._int_mm) against its CPU path, on a CUDA card only (marker `gpu`;
every test skips without a card). Imports no JAX, so it runs where only the
port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from multimodal_diffusion_torch.ops import attention as t_att
from multimodal_diffusion_torch.ops import cuda_kernels as ck
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
    assert not ck.misaligned_operands(q=q, k=k, v=v)
    out, lse = t_fa.flash_forward(q, k, v)
    assert out.transpose(1, 2).is_contiguous()  # a [B, N, H, Dh] buffer
    ref_out, ref_lse = t_fa.flash_forward_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0.0,
                               atol=2e-2 * float(ref_out.float().abs().max()))
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
    before = ck.LAUNCHES["flash_fwd"]
    with pytest.raises(ValueError, match=r"flash_forward: \['k'\] not 16-byte aligned"):
        t_fa.flash_forward(q, k_off, v)
    assert ck.LAUNCHES["flash_fwd"] == before
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


# The warp-specialised forward (flash_fwd_ws_kernel: 192 query rows a block,
# 128 keys a stage): N at the threshold, one over it, a ragged N (2000 = 10 x
# 192 + 80 rows, 15 x 128 + 80 keys) and CogVideoX's 17 776, at B * H = 4
WS_N = [t_fa.WS_MIN_KEYS, t_fa.WS_MIN_KEYS + 1, 2000, 17776]


def _ws_valid(dev, N, mask):
    """[2, N] bool, True = attendable: none, ~30 % of keys at random, the
    first 128-key stage of batch row 0, or every key of batch row 0."""
    if mask == "none":
        return None
    if mask == "keys":
        g = torch.Generator(device=dev).manual_seed(N)
        return torch.rand((2, N), generator=g, device=dev) > 0.3
    valid = torch.ones((2, N), dtype=torch.bool, device=dev)
    valid[0, :128 if mask == "first_stage" else N] = False
    return valid


@pytest.mark.gpu
@pytest.mark.parametrize("mask", ["none", "keys", "first_stage", "row_all"])
@pytest.mark.parametrize("N", WS_N)
def test_ws_forward_matches_reference_and_todays_kernel(cuda, N, mask):
    """flash_forward picks the warp-specialised kernel: one launch, counted
    under both keys; out within 2e-2 of max |plain out| of the plain version
    (a few bf16 roundings of out at its largest; a typical |out| at N =
    17 776 is about 0.012, so an absolute 2e-2 would pass a P V left out)
    and within twice that of today's kernel on the same operands, lse within
    1e-4 of both; bit-identical repeats; a batch row whose keys are all
    masked gives exact zeros and lse -1e30."""
    q, k, v, _ = _inputs(cuda, (2, 2, N, 64), torch.bfloat16, 0, seed=17)
    valid = _ws_valid(cuda, N, mask)
    assert t_fa.forward_kernel(q.dtype, 64, N) == "flash_fwd_ws"
    before = (ck.LAUNCHES["flash_fwd"], ck.LAUNCHES["flash_fwd_ws"])
    out, lse = t_fa.flash_forward(q, k, v, valid)
    assert (ck.LAUNCHES["flash_fwd"], ck.LAUNCHES["flash_fwd_ws"]) == (before[0] + 1,
                                                                      before[1] + 1)
    again = t_fa.flash_forward(q, k, v, valid)
    today = t_fa.launch_forward_kernel("flash_fwd", q, k, v, valid)
    ref_out, ref_lse = t_fa.flash_forward_reference(q, k, v, valid)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["flash_fwd_ws"] == before[1] + 2
    out_tol = 2e-2 * float(ref_out.float().abs().max())
    for (want, want_lse), atol in (((ref_out, ref_lse), out_tol), (today, 2 * out_tol)):
        torch.testing.assert_close(out.float(), want.float(), rtol=0.0, atol=atol)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    if mask == "row_all":
        assert bool((out[0] == 0).all()) and bool((lse[0] == -1e30).all())


@pytest.mark.gpu
def test_ws_forward_takes_the_cogvideox_strides(cuda):
    """CogVideoX's operands: q and k [B, H, N, Dh] after the QK norm and
    RoPE, v a head view of the to_v projection [B, N, H * Dh]; out is a view
    of a [B, N, H, Dh] buffer. TMA reads and the epilogue writes them with
    their strides, and no copy is made."""
    B, N, H, Dh = 2, 2000, 4, 64
    g = torch.Generator(device=cuda).manual_seed(18)
    q, k = (torch.randn((B, H, N, Dh), generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn((B, N, H * Dh), generator=g, device=cuda).to(torch.bfloat16)
    v = v.view(B, N, H, Dh).transpose(1, 2)
    assert not v.is_contiguous()
    before = ck.LAUNCHES["flash_fwd_ws"]
    out, lse = t_fa.flash_forward(q, k, v)
    assert ck.LAUNCHES["flash_fwd_ws"] == before + 1
    assert out.transpose(1, 2).is_contiguous()
    ref_out, ref_lse = t_fa.flash_forward_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0.0,
                               atol=2e-2 * float(ref_out.float().abs().max()))
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_ws_forward_is_not_taken_below_its_shapes(cuda):
    """Below WS_MIN_KEYS, at another head dim and in fp32 the forward stays
    on today's kernels: LAUNCHES["flash_fwd_ws"] does not move."""
    before = (ck.LAUNCHES["flash_fwd"], ck.LAUNCHES["flash_fwd_ws"])
    for shape, dtype in (((2, 2, t_fa.WS_MIN_KEYS - 1, 64), torch.bfloat16),
                         ((1, 2, 2000, 128), torch.bfloat16), ((1, 2, 2000, 64), torch.float32)):
        q, k, v, _ = _inputs(cuda, shape, dtype, 0, seed=19)
        t_fa.flash_forward(q, k, v)
    assert (ck.LAUNCHES["flash_fwd"], ck.LAUNCHES["flash_fwd_ws"]) == (before[0] + 3, before[1])


@pytest.mark.gpu
def test_dispatch_sends_cuda_tensors_to_the_kernel(cuda):
    q, k, v, _ = _inputs(cuda, (2, 2, 40, 32), torch.bfloat16, 0)
    kpm = torch.zeros((2, 40), dtype=torch.bool, device=cuda)
    kpm[1, 30:] = True
    before = ck.LAUNCHES["flash_fwd"]
    out = t_att.multi_head_attention(q, k, v, key_padding_mask=kpm)
    assert ck.LAUNCHES["flash_fwd"] == before + 1
    with t_att.attention_path("dense"):
        dense = t_att.multi_head_attention(q, k, v, key_padding_mask=kpm)
    assert ck.LAUNCHES["flash_fwd"] == before + 1
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
    before = (ck.LAUNCHES["flash_bwd_dkdv"], ck.LAUNCHES["flash_bwd_dq"])
    grads = t_fa.flash_backward(q, k, v, out, lse, dout, valid)
    assert (ck.LAUNCHES["flash_bwd_dkdv"], ck.LAUNCHES["flash_bwd_dq"]) == (
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
    assert not ck.misaligned_operands(q=q, k=k, v=v, dout=dout)
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
    before = (ck.LAUNCHES["flash_bwd_dkdv"], ck.LAUNCHES["flash_bwd_dq"])
    with pytest.raises(ValueError, match="16-byte aligned"):
        t_fa.flash_backward(q_off, k, v, out, lse, q)
    assert (ck.LAUNCHES["flash_bwd_dkdv"], ck.LAUNCHES["flash_bwd_dq"]) == before
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
    counts = lambda: (ck.LAUNCHES["flash_fwd"], ck.LAUNCHES["flash_bwd_dkdv"],  # noqa: E731
                      ck.LAUNCHES["flash_bwd_dq"])
    before = counts()
    out = t_att.multi_head_attention(q, k, v, key_padding_mask=kpm)
    dout = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert counts() == tuple(c + 1 for c in before)
    with t_att.attention_path("dense"):
        dense = t_att.multi_head_attention(q, k, v, key_padding_mask=kpm)
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
    assert not ck.misaligned_operands(q=q, k=k, v=v)
    out, lse = t_fa.flash_forward(q, k, v)
    assert out.transpose(1, 2).is_contiguous()
    ref_out, ref_lse = t_fa.flash_forward_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0.0,
                               atol=2e-2 * float(ref_out.float().abs().max()))
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
    counts = lambda: (ck.LAUNCHES["flash_fwd"], ck.LAUNCHES["flash_bwd_dkdv"],  # noqa: E731
                      ck.LAUNCHES["flash_bwd_dq"])

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


def _text_family_valid(dev, B, n_text, n_target, n_tail, seed):
    """[B, n_text + n_target + n_tail] key validity of the text families'
    denoiser: each row's prompt length of BOS + bytes + EOS (2 to n_text),
    pads after it, every target token valid, the seq_multiple tail masked."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(2, n_text + 1, (B,), generator=g)
    text = torch.arange(n_text)[None, :] < lengths[:, None]
    rest = torch.cat([torch.ones((B, n_target), dtype=torch.bool),
                      torch.zeros((B, n_tail), dtype=torch.bool)], dim=1)
    return torch.cat([text, rest], dim=1).to(dev).contiguous()


# (shape, text keys, target keys, masked tail): the t2i-512 sampler's core
# (77 + 1024, padded to 1152) and its train step's, the t2a core (77 + 320),
# the text encoder
TEXT_FAMILY_CASES = [((16, 4, 1152, 128), 77, 1024, 51), ((32, 4, 1152, 128), 77, 1024, 51),
                     ((16, 6, 397, 64), 77, 320, 0), ((16, 4, 77, 64), 77, 0, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", TEXT_FAMILY_CASES, ids=lambda c: "x".join(map(str, c[0])))
def test_flash_kernels_at_the_text_family_shapes(cuda, case):
    """bf16, the forward and the backward pair under the text families' masks
    against their plain versions (the tolerances above)."""
    shape, n_text, n_target, n_tail = case
    q, k, v, _ = _inputs(cuda, shape, torch.bfloat16, 0, seed=30)
    valid = _text_family_valid(cuda, shape[0], n_text, n_target, n_tail, seed=31)
    out, lse = t_fa.flash_forward(q, k, v, valid)
    ref_out, ref_lse = t_fa.flash_forward_reference(q, k, v, valid)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    dout = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(32),
                       device=cuda).to(torch.bfloat16)
    grads = t_fa.flash_backward(q, k, v, out, lse, dout, valid)
    refs = t_fa.flash_backward_reference(q, k, v, out, lse, dout, valid)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert _rel_err(g, r) <= BWD_TOL[torch.bfloat16], name


@pytest.mark.gpu
def test_text_families_denoise_through_the_kernel(cuda):
    """A narrow Text2ImageModel (heads of 32) on the card: denoise with the
    kernel launches it once per core layer and agrees with dense attention
    (bf16, 1.5e-2 of the magnitude); the text encoder launches it per layer."""
    from multimodal_diffusion_torch.models.diffusion import init_weights
    from multimodal_diffusion_torch.models.latent_text2image import (Text2ImageConfig,
                                                                     Text2ImageModel)
    from multimodal_diffusion_torch.models.mmdit import MMDiTConfig
    from multimodal_diffusion_torch.models.text_encoder import (TextEncoderConfig,
                                                                tokenize_text)
    from multimodal_diffusion_torch.models.vae_image2d import ImageVAEConfig

    dt = torch.bfloat16
    c = Text2ImageConfig(
        image_size=64, patch=2, width=64, dtype=dt,
        vae=ImageVAEConfig(lat_ch=4, down=8, base=16, max_ch=32, dtype=dt),
        text=TextEncoderConfig(width=64, max_len=77, dtype=dt,
                               core=MMDiTConfig(d_model=64, n_layers=2, n_heads=2,
                                                dropout=0.0, dtype=dt)),
        core=MMDiTConfig(d_model=64, n_layers=3, n_heads=2, dropout=0.0, seq_multiple=128,
                         dtype=dt))
    model = Text2ImageModel(c)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    ids = torch.from_numpy(tokenize_text(["a red fox", ""], 77)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    z = torch.randn((2, 4, 8, 8), generator=g, device=cuda)
    t = torch.tensor([10, 900], device=cuda)
    with torch.inference_mode():
        before = ck.LAUNCHES["flash_fwd"]
        text, _ = model.encode_text(ids)
        assert ck.LAUNCHES["flash_fwd"] - before == 2
        pad = ids == 256
        with t_att.attention_path("kernel"):
            a = model.denoise(z, t, text, pad)
        assert ck.LAUNCHES["flash_fwd"] - before == 5
        with t_att.attention_path("dense"):
            b = model.denoise(z, t, text, pad)
    assert a.shape == (2, 4, 8, 8)
    assert float((a.float() - b.float()).abs().max()) <= 1.5e-2 * float(b.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(6736, 1024, 3072), (421, 4096, 1024), (5, 512, 512),
                                   (17, 64, 8)])
def test_int8_linear_on_the_card_equals_its_cpu_path(cuda, M, K, N):
    """Integers, scales, the int32 product and the bf16 output bit-equal to
    the CPU path on the same bf16 input (5 rows: padded to 17 inside)."""
    from multimodal_diffusion_torch.ops import quant as Q

    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(N, K, generator=g, device=cuda) / K ** 0.5).to(torch.bfloat16)
    b = torch.randn(N, generator=g, device=cuda).to(torch.bfloat16)
    a8, s_a = Q.quantize_rowwise(x)
    qw = Q.quantize_weight(w, torch.bfloat16)
    y32 = Q.int8_matmul(a8, qw[0])
    y = Q.int8_linear(x, w, b, torch.bfloat16, qw)
    torch.cuda.synchronize()
    rows = slice(0, min(M, 256))
    ca8, cs_a = Q.quantize_rowwise(x[rows].cpu())
    cqw = Q.quantize_weight(w.cpu(), torch.bfloat16)
    assert y32.dtype == torch.int32 and y32.shape == (M, N)
    assert torch.equal(a8[rows].cpu(), ca8) and torch.equal(s_a[rows].cpu(), cs_a)
    assert torch.equal(qw[0].cpu(), cqw[0]) and torch.equal(qw[1].cpu(), cqw[1])
    assert torch.equal(y32[rows].cpu(), Q.int8_matmul(ca8, cqw[0]))
    assert torch.equal(y[rows].cpu(),
                       Q.int8_linear(x[rows].cpu(), w.cpu(), b.cpu(), torch.bfloat16, cqw))


@pytest.mark.gpu
def test_int8_product_refuses_what_int_mm_cannot_take(cuda):
    from multimodal_diffusion_torch.ops import quant as Q

    a8 = torch.ones(32, 12, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        Q.int8_matmul(a8, torch.ones(16, 12, dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="N=20"):
        Q.int8_matmul(torch.ones(32, 16, dtype=torch.int8, device=cuda),
                      torch.ones(20, 16, dtype=torch.int8, device=cuda))


@pytest.mark.gpu
def test_int8_core_on_the_card_and_its_guided_gradient(cuda):
    """An int8 MMDiT in eval mode on the card: close to its CPU run (the
    flash kernel vs the CPU's dense attention) and to the unquantized core;
    a gradient w.r.t. the input flows through the activation scales only,
    with the quantized weights cached under inference mode."""
    from multimodal_diffusion_torch.models import mmdit as M

    cfg = M.MMDiTConfig(d_model=256, n_layers=2, n_heads=2, mlp_ratio=4.0, dropout=0.0,
                        dtype=torch.bfloat16, quant="int8")
    torch.manual_seed(0)
    core = M.MMDiT(cfg)
    for p in core.parameters():
        torch.nn.init.normal_(p, 0.0, 0.05)
    core.eval()
    x = torch.randn(4, 133, 256)
    with torch.inference_mode():
        ref = core(x).float()
    core.to(cuda)
    with torch.inference_mode():
        got = core(x.to(cuda)).float().cpu()
    assert float((got - ref).norm() / ref.norm()) < 2e-2
    xg = x.to(cuda).requires_grad_(True)
    (g,) = torch.autograd.grad(core(xg).float().square().sum(), xg)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    assert all(p.grad is None for p in core.parameters())


# the pixel DDPM family at configs/pixel32.yaml width (6 heads of 64, N = 64
# = one 64-row tile): the sampler's forward at B = 16, the train step's
# forward and backward pair at B = 128; unmasked, bf16
PIXEL_CASES = [((16, 6, 64, 64), False), ((128, 6, 64, 64), True)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,backward", PIXEL_CASES, ids=lambda c: str(c))
def test_flash_kernels_at_the_pixel_shapes(cuda, shape, backward):
    """bf16, the forward (and at the train step's shape the backward pair)
    against their plain versions, and bit-identical from call to call."""
    q, k, v, _ = _inputs(cuda, shape, torch.bfloat16, 0, seed=40)
    out, lse = t_fa.flash_forward(q, k, v)
    ref_out, ref_lse = t_fa.flash_forward_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0.0,
                               atol=2e-2 * float(ref_out.float().abs().max()))
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    assert torch.equal(out, t_fa.flash_forward(q, k, v)[0])
    if backward:
        dout = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(41),
                           device=cuda).to(torch.bfloat16)
        grads = t_fa.flash_backward(q, k, v, out, lse, dout)
        refs = t_fa.flash_backward_reference(q, k, v, out, lse, dout)
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            assert _rel_err(g, r) <= BWD_TOL[torch.bfloat16], name
        again = t_fa.flash_backward(q, k, v, out, lse, dout)
        assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
def test_pixel_dit_and_remat_through_the_kernels(cuda):
    """A narrow bf16 PixelDiT (2 layers, 6 heads of 64) on the card: a
    forward with the kernel launches it once a layer and agrees with dense
    attention within 1.5e-2 of the magnitude; a training pass under remat
    (a narrow MMDiT with dropout 0.1) launches the forward twice a layer and
    gives the bits of the pass without it."""
    from multimodal_diffusion_torch.models.diffusion import init_weights
    from multimodal_diffusion_torch.models.image_diffusion import PixelDiT, PixelDiTConfig
    from multimodal_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig, set_dropout_generator

    dt = torch.bfloat16
    core = MMDiTConfig(d_model=384, n_layers=2, n_heads=6, dropout=0.0, dtype=dt)
    model = PixelDiT(PixelDiTConfig(width=384, core=core, dtype=dt))
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    x = torch.randn((4, 3, 32, 32), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    t = torch.tensor([0, 10, 500, 999], device=cuda)
    with torch.inference_mode():
        before = ck.LAUNCHES["flash_fwd"]
        with t_att.attention_path("kernel"):
            a = model(x, t)
        assert ck.LAUNCHES["flash_fwd"] - before == 2
        with t_att.attention_path("dense"):
            b = model(x, t)
    assert float((a.float() - b.float()).abs().max()) <= 1.5e-2 * float(b.float().abs().max())

    grads, launches = {}, {}
    for remat in (False, True):
        net = MMDiT(MMDiTConfig(d_model=256, n_layers=3, n_heads=4, dropout=0.1, dtype=dt,
                                remat=remat))
        init_weights(net, torch.Generator().manual_seed(2))
        net = net.to(cuda).train()
        gen = torch.Generator(device=cuda).manual_seed(3)
        set_dropout_generator(net, gen)
        h = torch.randn((4, 64, 256), generator=torch.Generator(device=cuda).manual_seed(4),
                        device=cuda)
        before = ck.LAUNCHES["flash_fwd"]
        loss = net(h).float().square().mean()
        g = torch.autograd.grad(loss, list(net.parameters()))
        launches[remat] = ck.LAUNCHES["flash_fwd"] - before
        grads[remat] = (g, gen.get_state())
    assert (launches[False], launches[True]) == (3, 6)
    assert all(torch.equal(p, q) for p, q in zip(grads[True][0], grads[False][0]))
    assert torch.equal(grads[True][1], grads[False][1])
