"""FLUX.1's blocks on a CUDA card only (marker `gpu`; every test skips
without a card): a double-stream and a single-stream block at FLUX.1-dev's
widths through the flash forward kernel against the same block on the dense
attention path, and the RoPE'd q and k the kernel takes meet its alignment
rule; the QK-norm + RoPE kernel (csrc/qk_norm_rope.cu) against the plain
chain at FLUX.1-dev's shapes, and its launches a transformer pass. Imports
no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_flux_gpu.py
"""

import math

import pytest
import torch

from multimodal_diffusion_torch.infer.sample_flux import position_ids
from multimodal_diffusion_torch.models import flux
from multimodal_diffusion_torch.ops import cuda_kernels as ck
from multimodal_diffusion_torch.ops.attention import attention_path
from multimodal_diffusion_torch.ops.cuda_kernels import misaligned_operands

WIDTHS = dict(hidden_size=3072, num_heads=24, axes_dim=(16, 56, 56), mlp_ratio=4.0)
TXT, GRID = 512, 32  # 512 text tokens and a 32 x 32 patch grid: N = 1536


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _block(kind, dev):
    c = flux.FluxConfig(depth=1, depth_single_blocks=1, **WIDTHS)
    with torch.device(dev):
        block = (flux.DoubleStreamBlock if kind == "double" else flux.SingleStreamBlock)(c)
    gen = torch.Generator(device=dev).manual_seed(3)
    flux.init_flux_weights(block, gen)
    for p in block.parameters():
        p.data = p.data.to(torch.bfloat16)
    return block.eval()


def _inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    img = torch.randn(1, GRID * GRID, 3072, generator=gen, device=dev)
    txt = torch.randn(1, TXT, 3072, generator=gen, device=dev)
    vec = torch.randn(1, 3072, generator=gen, device=dev)
    img_ids, txt_ids = position_ids(TXT, GRID, GRID, dev)
    pe = flux.rope_tables(torch.cat((txt_ids, img_ids)), WIDTHS["axes_dim"], 10_000.0)
    return img, txt, vec, pe


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["double", "single"])
def test_block_through_the_kernel_matches_dense(cuda, kind):
    """bf16 operands on both paths; the kernel and the dense path differ
    in their summation order and the kernel's bf16 P: 2e-2 of the update's
    size."""
    block = _block(kind, cuda)
    img, txt, vec, pe = _inputs(cuda)
    with torch.inference_mode():
        if kind == "double":
            got = torch.cat(block(img, txt, vec, pe), 1)
        else:
            got = block(torch.cat((txt, img), 1), vec, pe)
        with attention_path("dense"):
            if kind == "double":
                want = torch.cat(block(img, txt, vec, pe), 1)
            else:
                want = block(torch.cat((txt, img), 1), vec, pe)
    start = torch.cat((img, txt) if kind == "double" else (txt, img), 1)
    update = (want - start).norm()
    assert math.isfinite(float(update)) and float(update) > 0
    assert float((got - want).norm() / update) < 2e-2


@pytest.mark.gpu
def test_roped_qk_are_aligned_for_the_kernel(cuda, monkeypatch):
    seen = {}
    real = flux.multi_head_attention

    def spy(q, k, v):
        seen.update(q=q, k=k, v=v)
        return real(q, k, v)

    monkeypatch.setattr(flux, "multi_head_attention", spy)
    block = _block("single", cuda)
    img, txt, vec, pe = _inputs(cuda)
    with torch.inference_mode():
        block(torch.cat((txt, img), 1), vec, pe)
    assert seen["q"].dtype == torch.bfloat16 and seen["q"].stride(-1) == 1
    assert misaligned_operands(**seen) == []


def _flux_dev_streams(kind, dev):
    """bf16 qkv projections at FLUX.1-dev's widths (24 heads of 128) over
    512 text tokens and a 64 x 64 patch grid, N = 4608, with their QK-norms
    (scales 1 + N(0, 0.05), bf16 as served) and zero rows of q and k: a
    single block's first 3 d columns of linear1's output, read in place, or
    a double block's txt and img projections."""
    gen = torch.Generator(device=dev).manual_seed(5)

    def norm():
        qk = flux.QKNorm(128).to(dev)
        with torch.no_grad():
            for p in qk.parameters():
                p.copy_(1.0 + 0.05 * torch.randn(128, generator=gen, device=dev))
        return qk.to(torch.bfloat16)

    def proj(n, width):
        x = (2.0 * torch.randn(1, n, width, generator=gen, device=dev)).to(torch.bfloat16)
        x[0, 7, :3072] = 0.0  # token 7's q rows
        x[0, n - 1, 3072:6144] = 0.0  # the last token's k rows
        return x

    if kind == "single":
        return [(proj(4608, 3 * 3072 + 12288)[..., :3 * 3072], norm())]
    return [(proj(512, 3 * 3072), norm()), (proj(4096, 3 * 3072), norm())]


def _flux_dev_pe(dev):
    img_ids, txt_ids = position_ids(512, 64, 64, dev)
    return flux.rope_tables(torch.cat((txt_ids, img_ids)), WIDTHS["axes_dim"], 10_000.0)


def _pair_magnitude(streams, pe, which):
    """|y0| + |y1| of each element's pair, y the fp32 normed q or k of the
    plain chain: the size of the rotation's terms, [B, H, N, Dh]."""
    ys = []
    for qkv, norm in streams:
        t = flux.split_heads(qkv, 24)[which]
        ys.append((norm.query_norm if which == 0 else norm.key_norm)(t))
    y = torch.cat(ys, 2).unflatten(-1, (-1, 2)).abs()
    return y.sum(-1, keepdim=True).expand(y.shape).flatten(-2)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["single", "double"])
def test_qk_kernel_matches_the_plain_chain_at_flux_dev_shapes(cuda, kind):
    """The kernel against the plain chain (RMSNorm modules, apply_rope, the
    cast) on the card. Only the order of the sum of squares differs, so the
    rsqrt may differ by an fp32 ulp: each output within one bf16 ulp, plus
    2^-20 of its pair's magnitude, which shows only where the rotation
    cancels (a few fp32 ulps of its terms), and there on few elements; zero
    rows exactly zero; repeats bit-identical; one launch a stream."""
    streams, pe = _flux_dev_streams(kind, cuda), _flux_dev_pe(cuda)
    with torch.inference_mode():
        before = ck.LAUNCHES["qk_norm_rope"]
        got = flux.roped_qk(streams, 24, pe)
        assert ck.LAUNCHES["qk_norm_rope"] == before + len(streams)
        again = flux.roped_qk(streams, 24, pe)
        want = flux.plain_roped_qk(streams, 24, pe)
        for which in (0, 1):
            g, w = got[which].float(), want[which].float()
            assert got[which].shape == (1, 24, 4608, 128)
            assert got[which].dtype == torch.bfloat16
            assert torch.equal(got[which], again[which])
            mantissa, exponent = torch.frexp(torch.maximum(g.abs(), w.abs()))
            ulp = torch.where(mantissa == 0, 0.0, torch.ldexp(torch.ones_like(g), exponent - 8))
            err = (g - w).abs()
            assert bool((err <= ulp + 2.0 ** -20 * _pair_magnitude(streams, pe, which)).all())
            assert float((err > ulp).float().mean()) < 1e-4
        assert bool((got[0][0, :, 7] == 0).all()) and bool((got[1][0, :, 4607] == 0).all())
        assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())


@pytest.mark.gpu
def test_a_pass_launches_the_qk_kernel_once_a_stream(cuda):
    """A transformer at Dh 128 (2 heads, depth 2 + 3): 2 x depth +
    depth_single launches a pass without a gradient (76 at FLUX.1-dev's 19 +
    38), none with one, and the two velocities agree to bf16's resolution."""
    c = flux.FluxConfig(hidden_size=256, num_heads=2, axes_dim=(16, 56, 56), depth=2,
                        depth_single_blocks=3)
    with torch.device(cuda):
        model = flux.Flux(c)
    flux.init_flux_weights(model, torch.Generator(device=cuda).manual_seed(6))
    for p in model.parameters():
        p.data = p.data.to(torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(7)
    img_ids, txt_ids = position_ids(16, 8, 8, cuda)
    args = (torch.randn(1, 64, 64, generator=gen, device=cuda), img_ids,
            torch.randn(1, 16, 4096, generator=gen, device=cuda).to(torch.bfloat16), txt_ids,
            torch.full((1,), 0.6, device=cuda), torch.randn(1, 768, generator=gen, device=cuda),
            torch.full((1,), 3.5, device=cuda))
    before = ck.LAUNCHES["qk_norm_rope"]
    with torch.inference_mode():
        got = model(*args)
    assert ck.LAUNCHES["qk_norm_rope"] == before + 2 * 2 + 3
    want = model(*args)  # the parameters need a gradient: the plain chain
    assert ck.LAUNCHES["qk_norm_rope"] == before + 2 * 2 + 3
    assert want.requires_grad
    assert float((got - want.detach()).norm() / want.detach().norm()) < 1e-2
