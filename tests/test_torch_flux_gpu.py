"""FLUX.1's blocks on a CUDA card only (marker `gpu`; every test skips
without a card): a double-stream and a single-stream block at FLUX.1-dev's
widths through the flash forward kernel against the same block on the dense
attention path, and the RoPE'd q and k the kernel takes meet its alignment
rule. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_flux_gpu.py
"""

import math

import pytest
import torch

from multimodal_diffusion_torch.infer.sample_flux import position_ids
from multimodal_diffusion_torch.models import flux
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
