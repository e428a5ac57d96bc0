"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card only (marker `gpu`; every test skips without a card). Imports no JAX,
so it runs where only the port is installed:

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
