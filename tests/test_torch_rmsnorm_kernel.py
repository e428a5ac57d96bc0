"""The RMSNorm kernel (csrc/rms_norm.cu) against its plain PyTorch version
on a CUDA card only (marker `gpu`; every test skips without a card): at the
samplers' shapes and the configs' other widths, ragged row counts, all-zero
rows, the final norm's strided view, rows longer than the registers hold,
each input, weight and output dtype; within one ulp of a bf16 or fp16
output and two of an fp32 one (``_check``), bit-identical on repeats, and
replayed bit for bit from a captured CUDA graph. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_rmsnorm_kernel.py
"""

import pytest
import torch

from multimodal_diffusion_torch.models import mmdit as TM
from multimodal_diffusion_torch.ops import cuda_kernels as ck
from multimodal_diffusion_torch.ops import rms_norm as rn

EPS = 1e-6
# the bits that order each dtype's values: ulps apart = difference of these
_BITS = {torch.float32: (torch.int32, 0x7FFFFFFF), torch.bfloat16: (torch.int16, 0x7FFF),
         torch.float16: (torch.int16, 0x7FFF)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def ulps_apart(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in units in the last place of their dtype
    between two tensors of one float dtype (0 and -0 are 0 apart)."""
    int_dtype, mag = _BITS[a.dtype]

    def ordered(t):
        i = t.contiguous().view(int_dtype).long()
        return torch.where(i < 0, -(i & mag), i)

    return int((ordered(a) - ordered(b)).abs().max())


def _case(dev, shape, x_dtype=torch.bfloat16, w_dtype=torch.bfloat16, seed=0, zero_rows=()):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (2.0 * torch.randn(shape, generator=g, device=dev)).to(x_dtype)
    for b, n in zero_rows:
        x[b, n] = 0.0
    w = (1.0 + 0.05 * torch.randn(shape[-1], generator=g, device=dev)).to(w_dtype)
    return x, w


def _check(x, w, out_dtype):
    """Kernel against the plain version on the card. Only the order of the
    fp32 sum of squares differs, so the statistic s may differ by an fp32
    ulp: one ulp of a bf16 or fp16 output, two of an fp32 output (s's and
    the quotient's own rounding); and two calls give the same bits."""
    max_ulps = 2 if out_dtype == torch.float32 else 1
    got = rn.rms_norm(x, w, EPS, out_dtype)
    want = rn.rms_norm_reference(x, w, EPS, out_dtype)
    again = rn.rms_norm(x, w, EPS, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == x.shape and got.is_contiguous()
    assert ulps_apart(got, want) <= max_ulps
    assert torch.equal(got.view(_BITS[out_dtype][0]), again.view(_BITS[out_dtype][0]))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 421, 1024), (16, 133, 512)])
def test_the_samplers_shapes(cuda, shape):
    """The flagship's and mvp's CFG-doubled token batches, bf16 in and out
    with bf16 serving weights; CFG-dropped tokens are all-zero rows."""
    x, w = _case(cuda, shape, zero_rows=[(0, 0), (15, shape[1] - 1), (8, 7)])
    got = _check(x, w, torch.bfloat16)
    for b, n in [(0, 0), (15, shape[1] - 1), (8, 7)]:
        assert bool((got[b, n] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 64, 256, 384, 768, 2048, 2056, 4096, 8192])
def test_widths_and_a_ragged_row_count(cuda, d):
    """The configs' widths (256 t2i and the reference, 384 pixel, 768 the
    specificity configs), small ones, lanes with unequal numbers of vectors
    (384, 768, 2056), and rows past what the registers hold (2056 to 8192);
    3 x 37 = 111 rows, not a multiple of a block's 4."""
    x, w = _case(cuda, (3, 37, d), seed=d, zero_rows=[(1, 36)])
    got = _check(x, w, torch.bfloat16)
    assert bool((got[1, 36] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_input_and_weight_dtypes(cuda, x_dtype, w_dtype):
    """Each input dtype with fp32 and bf16 weights, the output in x's dtype
    and in each other."""
    x, w = _case(cuda, (4, 133, 512), x_dtype, w_dtype, seed=5, zero_rows=[(2, 3)])
    for out_dtype in (torch.bfloat16, torch.float16, torch.float32):
        got = _check(x, w, out_dtype)
        assert bool((got[2, 3] == 0).all())


@pytest.mark.gpu
def test_the_final_norms_strided_view(cuda):
    """x[:, :N] of the padded sequence, read in place: the same as the
    kernel on a contiguous copy, bit for bit."""
    padded, w = _case(cuda, (16, 424, 1024), seed=7)
    view = padded[:, :421]
    assert not view.is_contiguous()
    got = _check(view, w, torch.bfloat16)
    assert torch.equal(got, rn.rms_norm(view.contiguous(), w, EPS, torch.bfloat16))


@pytest.mark.gpu
def test_a_captured_graph_replays_the_kernel_and_the_counter_counts(cuda):
    x, w = _case(cuda, (16, 421, 1024), seed=9)
    want = rn.rms_norm(x, w, EPS, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rn.rms_norm(x, w, EPS, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ck.LAUNCHES["rms_norm"]
    with torch.cuda.graph(graph, capture_error_mode="global"):
        out = rn.rms_norm(x, w, EPS, torch.bfloat16)
    assert ck.LAUNCHES["rms_norm"] == before + 1
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.gpu
def test_the_module_takes_the_kernel_only_without_a_gradient(cuda):
    """Under inference mode one launch, the wrapper's output; with the
    weight needing a gradient the plain version, no launch, and the
    gradient through it."""
    norm = TM.RMSNorm(512, dtype=torch.bfloat16).to(cuda)
    x, _ = _case(cuda, (4, 133, 512), seed=11)
    before = ck.LAUNCHES["rms_norm"]
    with torch.inference_mode():
        got = norm(x)
    assert ck.LAUNCHES["rms_norm"] == before + 1
    assert torch.equal(got, rn.rms_norm(x, norm.weight, norm.eps, torch.bfloat16))
    out = norm(x)
    assert ck.LAUNCHES["rms_norm"] == before + 2
    assert torch.equal(out, rn.rms_norm_reference(x, norm.weight, norm.eps, torch.bfloat16))
    out.float().sum().backward()
    assert norm.weight.grad is not None and bool(torch.isfinite(norm.weight.grad).all())
