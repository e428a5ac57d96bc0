"""FLUX.1's QK-norm + RoPE kernel's wrapper (ops/qk_norm_rope.py) and the
model's choice of path (models/flux.py::roped_qk), on the CPU: CPU tensors
take the plain chain, which returns bit for bit what the blocks computed
before the kernel (the RMSNorm modules, the q/k concatenation, apply_rope,
the cast); the kernel is taken for a CUDA qkv without a gradient, one
launch a stream at its row offset of the joint q and k buffers, and refuses
what it does not take (another precision, streams that leave rows of the
joint sequence unwritten). The kernel itself runs only
on a card (tests/test_torch_flux_gpu.py)."""

import types
from unittest import mock

import pytest
import torch

from multimodal_diffusion_torch.infer.sample_flux import position_ids
from multimodal_diffusion_torch.models import flux
from multimodal_diffusion_torch.ops import cuda_kernels as ck
from multimodal_diffusion_torch.ops import qk_norm_rope as qr

# 2 heads of 128 (the kernel's head dim), RoPE axes as FLUX.1-dev's
CFG = flux.FluxConfig(hidden_size=256, num_heads=2, axes_dim=(16, 56, 56), depth=1,
                      depth_single_blocks=1)
TXT, GRID = 5, 3  # 5 text tokens and a 3 x 3 patch grid: N = 14


def _pe(txt=TXT, grid=GRID):
    img_ids, txt_ids = position_ids(txt, grid, grid, "cpu")
    return flux.rope_tables(torch.cat((txt_ids, img_ids)), CFG.axes_dim, CFG.theta)


def _norm(seed):
    g = torch.Generator().manual_seed(seed)
    norm = flux.QKNorm(128)
    with torch.no_grad():
        for p in norm.parameters():
            p.mul_(1.0 + 0.1 * torch.randn(128, generator=g))
    return norm


def _qkv(n, dtype, seed, width=3 * 256):
    g = torch.Generator().manual_seed(seed)
    qkv = (2.0 * torch.randn(1, n, width, generator=g)).to(dtype)
    qkv[0, 0, :256] = 0.0  # a zero row of q
    return qkv


def present_chain(streams, n_heads, pe):
    """The blocks' q and k as they stood before the kernel: each stream's
    split_heads and RMSNorm modules, the concatenation of the normed q and
    k (double blocks), apply_rope and the cast to v's dtype."""
    cos, sin = pe
    qs, ks, vs = [], [], []
    for qkv, norm in streams:
        q, k, v = flux.split_heads(qkv, n_heads)
        qs.append(norm.query_norm(q))
        ks.append(norm.key_norm(k))
        vs.append(v)
    q = qs[0] if len(qs) == 1 else torch.cat(qs, 2)
    k = ks[0] if len(ks) == 1 else torch.cat(ks, 2)
    v = vs[0] if len(vs) == 1 else torch.cat(vs, 2)
    return flux.apply_rope(q, cos, sin).to(v.dtype), flux.apply_rope(k, cos, sin).to(v.dtype)


def _streams(kind, dtype):
    if kind == "single":
        return [(_qkv(TXT + GRID * GRID, dtype, 1), _norm(2))]
    return [(_qkv(TXT, dtype, 3), _norm(4)), (_qkv(GRID * GRID, dtype, 5), _norm(6))]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("kind", ("single", "double"))
def test_cpu_tensors_take_the_present_chain(kind, dtype):
    streams, pe = _streams(kind, dtype), _pe()
    with mock.patch.object(flux, "qk_norm_rope", side_effect=AssertionError("kernel path")), \
            torch.inference_mode():
        q, k = flux.roped_qk(streams, 2, pe)
        want_q, want_k = present_chain(streams, 2, pe)
    assert q.shape == (1, 2, TXT + GRID * GRID, 128) and q.dtype == dtype
    assert torch.equal(q, want_q) and torch.equal(k, want_k)
    assert bool((q[0, :, 0] == 0).all())  # the zero row


def emulated_kernel(qkv, q_scale, k_scale, cos, sin, offset=0, out=None):
    """The wrapper's contract in plain PyTorch on the CPU: the stream's rows
    of the joint [B, H, N_total, 128] q and k buffers."""
    B, n, width = qkv.shape
    H, n_total = width // 384, cos.shape[0]
    if out is None:
        out = tuple(torch.full((B, H, n_total, 128), float("nan"), dtype=torch.bfloat16)
                    for _ in range(2))
    x = qkv.view(B, n, 3, H, 128).float()
    c, s = cos[offset:offset + n, None], sin[offset:offset + n, None]
    for i, w in enumerate((q_scale, k_scale)):
        xi = x[:, :, i]
        y = xi * torch.rsqrt(xi.pow(2).mean(-1, keepdim=True) + 1e-6) * w.float()
        y0, y1 = y[..., 0::2], y[..., 1::2]
        z = torch.stack([c * y0 - s * y1, s * y0 + c * y1], -1).flatten(-2)
        out[i][:, :, offset:offset + n] = z.transpose(1, 2).to(torch.bfloat16)
    return out


@pytest.mark.parametrize("kind", ("single", "double"))
def test_the_kernel_path_writes_each_stream_at_its_offset(kind):
    """With qkv taken for a CUDA tensor and the kernel emulated: one launch a
    stream, txt at row 0 and img at row L of one pair of joint [B, H, N, Dh]
    buffers, handed on as they are and equal to the plain chain's q and k."""
    streams, pe = _streams(kind, torch.bfloat16), _pe()
    want = present_chain(streams, 2, pe)
    calls = []

    def spy(*args):
        calls.append((args, emulated_kernel(*args)))
        return calls[-1][1]

    with mock.patch.object(flux, "qk_norm_rope", spy), \
            mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                              return_value=True), \
            torch.inference_mode():
        q, k = flux.roped_qk(streams, 2, pe)
    assert [args[5] for args, _ in calls] == ([0] if kind == "single" else [0, TXT])
    assert calls[0][0][6] is None and all(args[6] is calls[0][1] for args, _ in calls[1:])
    assert q.shape == (1, 2, TXT + GRID * GRID, 128) and q.is_contiguous()
    assert torch.equal(q, want[0]) and torch.equal(k, want[1])


@pytest.mark.parametrize("grad,qkv_grad,scale_grad,kernel", [
    (False, False, True, True),   # sampling under inference_mode
    (True, False, False, True),   # nothing to differentiate
    (True, False, True, False),   # the scales need a gradient
    (True, True, False, False),   # a gradient through qkv
])
def test_the_kernel_only_without_a_gradient(grad, qkv_grad, scale_grad, kernel):
    streams, pe = _streams("double", torch.bfloat16), _pe()
    for qkv, norm in streams:
        qkv.requires_grad_(qkv_grad)
        norm.requires_grad_(scale_grad)
    spy = mock.Mock(side_effect=emulated_kernel)
    with mock.patch.object(flux, "qk_norm_rope", spy), \
            mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                              return_value=True), \
            torch.set_grad_enabled(grad):
        q, _ = flux.roped_qk(streams, 2, pe)
    assert spy.called == kernel
    assert torch.equal(q, present_chain(streams, 2, pe)[0])


@pytest.mark.parametrize("dtype,scale_dtype,match", [
    (torch.float32, torch.float32, "qkv must be bf16"),
    (torch.float16, torch.bfloat16, "qkv must be bf16"),
    (torch.bfloat16, torch.float32, "q_scale must be bf16"),
])
def test_a_cuda_qkv_in_another_precision_raises(dtype, scale_dtype, match):
    """Without a gradient a CUDA qkv goes to the kernel whatever its dtype:
    a precision the kernel does not take raises there, before any launch,
    and is never sent quietly down the plain chain."""
    streams, pe = _streams("double", dtype), _pe()
    for _, norm in streams:
        norm.to(scale_dtype)
    with mock.patch.object(ck, "library", side_effect=AssertionError("launched")), \
            mock.patch.object(flux, "plain_roped_qk", side_effect=AssertionError("plain")), \
            mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                              return_value=True), \
            torch.inference_mode(), pytest.raises(ValueError, match=match):
        flux.roped_qk(streams, 2, pe)


def test_streams_short_of_the_tables_raise_on_the_kernel_path():
    """Streams that leave rows of the joint buffers unwritten (the tables
    hold more tokens than the streams) raise on the kernel path, as the plain
    chain raises on the broadcast."""
    streams, pe = _streams("double", torch.bfloat16), _pe(txt=TXT + 2)
    with mock.patch.object(flux, "qk_norm_rope", emulated_kernel), \
            mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                              return_value=True), \
            torch.inference_mode(), pytest.raises(ValueError, match="hold 14 tokens"):
        flux.roped_qk(streams, 2, pe)
    with torch.inference_mode(), pytest.raises(RuntimeError):
        flux.plain_roped_qk(streams, 2, pe)


def _wrapper_args(case):
    """qkv, q_scale, k_scale, cos, sin, offset, out of a single block at
    N = 14 (2 heads), with one thing the kernel does not take."""
    qkv = torch.zeros(1, 14, 3 * 256 + 1024, dtype=torch.bfloat16)[..., :768]
    qs, ks = torch.ones(128, dtype=torch.bfloat16), torch.ones(128, dtype=torch.bfloat16)
    cos, sin = torch.ones(14, 64), torch.zeros(14, 64)
    offset, out = 0, None
    if case == "head_dim_64":
        qs, ks = qs[:64], ks[:64]
    elif case == "width_not_3_heads_of_128":
        qkv = torch.zeros(1, 14, 3 * 192, dtype=torch.bfloat16)
    elif case == "fp32_qkv":
        qkv = torch.zeros(1, 14, 768)
    elif case == "fp16_scales":
        qs, ks = qs.half(), ks.half()
    elif case == "mixed_scales":
        ks = ks.float()
    elif case == "fp32_scales":
        qs, ks = qs.float(), ks.float()
    elif case == "bf16_tables":
        cos = cos.bfloat16()
    elif case == "strided_qkv":
        qkv = torch.zeros(1, 14, 1536, dtype=torch.bfloat16)[..., ::2]
    elif case == "misaligned_base":
        qkv = torch.zeros(1, 14, 776, dtype=torch.bfloat16)[..., 1:769]
    elif case == "row_stride_off_grid":
        qkv = torch.zeros(1, 14, 772, dtype=torch.bfloat16)[..., :768]  # rows 1544 bytes apart
    elif case == "offset_past_n_total":
        offset = 1
    elif case == "out_shape":
        out = (torch.empty(1, 14, 2, 128, dtype=torch.bfloat16),) * 2  # [B, N, H, Dh]
    elif case == "meta_tables":
        cos, sin = cos.to("meta"), sin.to("meta")
    return qkv, qs, ks, cos, sin, offset, out


@pytest.mark.parametrize("case,match", [
    ("head_dim_64", r"q_scale must be contiguous \[128\]"),
    ("width_not_3_heads_of_128", r"qkv must be \[B, n, 3 H 128\]"),
    ("fp32_qkv", "qkv must be bf16"),
    ("fp16_scales", "q_scale must be bf16"),
    ("mixed_scales", "k_scale must be bf16"),
    ("fp32_scales", "q_scale must be bf16"),
    ("bf16_tables", "cos must be contiguous fp32"),
    ("strided_qkv", "unit stride"),
    ("misaligned_base", "16-byte aligned"),
    ("row_stride_off_grid", "16-byte aligned"),
    ("offset_past_n_total", "not inside the tables' N_total = 14"),
    ("out_shape", "q_out must be contiguous bf16"),
    ("meta_tables", "every operand must be on qkv's"),
    ("cpu", "a CUDA kernel"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """Every refusal is a ValueError before any build or launch; a CPU qkv
    that passes the checks is refused too (its path is the plain chain)."""
    with mock.patch.object(ck, "library", side_effect=AssertionError("launched")):
        with pytest.raises(ValueError, match=match):
            qr.qk_norm_rope(*_wrapper_args(case))


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_a_double_blocks_two_streams_reach_the_launch_in_place():
    """txt [1, 512, 9216] and img [1, 4096, 9216] (FLUX.1-dev's double
    block) launch into one pair of [1, 24, 4608, 128] buffers at rows 0 and
    512; a single block's linear1 view [1, 4608, 21504][..., :9216] is read
    in place with its row stride; one count a launch."""
    launch = mock.Mock(return_value=0)
    lib = types.SimpleNamespace(qk_norm_rope=launch)
    cos, sin = _meta((4608, 64), torch.float32), _meta((4608, 64), torch.float32)
    w = _meta((128,))
    with mock.patch.object(ck, "library", return_value=lib), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=types.SimpleNamespace(cuda_stream=0)):
        before = ck.LAUNCHES["qk_norm_rope"]
        out = qr.qk_norm_rope(_meta((1, 512, 9216)), w, w, cos, sin)
        again = qr.qk_norm_rope(_meta((1, 4096, 9216)), w, w, cos, sin, 512, out)
        qr.qk_norm_rope(_meta((1, 4608, 21504))[..., :9216], w, w, cos, sin)
    assert again is out and all(t.shape == (1, 24, 4608, 128) for t in out)
    calls = [c.args for c in launch.call_args_list]
    # B, n, H, batch and row strides, offset, N_total
    assert calls[0][8:15] == (1, 512, 24, 512 * 9216, 9216, 0, 4608)
    assert calls[1][8:15] == (1, 4096, 24, 4096 * 9216, 9216, 512, 4608)
    assert calls[2][8:15] == (1, 4608, 24, 4608 * 21504, 21504, 0, 4608)
    assert ck.LAUNCHES["qk_norm_rope"] == before + 3


def test_the_kernel_source_holds_the_plain_chains_arithmetic():
    """Rounded products and sums in the plain chain's order, no fast-math,
    no atomics; the kernel's name leaves the MMDiT norm's metric (which
    matches `rms_norm`) alone; its C entry point is the one bound."""
    src = ck.SOURCES["qk_norm_rope"].read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for op in ("__fmul_rn", "__fadd_rn", "__fsub_rn", "rsqrtf", "1e-6f",
               "__floats2bfloat162_rn"):
        assert op in code, op
    for banned in ("__fdividef", "use_fast_math", "atomicAdd", "__fmaf", "rms_norm"):
        assert banned not in code, banned
    assert 'extern "C" int qk_norm_rope(' in code
