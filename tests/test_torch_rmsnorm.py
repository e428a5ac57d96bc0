"""The RMSNorm wrapper (ops/rms_norm.py) and the module's choice of path
(models/mmdit.py::RMSNorm), on the CPU: CPU tensors take the plain version,
which is the module's formula bit for bit and the JAX module's within the
standing tolerance; the kernel is taken only where no gradient is needed,
so training keeps its gradients bit for bit; any other tensor is checked
and launches or raises, never the plain version. The kernel itself runs only
on a card (tests/test_torch_rmsnorm_kernel.py)."""

import collections
import types
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_diffusion_torch.models import graphed
from multimodal_diffusion_torch.models import mmdit as TM
from multimodal_diffusion_torch.ops import cuda_kernels as ck
from multimodal_diffusion_torch.ops import rms_norm as rn
from multimodal_diffusion_tpu.models import mmdit as JM

DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def present_formula(x, weight, eps, dtype):
    """The module's forward as it stood before the kernel, written out."""
    xf = x.float()
    norm = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-12)
    return (weight.float() * xf / (norm + eps)).to(dtype)


def _inputs(shape, x_dtype, w_dtype, seed=0, requires_grad=False):
    g = torch.Generator().manual_seed(seed)
    x = (3.0 * torch.randn(shape, generator=g)).to(x_dtype)
    x[0, 1] = 0.0  # a CFG-dropped token
    w = (1.0 + 0.1 * torch.randn(shape[-1], generator=g)).to(w_dtype)
    return x.requires_grad_(requires_grad), w.requires_grad_(requires_grad)


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("w_dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("x_dtype", DTYPES)
def test_cpu_tensors_take_the_plain_version(x_dtype, w_dtype, out_dtype):
    x, w = _inputs((2, 5, 64), x_dtype, w_dtype)
    with mock.patch.object(ck, "library", side_effect=AssertionError("kernel path")):
        got = rn.rms_norm(x, w, 1e-6, out_dtype)
    want = present_formula(x, w, 1e-6, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)
    assert torch.equal(rn.rms_norm_reference(x, w, 1e-6, out_dtype), want)
    assert bool((got[0, 1] == 0).all())


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_plain_version_matches_the_jax_module(dtype):
    """fp32: 1e-5 (the standing tolerance of fp32 modules); bf16 out: one
    bf16 rounding of the same fp32 values."""
    x, _ = _inputs((2, 7, 256), torch.float32, torch.float32, seed=1)
    x[1] = 0.0
    scale = np.random.default_rng(1).normal(1.0, 0.02, 256).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = JM.RMSNorm(dtype=jdtype).apply({"params": {"scale": jnp.asarray(scale)}},
                                          jnp.asarray(x.numpy()))
    tn = TM.RMSNorm(256, dtype=dtype)
    with torch.no_grad():
        tn.weight.copy_(torch.from_numpy(scale))
        got = tn(x)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    assert bool((got[1] == 0).all())


@pytest.mark.parametrize("grad,x_grad,w_grad,kernel", [
    (False, False, True, True),   # sampling under no_grad / inference_mode
    (True, False, False, True),   # nothing to differentiate
    (True, False, True, False),   # training: the weight needs a gradient
    (True, True, False, False),   # a gradient through x (sync guidance)
])
def test_module_takes_the_kernel_only_without_a_gradient(grad, x_grad, w_grad, kernel):
    """With x taken for a CUDA tensor: the kernel's wrapper is called exactly
    when no gradient is needed, and the plain version otherwise."""
    norm = TM.RMSNorm(64, dtype=torch.bfloat16)
    norm.weight.requires_grad_(w_grad)
    x, _ = _inputs((2, 5, 64), torch.bfloat16, torch.float32, requires_grad=x_grad)
    spy = mock.Mock(side_effect=rn.rms_norm_reference)
    with mock.patch.object(TM, "rms_norm", spy), \
            mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                              return_value=True), \
            torch.set_grad_enabled(grad):
        out = norm(x)
    assert spy.called == kernel
    if kernel:
        spy.assert_called_once_with(x, norm.weight, norm.eps, torch.bfloat16)
    assert torch.equal(out, present_formula(x, norm.weight, norm.eps, torch.bfloat16))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_training_gradients_are_the_present_formulas(dtype):
    """A training pass takes the plain version: the output and the gradients
    of x and of the weight equal the present formula's bit for bit, finite
    on an all-zero row."""
    norm = TM.RMSNorm(64, dtype=dtype)
    with torch.no_grad():
        norm.weight.mul_(1.0 + 0.1 * torch.randn(64, generator=torch.Generator().manual_seed(2)))
    x, _ = _inputs((2, 5, 64), dtype, torch.float32, seed=2, requires_grad=True)
    dout = torch.randn((2, 5, 64), generator=torch.Generator().manual_seed(3)).to(dtype)
    out = norm(x)
    gx, gw = torch.autograd.grad(out, (x, norm.weight), dout)
    w = norm.weight.detach().clone().requires_grad_(True)
    want = present_formula(x, w, norm.eps, dtype)
    wx, ww = torch.autograd.grad(want, (x, w), dout)
    assert torch.equal(out, want) and torch.equal(gx, wx) and torch.equal(gw, ww)
    assert bool(torch.isfinite(gx).all())


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,match", [
    ("rank2", r"x must be \[B, N, d\]"),
    ("d_not_multiple_of_8", "not a positive multiple of 8"),
    ("int_x", "fp32, bf16 or fp16"),
    ("int_out", "fp32, bf16 or fp16"),
    ("fp16_weight", "weight must be fp32 or bf16"),
    ("weight_shape", r"weight must be contiguous \[64\]"),
    ("weight_strided", r"weight must be contiguous \[64\]"),
    ("strided_d", "unit stride along d"),
    ("row_stride_off_grid", "16-byte aligned"),
])
def test_wrapper_checks_what_the_kernel_takes(case, match):
    """Off the CPU (here the meta device, whose tensors have addresses 0)
    the wrapper checks, then launches: it never runs the plain version."""
    x, w, out = _meta((2, 5, 64)), _meta((64,), torch.float32), torch.bfloat16
    if case == "rank2":
        x = _meta((5, 64))
    elif case == "d_not_multiple_of_8":
        x, w = _meta((2, 5, 60)), _meta((60,), torch.float32)
    elif case == "int_x":
        x = _meta((2, 5, 64), torch.int32)
    elif case == "int_out":
        out = torch.int8
    elif case == "fp16_weight":
        w = _meta((64,), torch.float16)
    elif case == "weight_shape":
        w = _meta((32,), torch.float32)
    elif case == "weight_strided":
        w = _meta((128,), torch.float32)[::2]
    elif case == "strided_d":
        x = _meta((2, 5, 128))[..., ::2]
    elif case == "row_stride_off_grid":
        x = _meta((2, 5, 68))[..., :64]  # rows 136 bytes apart
    reference = mock.Mock(side_effect=AssertionError("fell back to the plain version"))
    with mock.patch.object(rn, "rms_norm_reference", reference), \
            mock.patch.object(ck, "library", side_effect=AssertionError("launched")):
        with pytest.raises(ValueError, match=match):
            rn.rms_norm(x, w, 1e-6, out)


def test_the_final_norms_strided_view_is_taken_in_place():
    """x[:, :N] of a padded [B, N_pad, d] (the core's final norm) passes the
    checks and reaches the launch with its own strides and dtype codes."""
    launch = mock.Mock(return_value=0)
    lib = types.SimpleNamespace(rms_norm=launch)
    w = _meta((1024,), torch.bfloat16)
    with mock.patch.object(ck, "library", return_value=lib), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=types.SimpleNamespace(cuda_stream=0)):
        before = ck.LAUNCHES["rms_norm"]
        out = rn.rms_norm(_meta((16, 424, 1024))[:, :421], w, 1e-6, torch.bfloat16)
        rn.rms_norm(_meta((2, 421, 1024), torch.float32), w, 1e-6, torch.float16)
    assert out.shape == (16, 421, 1024) and out.is_contiguous()
    args = launch.call_args_list[0].args
    assert args[4:9] == (16, 421, 1024, 424 * 1024, 1024)
    assert args[9:12] == (1, 1, 1)  # bf16 x, weight and out
    assert launch.call_args_list[1].args[4:9] == (2, 421, 1024, 421 * 1024, 1024)
    assert launch.call_args_list[1].args[9:12] == (0, 1, 2)  # fp32 x, bf16 weight, fp16 out
    assert ck.LAUNCHES["rms_norm"] == before + 2


def test_wrapper_raises_for_a_device_tensor_without_a_kernel():
    """No nvcc to build the kernel: the wrapper raises, and never runs the
    plain version."""
    reference = mock.Mock(side_effect=AssertionError("fell back to the plain version"))
    with mock.patch.object(ck, "_nvcc", return_value=None), \
            mock.patch.object(ck, "BUILD_DIR", ck.BUILD_DIR / "absent"), \
            mock.patch.object(rn, "rms_norm_reference", reference):
        ck.library.cache_clear()
        try:
            with pytest.raises(RuntimeError, match="nvcc not found: the CUDA kernel rms_norm.cu"):
                rn.rms_norm(_meta((2, 5, 64)), _meta((64,)), 1e-6, torch.bfloat16)
        finally:
            ck.library.cache_clear()


def test_build_is_keyed_by_the_kernels_source(tmp_path):
    """An existing library of the source's content is used as it is; the key
    changes with the source."""
    source = ck.SOURCES["rms_norm"]
    lib = tmp_path / f"librms_norm_{ck.source_tag(source)}.so"
    lib.write_bytes(b"")
    with mock.patch.object(ck, "BUILD_DIR", tmp_path), \
            mock.patch.object(ck, "_nvcc", side_effect=AssertionError("rebuilt")):
        assert ck.build("rms_norm") == lib
    copy = tmp_path / "src" / "rms_norm.cu"
    copy.parent.mkdir()
    copy.write_text(source.read_text())
    tag = ck.source_tag(copy)
    copy.write_text(copy.read_text() + "// changed\n")
    assert ck.source_tag(copy) != tag


def test_the_kernel_source_holds_the_plain_versions_arithmetic():
    """No fast-math and no reciprocal square root: the kernel rounds each
    step as the plain version does, and its C entry point is the one bound."""
    src = ck.SOURCES["rms_norm"].read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for op in ("__fsqrt_rn", "__fdiv_rn", "__fmul_rn", "__fadd_rn", "1e-12f"):
        assert op in code, op
    for banned in ("rsqrt", "__fdividef", "use_fast_math", "atomicAdd"):
        assert banned not in code, banned
    assert 'extern "C" int rms_norm(' in code


def test_a_replay_adds_back_both_kernels_launches():
    """The counters count kernel executions: a captured call's replay adds
    its flash forward and RMSNorm launches again."""
    counted = collections.Counter(flash_fwd=2, rms_norm=5)
    call = graphed.CapturedCall(types.SimpleNamespace(replay=lambda: None),
                                {"x": torch.zeros(3)}, {"y": torch.ones(3)}, counted)
    fa0, rn0 = ck.LAUNCHES["flash_fwd"], ck.LAUNCHES["rms_norm"]
    out = call.replay({"x": torch.ones(3)})
    out["y"].add_(1.0)  # a clone: the static output is untouched
    assert (ck.LAUNCHES["flash_fwd"], ck.LAUNCHES["rms_norm"]) == (fa0 + 2, rn0 + 5)
    assert torch.equal(call.outputs["y"], torch.ones(3))
    assert torch.equal(call.inputs["x"], torch.ones(3))
