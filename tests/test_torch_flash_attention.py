"""The port's flash-attention forward against the JAX package: the plain
PyTorch version against the Pallas kernel in interpret mode (out and lse),
the dispatch function against the JAX one, the wrapper's refusal to fall
back, the alignment the bf16 kernel asks of its operands, the build key, the
forward kernel picked by shape and the C entry's arguments. The CUDA kernels
themselves are tested in test_torch_kernels_gpu.py."""

import ctypes
import re
import types
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_diffusion_torch.ops import attention as t_att
from multimodal_diffusion_torch.ops import cuda_kernels as ck
from multimodal_diffusion_torch.ops import flash_attention as t_fa
from multimodal_diffusion_tpu.ops import attention as j_att
from multimodal_diffusion_tpu.ops.flash_attention import _flash_forward

SHAPES = [(1, 2, 128, 64), (2, 2, 133, 64), (1, 1, 384, 32)]
MASKS = ["none", "keys", "row_all_masked"]


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype) for _ in range(3)]


def _key_padding(B, N, case, seed):
    """[B, N] bool, True = PAD."""
    if case == "none":
        return None
    rng = np.random.default_rng(seed + 100)
    kpad = rng.uniform(size=(B, N)) < 0.3
    kpad[:, 0] = False  # at least one valid key per row
    if case == "row_all_masked":
        kpad[0] = True
    return kpad


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_pallas_interpret(shape, mask):
    B, H, N, Dh = shape
    q, k, v = _qkv(shape, seed=N + Dh)
    kpad = _key_padding(B, N, mask, seed=N)
    j_out, j_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  None if kpad is None else jnp.asarray(kpad),
                                  interpret=True)
    valid = None if kpad is None else torch.from_numpy(~kpad)
    t_out, t_lse = t_fa.flash_forward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), valid)
    j_lse = np.asarray(j_lse)[:, :N, 0].reshape(B, H, N)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, rtol=2e-5, atol=2e-5)
    if mask == "row_all_masked":
        assert np.all(t_out[0].numpy() == 0.0)
        assert np.all(np.asarray(j_out)[0] == 0.0)


def _compare_with_pallas_interpret(q, k, v, kpad):
    """flash_forward_reference against the Pallas kernel in interpret mode on
    fp32 inputs: out and lse within 2e-5 (another order of summation)."""
    B, H, N, _ = q.shape
    j_out, j_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  None if kpad is None else jnp.asarray(kpad),
                                  interpret=True)
    valid = None if kpad is None else torch.from_numpy(~kpad)
    t_out, t_lse = t_fa.flash_forward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), valid)
    j_lse = np.asarray(j_lse)[:, :N, 0].reshape(B, H, N)
    assert np.all(np.isfinite(t_out.numpy())) and np.all(np.isfinite(t_lse.numpy()))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mask", ["none", "keys"])
@pytest.mark.parametrize("N", [15, 16, 17, 145])
def test_reference_matches_pallas_interpret_at_the_16_row_edges(N, mask):
    """The sequence lengths around the 16-row pieces the tensor-core forward
    kernel works in: the plain version it is held to on the card agrees with
    the Pallas kernel there too."""
    shape = (2, 2, N, 64)
    q, k, v = _qkv(shape, seed=40 + N)
    _compare_with_pallas_interpret(q, k, v, _key_padding(2, N, mask, seed=N))


@pytest.mark.parametrize("n_first_masked", [64, 128])
def test_reference_matches_pallas_interpret_after_a_fully_masked_first_tile(n_first_masked):
    """Batch row 0 cannot attend the first 64 keys (one stage of the CUDA
    kernel's walk) or the first 128 (one tile of the Pallas kernel's): the
    running max leaves the -1e30 sentinel only at the next tile, where
    exp(-1e30 - m) must read 0."""
    shape = (2, 2, 150, 64)
    q, k, v = _qkv(shape, seed=50 + n_first_masked)
    kpad = np.zeros((2, 150), dtype=bool)
    kpad[0, :n_first_masked] = True
    _compare_with_pallas_interpret(q, k, v, kpad)


def _fused_qkv_views(B, N, H, Dh, dtype):
    qkv = torch.zeros((B, N, 3, H, Dh), dtype=dtype)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


@pytest.mark.parametrize("Dh", t_fa.SUPPORTED_HEAD_DIMS)
def test_alignment_check_takes_the_forward_operands(Dh):
    """q, k, v as the denoiser hands them over (head views of the fused qkv
    projection, the sampler's CFG-doubled batch) and the [B, N, H, Dh] out
    buffer flash_forward allocates: 16-byte aligned at every head dim."""
    q, k, v = _fused_qkv_views(16, 133, 8, Dh, torch.bfloat16)
    out = torch.empty((16, 133, 8, Dh), dtype=torch.bfloat16).transpose(1, 2)
    assert ck.misaligned_operands(q=q, k=k, v=v, out=out) == []
    ck.require_aligned("flash_forward", q=q, k=k, v=v, out=out)


@pytest.mark.parametrize("operand", ["q", "k", "v", "out"])
def test_alignment_check_refuses_a_misaligned_forward_operand(operand):
    """A bf16 operand 8 bytes into a row of a wider buffer is named and
    refused, whichever it is; the same view in fp32 steps by 4 elements."""
    ok = torch.zeros((2, 2, 40, 64), dtype=torch.bfloat16)
    off = torch.zeros((2, 2, 40, 72), dtype=torch.bfloat16)[..., 4:68]
    assert off.stride(-1) == 1 and off.data_ptr() % 16 == 8
    operands = {name: (off if name == operand else ok) for name in ("q", "k", "v", "out")}
    assert ck.misaligned_operands(**operands) == [operand]
    with pytest.raises(ValueError, match=rf"flash_forward: \['{operand}'\] not 16-byte aligned"):
        ck.require_aligned("flash_forward", **operands)
    assert ck.misaligned_operands(
        **{operand: torch.zeros((2, 2, 40, 72))[..., 4:68]}) == []


@pytest.mark.parametrize("name", ["flash_bwd", "flash_fwd"])
def test_build_tag_of_each_source_follows_the_shared_header(name, tmp_path):
    """flash_fwd.cu and flash_bwd.cu both include csrc/flash_common.cuh, and
    the key of each built library changes with that header alone."""
    source = ck.SOURCES[name]
    assert '#include "flash_common.cuh"' in source.read_text()
    copy = tmp_path / source.name
    copy.write_text(source.read_text())
    header = tmp_path / "flash_common.cuh"
    header.write_text((source.parent / "flash_common.cuh").read_text())
    tag = ck.source_tag(copy)
    header.write_text(header.read_text() + "// changed\n")
    assert ck.source_tag(copy) != tag


def test_reference_bf16_matches_pallas_interpret():
    shape = (2, 2, 133, 64)
    q, k, v = _qkv(shape, seed=7)
    kpad = _key_padding(2, 133, "keys", seed=7)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    j_out, j_lse = _flash_forward(*jb, jnp.asarray(kpad), interpret=True)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    t_out, t_lse = t_fa.flash_forward_reference(*tb, torch.from_numpy(~kpad))
    assert t_out.dtype == torch.bfloat16
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(t_lse.numpy(),
                               np.asarray(j_lse)[:, :133, 0].reshape(2, 2, 133),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kernel", [None, False, True])
@pytest.mark.parametrize("mask", MASKS)
def test_multi_head_attention_matches_jax(mask, kernel):
    """The kernel path forced on CPU tensors runs the kernel's plain
    version; no override and the dense path forced run the dense path — all
    three agree with the JAX dispatch."""
    shape = (2, 4, 133, 32)
    q, k, v = _qkv(shape, seed=3)
    kpad = _key_padding(2, 133, mask, seed=3)
    j = j_att.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_padding_mask=None if kpad is None else jnp.asarray(kpad))
    with t_att.attention_path({None: None, False: "dense", True: "kernel"}[kernel]):
        t = t_att.multi_head_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            key_padding_mask=None if kpad is None else torch.from_numpy(kpad))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5, atol=2e-5)
    if mask == "row_all_masked":
        assert np.all(t[0].numpy() == 0.0)


def test_cpu_tensors_never_touch_the_kernel():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 1, 16, 32), seed=0))
    with mock.patch.object(ck, "library", side_effect=AssertionError("kernel path")):
        out, lse = t_fa.flash_forward(q, k, v)
    assert out.shape == q.shape and lse.shape == (1, 1, 16)


def test_wrapper_raises_for_a_cuda_tensor_without_a_kernel():
    """A CUDA tensor launches the kernel or raises: with no nvcc to build it,
    the wrapper raises and never runs the plain version."""
    q = torch.empty((1, 1, 16, 32), device="meta")
    reference = mock.Mock(side_effect=AssertionError("fell back to the plain path"))
    with mock.patch.object(t_fa, "_check_inputs"), \
            mock.patch.object(ck, "_nvcc", return_value=None), \
            mock.patch.object(t_fa, "flash_forward_reference", reference), \
            mock.patch.object(ck, "BUILD_DIR", ck.BUILD_DIR / "absent"):
        ck.library.cache_clear()
        try:
            with pytest.raises(RuntimeError, match="nvcc not found"):
                t_fa.flash_forward(q, q, q)
        finally:
            ck.library.cache_clear()
    reference.assert_not_called()


def test_wrapper_rejects_a_non_cuda_device():
    q = torch.empty((1, 1, 16, 32), device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        t_fa.flash_forward(q, q, q)


# [B, H, N, Dh] and dtype of the attention calls the cells and chip_smoke.py
# make, and the forward kernel for each: the warp-specialised design for bf16
# at head dim 64 from WS_MIN_KEYS keys on, today's kernel for the rest
KERNEL_CHOICES = [
    ((2, 48, 17776, 64), torch.bfloat16, "flash_fwd_ws"),  # CogVideoX-5B, the CFG batch
    ((2, 48, 1576, 64), torch.bfloat16, "flash_fwd_ws"),  # CogVideoX, one latent frame
    ((2, 48, t_fa.WS_MIN_KEYS, 64), torch.bfloat16, "flash_fwd_ws"),
    ((2, 48, t_fa.WS_MIN_KEYS - 1, 64), torch.bfloat16, "flash_fwd"),
    ((16, 8, 133, 64), torch.bfloat16, "flash_fwd"),  # mvp sampler
    ((8, 8, 133, 64), torch.bfloat16, "flash_fwd"),  # mvp train
    ((16, 6, 397, 64), torch.bfloat16, "flash_fwd"),  # t2a sampler
    ((16, 4, 77, 64), torch.bfloat16, "flash_fwd"),  # text encoder
    ((16, 6, 64, 64), torch.bfloat16, "flash_fwd"),  # pixel sampler
    ((16, 8, 421, 128), torch.bfloat16, "flash_fwd"),  # spec8 sampler and serving
    ((8, 8, 421, 128), torch.bfloat16, "flash_fwd"),  # spec8 train
    ((1, 24, 4608, 128), torch.bfloat16, "flash_fwd"),  # FLUX.1-dev
    ((16, 4, 1152, 128), torch.bfloat16, "flash_fwd"),  # t2i sampler
    ((1, 24, 17776, 128), torch.bfloat16, "flash_fwd"),  # Dh 128 at long N
    ((2, 48, 17776, 32), torch.bfloat16, "flash_fwd"),  # Dh 32 at long N
    ((2, 48, 17776, 64), torch.float32, "flash_fwd"),  # fp32
]


@pytest.mark.parametrize("shape,dtype,kernel", KERNEL_CHOICES,
                         ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else str(c))
def test_forward_kernel_by_shape(shape, dtype, kernel):
    B, H, N, Dh = shape
    assert t_fa.forward_kernel(dtype, Dh, N) == kernel


def test_forward_entry_takes_the_declared_arguments():
    """The C entries of csrc/flash_fwd.cu (which cannot be built here) have
    the parameters, in kind and order, that the ctypes declarations pass:
    flash_fwd its pointers, ints (device, B, H, N, D, dtype, the design),
    twelve strides, the scale and the stream; flash_fwd_occupancy the head
    dim, the design and two int pointers."""
    code = ck.SOURCES["flash_fwd"].read_text()
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float, "int*": ctypes.POINTER(ctypes.c_int)}
    lib = types.SimpleNamespace(flash_fwd=types.SimpleNamespace(),
                                flash_fwd_occupancy=types.SimpleNamespace())
    t_fa._declare_forward(lib)
    for entry in ("flash_fwd", "flash_fwd_occupancy"):
        params = re.search(rf'extern "C" int {entry}\((.*?)\)\s*\{{', code, re.S).group(1)
        declared = []
        for param in params.split(","):
            words = param.replace("const ", "").replace("*", " * ").split()
            declared.append(kinds[" ".join(words[:-1]).replace(" *", "*")])
        assert getattr(lib, entry).argtypes == declared, entry
    assert t_fa._DESIGN == {"flash_fwd": 0, "flash_fwd_ws": 1}
