"""The hand-written CUDA kernels' plumbing, shared by the op modules that
bind them (``flash_attention.py``, ``rms_norm.py``, ``qk_norm_rope.py``):
the nvcc build of each source of ``SOURCES`` for ``sm_90a`` at first use
into ``BUILD_DIR`` (in .gitignore), keyed by the content of the source and of the headers beside
it; the ctypes loader, to which an op module hands a ``declare`` that types
its own entry points; the 16-byte alignment rule of the kernels' vector
copies; and ``LAUNCHES``, kernel executions by name. A wrapper adds one a
launch; a captured CUDA graph takes back what its capture counted and adds
it again at each replay (``models/graphed.py``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCES = {name: _PKG / "csrc" / f"{name}.cu"
           for name in ("flash_fwd", "flash_bwd", "rms_norm", "qk_norm_rope")}
BUILD_DIR = _PKG / "_build"

LAUNCHES: "collections.Counter[str]" = collections.Counter()


def _nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def source_tag(source: Path) -> str:
    """Content hash of a .cu file and of every header in its directory (any
    of which it may include): the key of its built library."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")) + sorted(source.parent.glob("*.h")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return digest.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``SOURCES[name]`` for sm_90a into BUILD_DIR (once per content
    of the source and the headers beside it) and return the shared library's
    path. The compiler's register and shared-memory report is kept beside it
    as a .log. Safe to call for several sources at once from threads."""
    source = SOURCES[name]
    lib = BUILD_DIR / f"lib{name}_{source_tag(source)}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found: the CUDA kernel {source.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-I", str(source.parent), "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    lib.with_suffix(".log").write_text(res.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The built library of ``SOURCES[name]``, loaded once, its entry points
    typed by ``declare(lib)``."""
    lib = ctypes.CDLL(str(build(name)))
    declare(lib)
    return lib


def misaligned_operands(**operands: torch.Tensor) -> list:
    """Names of the operands that a kernel cannot copy 16 bytes at a time: a
    base address, or a stride of any dim but the last (of a dim longer than
    1), that is not a multiple of 16 bytes. Reads only addresses and
    strides, so it takes tensors on any device."""
    bad = []
    for name, t in operands.items():
        step = 16 // t.element_size()
        strides = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
        if t.data_ptr() % 16 or any(s % step for s in strides):
            bad.append(name)
    return bad


def require_aligned(who: str, **operands: torch.Tensor) -> None:
    """Raise for operands that ``misaligned_operands`` names: there is no
    slower path behind the kernels that copy 16 bytes at a time."""
    bad = misaligned_operands(**operands)
    if bad:
        raise ValueError(f"{who}: {bad} not 16-byte aligned (base address and every "
                         f"stride but the last)")
