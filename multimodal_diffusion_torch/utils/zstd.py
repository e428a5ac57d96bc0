"""zstd decompression through the system's ``libzstd`` (bound with ctypes).

The JAX package's orbax checkpoints compress twice with zstd: the OCDBT
key-value store's manifest and b-tree nodes, and every zarr chunk inside it
(``train/orbax_reader.py``). The port imports no Python zstd package; it
binds ``libzstd.so.1``, which the card's machine and this repo's hosts
carry. A frame that states its content size is decoded in one
``ZSTD_decompressDCtx`` call; one that does not (orbax writes such chunks)
goes through ``ZSTD_decompressStream`` into a buffer that grows as needed.
Concatenated frames decode to the concatenation of their contents.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

_CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
_CONTENTSIZE_ERROR = 2 ** 64 - 2
_MAGIC = b"\x28\xb5\x2f\xfd"


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_LIB = None


def library() -> ctypes.CDLL:
    """The bound libzstd (loaded once). Raises RuntimeError when the system
    has none: there is no other route."""
    global _LIB
    if _LIB is not None:
        return _LIB
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise RuntimeError(
            "libzstd was not found (ctypes.util.find_library('zstd') is None); reading an "
            "orbax checkpoint needs the system's libzstd.so.1")
    lib = ctypes.CDLL(name)
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_createDCtx.restype = vp
    lib.ZSTD_freeDCtx.argtypes = [vp]
    lib.ZSTD_freeDCtx.restype = size_t
    lib.ZSTD_getFrameContentSize.argtypes = [vp, size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_findFrameCompressedSize.argtypes = [vp, size_t]
    lib.ZSTD_findFrameCompressedSize.restype = size_t
    lib.ZSTD_decompressDCtx.argtypes = [vp, vp, size_t, vp, size_t]
    lib.ZSTD_decompressDCtx.restype = size_t
    lib.ZSTD_decompressStream.argtypes = [vp, ctypes.POINTER(_OutBuffer),
                                          ctypes.POINTER(_InBuffer)]
    lib.ZSTD_decompressStream.restype = size_t
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_versionString.restype = ctypes.c_char_p
    lib.path = name
    _LIB = lib
    return lib


def version() -> str:
    """libzstd's version string, e.g. '1.5.5'."""
    return library().ZSTD_versionString().decode()


def _check(lib, ret: int, what: str) -> int:
    if lib.ZSTD_isError(ret):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(ret).decode()}")
    return ret


def decompress(data, size_hint: Optional[int] = None) -> np.ndarray:
    """Decode the zstd frame(s) in `data` (bytes-like) into a new uint8
    array. `size_hint` is the expected decoded size, used to size the output
    of a frame that does not state its own."""
    lib = library()
    src = np.frombuffer(data, np.uint8)
    if src.size < 4 or src[:4].tobytes() != _MAGIC:
        raise ValueError("not a zstd frame")
    src_ptr = src.ctypes.data
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        size = lib.ZSTD_getFrameContentSize(src_ptr, src.size)
        if size == _CONTENTSIZE_ERROR:
            raise ValueError("zstd: bad frame header")
        frame_len = _check(lib, lib.ZSTD_findFrameCompressedSize(src_ptr, src.size), "frame")
        if size != _CONTENTSIZE_UNKNOWN and frame_len == src.size:
            out = np.empty(size, np.uint8)
            n = _check(lib, lib.ZSTD_decompressDCtx(dctx, out.ctypes.data, size, src_ptr,
                                                    src.size), "decompress")
            if n != size:
                raise ValueError(f"zstd: decoded {n} bytes, the frame states {size}")
            return out
        return _stream(lib, dctx, src, max(int(size_hint or 0), 4 * src.size, 64))
    finally:
        lib.ZSTD_freeDCtx(dctx)


def _stream(lib, dctx, src: np.ndarray, capacity: int) -> np.ndarray:
    out = np.empty(capacity, np.uint8)
    inb = _InBuffer(src.ctypes.data, src.size, 0)
    outb = _OutBuffer(out.ctypes.data, out.size, 0)
    while True:
        ret = _check(lib, lib.ZSTD_decompressStream(dctx, ctypes.byref(outb),
                                                    ctypes.byref(inb)), "stream")
        if ret == 0 and inb.pos == inb.size:
            return out[:outb.pos]
        if outb.pos == outb.size:  # full: grow and go on
            grown = np.empty(2 * out.size, np.uint8)
            grown[:out.size] = out
            out = grown
            outb.dst, outb.size = out.ctypes.data, out.size
        elif inb.pos == inb.size:
            raise ValueError("zstd: truncated frame")
