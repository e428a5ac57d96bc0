"""ctypes bindings for the repo's native C++ clip loader
(``native/avloader.cpp``; counterpart of the JAX package's
``datasets/native_loader.py``).

The library is built on first use with the repo's ``native/Makefile`` rule
(g++ and libjpeg), into the port's git-ignored
``multimodal_diffusion_torch/_build/`` rather than ``native/build/``: made in
a private temporary directory and renamed into place, under a file lock
that every process also takes before its first load, so processes that
start together never load a half-written library. Where it cannot be built
(no g++ or no ``jpeglib.h``) the datasets decode with PIL, as the JAX
package's do. It exposes:

  decode_clip(paths, H, W)     -> float32 [3, T, H, W] in [0, 1]
  decode_clip_u8(paths, H, W)  -> uint8 [T, H, W, 3]
  read_wav_mono(path)          -> (float32 [n], sample_rate)
  available()                  -> bool (compiled + loadable)

``datasets/av_manifest.py`` uses it when it is available and PIL + scipy
otherwise; the records path never imports this module.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

# where the Makefile is and where the library goes (module attributes: a
# test points them at a copy of native/)
_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_SO_PATH = _BUILD_DIR / "libavloader.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


@contextmanager
def build_lock():
    """An exclusive ``flock`` on ``_build/avloader.lock``: held while one
    process builds the library and while any process first loads it, so no
    process loads a library that another is still writing."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "avloader.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build() -> bool:
    """make the library in a private directory, then rename it onto
    _SO_PATH: a reader sees no file or a whole one. Call under build_lock."""
    tmp = Path(tempfile.mkdtemp(prefix=".avloader-", dir=_BUILD_DIR))
    try:
        r = subprocess.run(
            ["make", "-C", str(_NATIVE_DIR), f"BUILD={tmp}"],
            capture_output=True, text=True, timeout=120,
        )
        built = tmp / _SO_PATH.name
        if r.returncode != 0 or not built.exists():
            return False
        os.replace(built, _SO_PATH)
        return True
    except Exception:
        return False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _open() -> Optional[ctypes.CDLL]:
    """The library, built first when missing, loaded under build_lock; one
    more build and load when a present file does not load (one left by a
    build that was cut off)."""
    with build_lock():
        for attempt in range(2):
            if (attempt or not _SO_PATH.exists()) and not _build():
                return None
            try:
                return ctypes.CDLL(str(_SO_PATH))
            except OSError:
                continue
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib = _open()
        if lib is None:
            return None
        for name, out_t in (("decode_clip_f32", ctypes.c_float),
                            ("decode_clip_u8", ctypes.c_ubyte)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.POINTER(out_t)]
        lib.load_wav_mono.restype = ctypes.c_long
        lib.load_wav_mono.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _decode(fn_name: str, out: np.ndarray, c_type, paths: Sequence, H: int, W: int,
            n_threads: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native avloader unavailable")
    T = len(paths)
    if n_threads <= 0:
        n_threads = min(T, os.cpu_count() or 1)
    arr = (ctypes.c_char_p * T)(*[str(p).encode() for p in paths])
    rc = getattr(lib, fn_name)(arr, T, H, W, n_threads,
                               out.ctypes.data_as(ctypes.POINTER(c_type)))
    if rc != 0:
        raise RuntimeError(f"native decode failed for frame {rc - 1}: {paths[rc - 1]}")
    return out


def decode_clip(paths: Sequence, H: int, W: int, n_threads: int = 0) -> np.ndarray:
    """JPEG frame paths -> [3, T, H, W] float32 in [0, 1]."""
    out = np.empty((3, len(paths), H, W), dtype=np.float32)
    return _decode("decode_clip_f32", out, ctypes.c_float, paths, H, W, n_threads)


def decode_clip_u8(paths: Sequence, H: int, W: int, n_threads: int = 0) -> np.ndarray:
    """JPEG frame paths -> [T, H, W, 3] uint8 (the on-device normalisation path)."""
    out = np.empty((len(paths), H, W, 3), dtype=np.uint8)
    return _decode("decode_clip_u8", out, ctypes.c_ubyte, paths, H, W, n_threads)


def read_wav_mono(path) -> Tuple[np.ndarray, int]:
    """RIFF/WAV (PCM8/16/32, float32) -> (float32 mono [n], sample_rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native avloader unavailable")
    sr = ctypes.c_int(0)
    n = lib.load_wav_mono(str(path).encode(), None, 0, ctypes.byref(sr))
    if n < 0:
        raise RuntimeError(f"native wav parse failed: {path}")
    out = np.empty(n, dtype=np.float32)
    got = lib.load_wav_mono(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, ctypes.byref(sr),
    )
    if got < 0:
        raise RuntimeError(f"native wav read failed: {path}")
    return out[:got], int(sr.value)
