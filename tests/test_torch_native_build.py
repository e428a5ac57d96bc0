"""The port's native loader builds once and loads whole when several
processes start together (``datasets/native_loader.py``): six processes,
each pointed at one fresh copy of ``native/`` through the module's
``_NATIVE_DIR`` / ``_BUILD_DIR`` / ``_SO_PATH`` attributes, call
``available()`` at the same moment, and all six load the library."""

import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from _torch_parity import have_jpeglib

REPO = Path(__file__).resolve().parents[1]
N_PROCS = 6

_CHILD = r"""
import sys, time
from pathlib import Path
from multimodal_diffusion_torch.datasets import native_loader as N
native, build, ready, go = (Path(a) for a in sys.argv[1:5])
N._NATIVE_DIR, N._BUILD_DIR, N._SO_PATH = native, build, build / "libavloader.so"
ready.touch()
while not go.exists():
    time.sleep(0.005)
print("LOADED" if N.available() else "UNAVAILABLE", flush=True)
"""


@pytest.mark.skipif(shutil.which("g++") is None or shutil.which("make") is None
                    or not have_jpeglib(), reason="the native loader needs g++, make and "
                    "libjpeg's header (jpeglib.h)")
def test_six_processes_build_and_load_at_once(tmp_path):
    native = tmp_path / "native"
    shutil.copytree(REPO / "native", native, ignore=shutil.ignore_patterns("build"))
    build = tmp_path / "_build"
    go = tmp_path / "go"
    procs, ready = [], []
    for i in range(N_PROCS):
        ready.append(tmp_path / f"ready_{i}")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(native), str(build), str(ready[-1]), str(go)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + 25
    try:
        while not all(r.exists() for r in ready):
            assert time.monotonic() < deadline, "the processes did not start in time"
            assert all(p.poll() is None for p in procs), "a process ended before the start"
            time.sleep(0.01)
        go.touch()
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            p.kill()
    said = [out.strip() for out, _ in outs]
    assert said == ["LOADED"] * N_PROCS, [err[-400:] for _, err in outs]
    assert (build / "libavloader.so").is_file()
    # nothing of a private build directory is left behind
    assert sorted(p.name for p in build.iterdir()) == ["avloader.lock", "libavloader.so"]
