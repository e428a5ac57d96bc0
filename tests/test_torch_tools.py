"""The port's counterparts of the repo's own tools
(multimodal_diffusion_torch/tools/) against the JAX-side originals, on the
CPU:

* eval_av_quality: ``build_report`` equal to tools/eval_av_quality.py's on
  random rows (1e-12); the whole eval on a manifest of synthetic clips
  written here, the committed orbax fixture as both sides' checkpoint, the
  JAX tool handed the port's generated waveforms (its sample_one_direction
  patched in this process): both reports equal to 1e-6 relative;
* latent_probe: equal to tools/latent_probe.py's on the fixture (1e-5);
* preprocess_audio: WAV and log-mel outputs, with and without --rms-norm
  and --align-to, bit-equal to scripts/preprocess_audio.py's (an .mpg too,
  where the bundled ffmpeg libraries are there);
* supervise: the seven cases of tests/test_supervise.py, same timeouts,
  with the watch loop polled every 0.2 s;
* quant_probe's numerics rows equal to tools/quant_probe.py's at tiny sizes,
  and mfu_probe's report keys, on the CPU.
"""

import importlib.util
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import chip_smoke
from _torch_orbax import FIXTURE
from _torch_parity import native_loaders  # noqa: F401  (fixture)
from multimodal_diffusion_torch.media import mpeg_audio as TMA
from multimodal_diffusion_torch.media.audio_io import write_wav
from multimodal_diffusion_torch.tools import eval_av_quality as TEV
from multimodal_diffusion_torch.tools import latent_probe as TLP
from multimodal_diffusion_torch.tools import make_mpg
from multimodal_diffusion_torch.tools import mfu_probe as TMFU
from multimodal_diffusion_torch.tools import preprocess_audio as TPA
from multimodal_diffusion_torch.tools import quant_probe as TQP

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier runs six workers on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(rel: str, name: str):
    """A JAX-side root script as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_close(got, want, rel: float, path: str = "") -> None:
    """Equal key sets and values within `rel` of their magnitude (exact for
    non-floats), recursively."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_close(got[k], want[k], rel, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, rel, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=rel, abs=rel * 1e-3), path
    else:
        assert got == want, path


# ---------------------------------------------------------------------------
# eval_av_quality
# ---------------------------------------------------------------------------


def _rows(rng, n: int, mouth: bool) -> list:
    sufs = ["", "0"] + (["_mouth", "_mouth0"] if mouth else [])
    rows = []
    for j in range(n):
        row = {"_manifest_index": j, "logmel_l1": float(rng.uniform(2, 3)),
               "spec_convergence": float(rng.uniform(0, 1)),
               "env_corr_gen": float(rng.uniform(-1, 1))}
        for suf in sufs:
            for who in ("gen", "real", "shuf", "real_shuf"):
                row[f"av_sync_corr{suf}_{who}"] = float(rng.uniform(-1, 1))
        if n > 1:
            row.update(logmel_l1_shuf=float(rng.uniform(2, 3)),
                       env_corr_shuf=float(rng.uniform(-1, 1)))
        rows.append(row)
    return rows, sufs


@pytest.mark.parametrize("n,mouth", [(8, False), (5, True), (1, True)])
def test_build_report_matches_jax(n, mouth):
    jax_eval = _load("tools/eval_av_quality.py", "jax_eval_av_quality")
    rows, sufs = _rows(np.random.default_rng(n), n, mouth)
    got, want = TEV.build_report(rows, sufs), jax_eval.build_report(rows, sufs)
    _assert_close(got, want, 1e-12)
    rng = np.random.default_rng(1)
    a, b = rng.uniform(-1, 1, 8000), rng.uniform(-1, 1, 8000)
    assert TEV.env_corr0(a, b, 8000) == pytest.approx(jax_eval.env_corr0(a, b, 8000), rel=1e-12)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four clips at the orbax fixture's shape (8 PNG frames of 32x32 at 8
    fps, 1 s of 8 kHz audio), a moving bright square and noise whose
    loudness follows it, and the fixture's config with this manifest and
    the fixture's checkpoint (a copy) as overlays. Returns the config
    paths."""
    root = tmp_path_factory.mktemp("eval_corpus")
    rng = np.random.default_rng(0)
    clips = []
    for i in range(4):
        fdir = root / f"clip_{i}"
        fdir.mkdir()
        speed = 1 + i
        for t in range(8):
            img = rng.integers(0, 40, (32, 32, 3), dtype=np.uint8)
            r = (t * speed * 3) % 24
            img[r:r + 8, 4 * i:4 * i + 8] = 230
            Image.fromarray(img).save(fdir / f"frame_{t:06d}.png")
        env = np.repeat(rng.uniform(0.1, 0.6, 8), 1000)
        write_wav(root / f"clip_{i}.wav", (env * rng.uniform(-1, 1, 8000)).astype(np.float32),
                  8000)
        clips.append({"video_frames_dir": str(fdir), "audio_wav_path": str(root / f"clip_{i}.wav"),
                      "fps": 8, "sr": 8000, "clip_seconds": 1.0})
    manifest = root / "clips.json"
    manifest.write_text(json.dumps({"clips": clips}))
    shutil.copytree(FIXTURE / "ckpt", root / "ckpt")
    overlay = root / "overlay.yaml"
    overlay.write_text(yaml.safe_dump({"paths": {"ckpt_path": str(root / "ckpt")},
                                       "data": {"train_split_glob": str(manifest)}}))
    return [str(FIXTURE / "config.yaml"), str(overlay)]


@pytest.mark.parametrize("extra", [[], ["--spread", "--ema", "--n", "3"]],
                         ids=["tail", "spread-ema"])
def test_eval_av_quality_matches_jax(corpus, native_loaders, monkeypatch,  # noqa: F811
                                    tmp_path, extra):
    from multimodal_diffusion_tpu.infer import sample_clip as JSC

    calls = []
    real = TEV.sample_one_direction

    def recording(**kw):
        out = real(**kw)
        calls.append(out["audio"])
        return out

    monkeypatch.setattr(TEV, "sample_one_direction", recording)
    args = ["--config", *corpus, "--device", "cpu", *extra]
    TEV.main(args + ["--out", str(tmp_path / "port.json")])
    assert len(calls) == 2 and calls[0].shape == (3 if extra else 4, 8000)
    assert np.isfinite(calls[0]).all() and not np.array_equal(calls[0], calls[1])

    given = iter(calls)
    monkeypatch.setattr(JSC, "sample_one_direction",
                        lambda **kw: {"audio": next(given), "sr": 8000})
    jax_eval = _load("tools/eval_av_quality.py", "jax_eval_av_quality")
    jax_eval.main(args + ["--out", str(tmp_path / "jax.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert "gap_mouth_gen" in want["mean"] and "cond_sensitivity_logmel" in want["mean"]
    _assert_close(got, want, 1e-6)
    # the keys chip_smoke.py gates the card's report on
    assert sorted(want["mean"]) == sorted(
        chip_smoke.eval_report_keys(["", "0", "_mouth", "_mouth0"]))


def test_latent_probe_matches_jax(corpus, native_loaders, tmp_path):  # noqa: F811
    args = ["--config", *corpus, "--device", "cpu", "--n", "4"]
    TLP.main(args + ["--out", str(tmp_path / "port.json")])
    _load("tools/latent_probe.py", "jax_latent_probe").main(
        args + ["--out", str(tmp_path / "jax.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert want["latent_rmsnorm"] and want["n_clips"] == 4
    _assert_close(got, want, 1e-5)
    assert sorted(want["z_video"]) == sorted(want["z_audio"]) == sorted(chip_smoke.LATENT_STATS)


# ---------------------------------------------------------------------------
# preprocess_audio
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def raw_audio(tmp_path_factory):
    """A tree of raw audio: a mono 16 kHz wav, a stereo 22.05 kHz wav in a
    subdirectory, and, where the bundled libraries are there, an .mpg of a
    tone (32 kHz MP2). Returns (the directory, whether it holds the .mpg)."""
    root = tmp_path_factory.mktemp("raw_audio")
    rng = np.random.default_rng(0)
    from scipy.io import wavfile

    wavfile.write(str(root / "a.wav"), 16000,
                  (rng.uniform(-0.3, 0.3, 40000) * 32767).astype(np.int16))
    (root / "sub").mkdir()
    wavfile.write(str(root / "sub" / "b.wav"), 22050,
                  (rng.uniform(-0.5, 0.5, (30000, 2)) * 32767).astype(np.int16))
    has_mpg = TMA.available()  # decided here, never at import
    if has_mpg:
        make_mpg.write_mpg(root / "sub" / "c.mpg", make_mpg.encode_mp2(make_mpg.tone(1.5)))
    return root, has_mpg


def _same_tree(got: Path, want: Path) -> None:
    files = sorted(p.relative_to(want) for p in want.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(got) for p in got.rglob("*") if p.is_file())
    for rel in files:
        if rel.suffix == ".npz":
            with np.load(got / rel) as g, np.load(want / rel) as w:
                assert sorted(g.files) == sorted(w.files)
                for k in w.files:
                    assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (rel, k)
        elif rel.name == "mel_manifest.json":
            text = (got / rel).read_text().replace(str(got), str(want))
            assert text == (want / rel).read_text()
        else:
            assert (got / rel).read_bytes() == (want / rel).read_bytes(), rel


@pytest.mark.parametrize("mode", [["--mode", "wav"], ["--mode", "wav", "--rms-norm"],
                                  ["--mode", "mel", "--n-mels", "40"],
                                  ["--mode", "mel", "--align-to", "ALIGN"]],
                         ids=["wav", "wav-rms", "mel", "mel-aligned"])
def test_preprocess_audio_matches_jax(raw_audio, tmp_path, mode):
    root, has_mpg = raw_audio
    if "ALIGN" in mode:
        align = tmp_path / "clips.json"
        align.write_text(json.dumps({"clips": [{"clip_seconds": 1.0}, {}, {"clip_seconds": 1.0}]}))
        mode = [str(align) if m == "ALIGN" else m for m in mode]
    jax_pre = _load("scripts/preprocess_audio.py", "jax_preprocess_audio")
    for main, out in ((TPA.main, tmp_path / "port"), (jax_pre.main, tmp_path / "jax")):
        main(["--input", str(root), "--output", str(out), "--sr", "16000", *mode])
    _same_tree(tmp_path / "port", tmp_path / "jax")
    names = {p.name for p in (tmp_path / "port").rglob("*")}
    assert ("c.wav" in names or "c.npz" in names or "c_clip_0000.npz" in names) == has_mpg


# ---------------------------------------------------------------------------
# supervise (the cases of tests/test_supervise.py)
# ---------------------------------------------------------------------------


def _supervise(tmp_path, child_src, *, startup=10, stall=2, restarts=2, backoff=0.2,
               timeout=90, extra=(), child_args=True):
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent(child_src))
    cmd = [sys.executable, "-m", "multimodal_diffusion_torch.tools.supervise",
           "--progress-file", str(tmp_path / "metrics.jsonl"),
           "--startup-seconds", str(startup), "--stall-seconds", str(stall),
           "--grace-seconds", "5", "--max-restarts", str(restarts),
           "--backoff-seconds", str(backoff), "--poll-seconds", "0.2", *extra,
           "--", sys.executable, str(child)] + ([str(tmp_path)] if child_args else [])
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO)


def test_supervise_clean_child_passes_through(tmp_path):
    r = _supervise(tmp_path, """
        import sys, time
        from pathlib import Path
        p = Path(sys.argv[1]) / "metrics.jsonl"
        for i in range(3):
            p.open("a").write(f'{{"step": {i}}}\\n')
            time.sleep(0.1)
    """, stall=30)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "completed cleanly" in r.stdout
    assert "STALL" not in r.stdout


def test_supervise_stalled_child_is_killed_and_restart_resumes(tmp_path):
    r = _supervise(tmp_path, """
        import sys, time
        from pathlib import Path
        root = Path(sys.argv[1])
        p = root / "metrics.jsonl"
        state = root / "state"
        if state.exists():
            p.open("a").write('{"step": 2}\\n')
            sys.exit(0)
        state.write_text("ran once")
        p.open("a").write('{"step": 1}\\n')
        time.sleep(3600)
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "STALL (run)" in r.stdout
    assert "restart 1/" in r.stdout
    assert "completed cleanly" in r.stdout


def test_supervise_startup_stall_uses_startup_deadline(tmp_path):
    r = _supervise(tmp_path, """
        import time
        time.sleep(3600)
    """, startup=3, stall=1, restarts=1, timeout=120)
    assert r.returncode != 0
    assert "STALL (startup)" in r.stdout
    assert "giving up" in r.stdout


def test_supervise_crashing_child_is_restarted(tmp_path):
    r = _supervise(tmp_path, """
        import sys
        from pathlib import Path
        root = Path(sys.argv[1])
        state = root / "crashes"
        n = int(state.read_text()) if state.exists() else 0
        state.write_text(str(n + 1))
        p = root / "metrics.jsonl"
        p.open("a").write(f'{{"step": {n}}}\\n')
        sys.exit(0 if n >= 1 else 7)
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "rc=7" in r.stdout
    assert "completed cleanly" in r.stdout


def test_supervise_launch_failures_have_own_budget(tmp_path):
    r = _supervise(tmp_path, """
        import sys
        sys.exit(13)  # dies before any progress-file growth
    """, startup=60, stall=60, restarts=0, timeout=300, child_args=False,
        extra=("--max-launch-failures", "3", "--outage-backoff-seconds", "0.1",
               "--fast-fail-seconds", "0"))
    assert r.returncode == 13, r.stdout + r.stderr
    assert "launch failure 3/3" in r.stdout
    assert "giving up: 4 launch failures" in r.stdout


def test_supervise_fast_identical_failures_are_a_bug_not_an_outage(tmp_path):
    r = _supervise(tmp_path, "import sys; sys.exit(13)\n", startup=60, stall=60, restarts=0,
                   timeout=300, child_args=False,
                   extra=("--max-launch-failures", "48", "--outage-backoff-seconds", "0.1"))
    assert r.returncode == 13, r.stdout + r.stderr
    assert "consecutive fast identical failures" in r.stdout
    assert "launch failure 4/" not in r.stdout


def test_supervise_stall_sigterm_clean_exit_restarts_not_completes(tmp_path):
    r = _supervise(tmp_path, """
        import signal, sys, time
        from pathlib import Path
        root = Path(sys.argv[1])
        p = root / "metrics.jsonl"
        state = root / "resumed"
        if state.exists():
            p.open("a").write('{"step": 2}\\n')
            sys.exit(0)
        state.write_text("x")
        signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
        p.open("a").write('{"step": 1}\\n')
        time.sleep(3600)
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "STALL (run)" in r.stdout
    assert "restart 1/" in r.stdout
    assert "stall, clean child exit" in r.stdout
    assert "completed cleanly" in r.stdout


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------

TINY_QUANT = ["--device", "cpu", "--sizes", "64", "32", "--d", "32", "--tokens", "24",
              "--batch", "1"]


def test_quant_probe_numerics_match_jax(capsys):
    got = TQP.main(TINY_QUANT)
    capsys.readouterr()
    _load("tools/quant_probe.py", "jax_quant_probe").main(TINY_QUANT)
    want = json.loads(capsys.readouterr().out)
    assert set(want) <= set(got) and set(want["square_matmul"]) <= set(got["square_matmul"])
    assert set(got["calib_suite_bf16_tflops"]) == set(want["calib_suite_bf16_tflops"])
    assert got["qkv_numerics"].keys() == want["qkv_numerics"].keys()
    for k, v in want["qkv_numerics"].items():
        assert got["qkv_numerics"][k] == pytest.approx(v, abs=2e-5), k
    assert 0 < got["qkv_numerics"]["int8_rel_err"] < got["qkv_numerics"]["fp8_e4m3_rel_err"]
    # no device peak shares off the card
    assert got["square_matmul"]["int8_peak_share"] is None and got["nvidia_smi"] is None


def test_mfu_probe_report_keys(capsys):
    tiny = ["--batch", "2", "--d", "32", "--layers", "1", "--heads", "2", "--tokens", "20"]
    got = TMFU.main(tiny + ["--seq-multiple", "8", "--device", "cpu", "--masked"])
    capsys.readouterr()
    _load("tools/mfu_probe.py", "jax_mfu_probe").main(tiny + ["--masked", "--calib-size", "64"])
    want = json.loads(capsys.readouterr().out)
    assert set(want) <= set(got), sorted(set(want) - set(got))
    assert got["attn_shape"] == [2, 2, 24, 16] and got["calib_tflops"] is None
    assert "attn_flash_ms" not in got  # the kernel runs on the card only
    assert got["sampler_core_s_implied"] == pytest.approx(50 * got["core_fwd_ms"] / 1e3,
                                                          rel=1e-2)
