"""Sliding-window streaming, the rest of media/ and the eval metrics: the
port against the JAX package on the CPU.

* the four windowing and crossfade functions exactly equal, over lengths,
  rates, hops and fades drawn by hypothesis;
* sample_windows_batched at the shrunk mvp config (x0 audio, so the
  waveform stays bounded): 9 windows in chunks of 4, the last padded, the
  same initial noise fed to both, the sampled latents within 1e-4 of their
  magnitude, the decoder within 1e-4, the waveforms within 2e-4;
* every copied media/audio_io.py and eval/* function on fixed seeded arrays,
  within rtol 1e-6 (they are copies: most agree to the bit)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_parity import jax_model_and_params, shrunk_cfg, torch_model
from multimodal_diffusion_torch.eval import audio_quality as TQ
from multimodal_diffusion_torch.eval import av_sync as TS
from multimodal_diffusion_torch.eval import video_metrics as TV
from multimodal_diffusion_torch.infer import sample_clip as TSC
from multimodal_diffusion_torch.infer import stream_infer as TI
from multimodal_diffusion_torch.media import audio_io as TA
from multimodal_diffusion_torch.media import video_io as TVIO
from multimodal_diffusion_tpu.eval import audio_quality as JQ
from multimodal_diffusion_tpu.eval import av_sync as JSY
from multimodal_diffusion_tpu.eval import video_metrics as JV
from multimodal_diffusion_tpu.infer import stream_infer as JI
from multimodal_diffusion_tpu.media import audio_io as JA
from multimodal_diffusion_tpu.media import video_io as JVIO


def _equal(a, b):
    """Exactly equal (arrays, tuples, numbers)."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# windowing and crossfade
# ---------------------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(L=st.integers(1, 300), sr=st.integers(4, 40), win_s=st.floats(0.1, 4.0),
       hop_frac=st.floats(0.1, 1.0), seed=st.integers(0, 2 ** 16))
def test_split_audio_into_windows_is_the_jax_one(L, sr, win_s, hop_frac, seed):
    y = np.random.default_rng(seed).normal(size=L).astype(np.float32)
    hop_s = max(win_s * hop_frac, 1.0 / sr)
    _equal(TI.split_audio_into_windows(y, sr, win_s, hop_s),
           JI.split_audio_into_windows(y, sr, win_s, hop_s))


@settings(max_examples=60, deadline=None)
@given(T=st.integers(1, 60), fps=st.integers(2, 16), win_s=st.floats(0.2, 3.0),
       hop_frac=st.floats(0.1, 1.0), seed=st.integers(0, 2 ** 16))
def test_split_frames_into_windows_is_the_jax_one(T, fps, win_s, hop_frac, seed):
    frames = np.random.default_rng(seed).integers(0, 256, (T, 2, 3, 3), dtype=np.uint8)
    hop_s = max(win_s * hop_frac, 1.0 / fps)
    _equal(TI.split_frames_into_windows(frames, fps, win_s, hop_s),
           JI.split_frames_into_windows(frames, fps, win_s, hop_s))


@settings(max_examples=60, deadline=None)
@given(N=st.integers(1, 6), L=st.integers(2, 80), hop_frac=st.floats(0.05, 1.0),
       sr=st.integers(4, 40), fade_frac=st.floats(0.0, 0.5), seed=st.integers(0, 2 ** 16))
def test_crossfade_audio_is_the_jax_one(N, L, hop_frac, sr, fade_frac, seed):
    chunks = np.random.default_rng(seed).uniform(-1, 1, (N, L)).astype(np.float32)
    hop = max(1, int(L * hop_frac))
    fade_s = fade_frac * L / sr
    _equal(TI.crossfade_audio(chunks, sr, hop, L, fade_s),
           JI.crossfade_audio(chunks, sr, hop, L, fade_s))


@settings(max_examples=60, deadline=None)
@given(N=st.integers(1, 5), L=st.integers(2, 20), hop_frac=st.floats(0.05, 1.0),
       fade_frac=st.floats(0.0, 0.5), seed=st.integers(0, 2 ** 16))
def test_crossfade_video_is_the_jax_one(N, L, hop_frac, fade_frac, seed):
    chunks = np.random.default_rng(seed).integers(0, 256, (N, L, 2, 3, 3), dtype=np.uint8)
    hop = max(1, int(L * hop_frac))
    fade = int(fade_frac * L)
    _equal(TI.crossfade_video(chunks, hop, L, fade), JI.crossfade_video(chunks, hop, L, fade))


# ---------------------------------------------------------------------------
# batched window sampling
# ---------------------------------------------------------------------------


def _noise_patch(monkeypatch, module, attr, noises, shape, wrap):
    """Make module.attr(...) of `shape` return the next entry of `noises`
    (other shapes go to the original)."""
    orig = getattr(module, attr)
    calls = []

    def fake(*args, **kwargs):
        shp = next((a for a in args if isinstance(a, tuple)), kwargs.get("shape",
                                                                         kwargs.get("size")))
        if shp is not None and tuple(shp) == shape:
            calls.append(shape)
            return wrap(noises[len(calls) - 1])
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, attr, fake)
    return calls


def _record_decoder_inputs(monkeypatch, jm, tm):
    """Record the audio latents each side's sample_one_direction hands its
    decoder: (JAX latents, port latents), one entry per sampler call."""
    j_lat, t_lat = [], []
    j_apply, t_decode = type(jm).apply, tm.decode_audio

    def apply(self, variables, *args, method=None, **kwargs):
        if getattr(method, "__name__", None) == "decode_audio":
            j_lat.append(np.array(args[0]))
        return j_apply(self, variables, *args, method=method, **kwargs)

    def decode_audio(z):
        t_lat.append(z.detach().numpy().copy())
        return t_decode(z)

    monkeypatch.setattr(type(jm), "apply", apply)
    monkeypatch.setattr(tm, "decode_audio", decode_audio)
    return j_lat, t_lat


def test_sample_windows_batched_matches_jax(monkeypatch):
    """A 40-frame prompt (fps 8, 1 s windows every 0.5 s): 9 windows in
    chunks of 4, 4 and 1 padded to 4, each chunk's initial noise the same on
    both sides. What the sampler returns, each call's latent, agrees within
    1e-4 of its magnitude; the port's decoder on the JAX latents gives the
    JAX waveforms within 1e-4. The waveforms of the two pipelines then agree
    within 2e-4 of their magnitude: the decoder carries the latents'
    difference (the largest read 4.1e-5 at a magnitude of 3.6) to about 3.7
    times as much in the waveform (1.5e-4). The CLI's stream function
    stitches the same audio."""
    import jax.numpy as jnp

    from multimodal_diffusion_tpu.infer import sample_clip as JSC

    cfg = shrunk_cfg(sampler_steps=4)
    cfg["diffusion"]["audio"]["param"] = "x0"
    cfg["streaming"] = {"window_seconds": 1.0, "hop_seconds": 0.5, "crossfade_seconds": 0.25,
                        "max_batch_windows": 4}
    jm, params = jax_model_and_params(cfg, seed=8)
    tm = torch_model(cfg, params)
    frames = np.random.default_rng(9).integers(0, 256, (40, 32, 32, 3), dtype=np.uint8)
    chunks, win, hop = TI.split_frames_into_windows(frames, 8, 1.0, 0.5)
    assert chunks.shape[0] == 9 and (win, hop) == (8, 4)
    shape = (4, 8, 50)  # [B, Ca, Fa]
    noises = np.random.default_rng(10).normal(size=(6,) + shape).astype(np.float32)

    j_lat, t_lat = _record_decoder_inputs(monkeypatch, jm, tm)
    j_calls = _noise_patch(monkeypatch, JSC.jax.random, "normal", noises, shape, jnp.asarray)
    j_out = JI.sample_windows_batched(chunks, cfg=cfg, model=jm, params=params,
                                      prompt_modality="video", max_batch=4)
    t_calls = _noise_patch(monkeypatch, TSC.torch, "randn", noises, shape, torch.from_numpy)
    t_out = TI.sample_windows_batched(chunks, cfg=cfg, model=tm, prompt_modality="video",
                                      max_batch=4, device="cpu")
    assert len(j_calls) == len(t_calls) == len(j_lat) == len(t_lat) == 3
    assert t_out.shape == j_out.shape == (9, 8000)
    monkeypatch.undo()
    var = {"params": params}
    for jz, tz in zip(j_lat, t_lat):
        np.testing.assert_allclose(tz, jz, rtol=0, atol=1e-4 * max(1.0, np.abs(jz).max()))
        j_wav = np.asarray(jm.apply(var, jnp.asarray(jz), method=jm.decode_audio))
        with torch.inference_mode():
            t_wav = tm.decode_audio(torch.from_numpy(jz)).numpy()
        np.testing.assert_allclose(t_wav, j_wav, rtol=0, atol=1e-4 * max(1.0, np.abs(j_wav).max()))
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=2e-4 * max(1.0, np.abs(j_out).max()))
    stitched = TI.crossfade_audio(t_out, 8000, 4000, 8000, 0.25)
    assert stitched.shape == ((9 - 1) * 4000 + 8000,)
    _noise_patch(monkeypatch, TSC.torch, "randn", noises, shape, torch.from_numpy)
    again = TI.stream_video_to_audio(frames, cfg=cfg, model=tm, device="cpu")
    np.testing.assert_array_equal(again, stitched)


# ---------------------------------------------------------------------------
# media/audio_io.py, media/video_io.py and eval/
# ---------------------------------------------------------------------------


def _wav(seed, n=8000, sr=8000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (0.4 * np.sin(2 * np.pi * (200 + 50 * seed) * t)
            + 0.05 * rng.normal(size=n)).astype(np.float32)


Y, Z = _wav(1), _wav(2)
MAG = np.abs(np.random.default_rng(3).normal(size=(129, 20))).astype(np.float32)
FRAMES = np.random.default_rng(4).integers(0, 256, (12, 24, 20, 3), dtype=np.uint8)
FRAMES2 = np.clip(FRAMES.astype(np.int16) + np.random.default_rng(5).integers(
    -20, 20, FRAMES.shape), 0, 255).astype(np.uint8)
IMG = np.random.default_rng(6).uniform(0, 1, (24, 20, 3)).astype(np.float32)
IMG2 = np.clip(IMG + 0.05 * np.random.default_rng(7).normal(size=IMG.shape), 0, 1)

CASES = {
    # media/audio_io.py
    "resample": lambda m: m.resample(Y, 8000, 16000),
    "stft_mag": lambda m: m.stft_mag(Y, n_fft=256, hop=64),
    "hz_to_mel": lambda m: m.hz_to_mel(np.linspace(0, 8000, 50)),
    "mel_to_hz": lambda m: m.mel_to_hz(np.linspace(0, 40, 50)),
    "mel_filterbank": lambda m: m.mel_filterbank(8000, 256, 20, 20.0, 3800.0),
    "logmel": lambda m: m.logmel(Y, 8000, n_fft=256, hop=64, n_mels=32),
    "mfcc": lambda m: m.mfcc(Y, 8000, n_mfcc=13, n_fft=256, hop=64, n_mels=32),
    "stft_mag_complex": lambda m: m.stft_mag_complex(Y, 256, 64),
    "istft": lambda m: m.istft(m.stft_mag_complex(Y, 256, 64), 256, 64, length=8000),
    "griffin_lim": lambda m: m.griffin_lim(MAG, n_fft=256, hop=64, n_iter=3, length=19 * 64),
    "mel_to_stft_mag": lambda m: m.mel_to_stft_mag(
        np.exp(m.logmel(Y, 8000, n_fft=256, hop=64, n_mels=32)), 8000, 256, 32),
    "rms_normalize": lambda m: m.rms_normalize(Y, -20.0),
    "rms_normalize_silence": lambda m: m.rms_normalize(np.zeros(10, np.float32)),
}
QUALITY = {
    "snr_like": lambda q: q.snr_like(Y, Z),
    "logmel_default": lambda q: q.logmel_default(Y, 8000),
    "l1_from_logmels": lambda q: q.l1_from_logmels(q.logmel_default(Y, 8000),
                                                   q.logmel_default(Z[:6000], 8000)),
    "logmel_l1": lambda q: q.logmel_l1(Y, Z, 8000),
    "spectral_convergence": lambda q: q.spectral_convergence(Y, Z, 8000),
    "dtw_path": lambda q: q.dtw_path(MAG[:, :12].T, MAG[:, 5:].T),
    "mcd_dtw": lambda q: q.mcd(Y, Z[:7000], 8000),
    "mcd_no_dtw": lambda q: q.mcd(Y, Z, 8000, use_dtw=False),
    "pesq_score": lambda q: q.pesq_score(Y, Z, 8000),
    "stoi_score": lambda q: q.stoi_score(Y, Z, 8000),
}
SYNC = {
    "video_motion_envelope": lambda s: s.video_motion_envelope(FRAMES),
    "video_motion_envelope_flow": lambda s: s.video_motion_envelope(FRAMES[:4], "flow", 3.0),
    "audio_rms_envelope": lambda s: s.audio_rms_envelope(Y, 8000, 8.0),
    "best_lag_and_corr": lambda s: s.best_lag_and_corr(MAG[0], MAG[1], 5),
    "estimate_av_sync": lambda s: s.estimate_av_sync(FRAMES, Y[:6000], 8000, 8.0, 0.5),
}
VIDEO = {
    "to_float01": lambda v: v._to_float01(FRAMES),
    "psnr": lambda v: v.psnr(IMG, IMG2),
    "psnr_equal": lambda v: v.psnr(IMG, IMG),
    "uniform_filter2d": lambda v: v._uniform_filter2d(IMG[..., 0], 7),
    "ssim": lambda v: v.ssim(IMG, IMG2),
    "ssim_gray": lambda v: v.ssim(IMG[..., 0], IMG2[..., 0], win_size=5),
    "temporal_flicker": lambda v: v.temporal_flicker(FRAMES),
    "lpips_pair_absent": lambda v: v._lpips_pair(None, IMG, IMG2),
}
ALL = {**{f"audio_io.{k}": (f, TA, JA) for k, f in CASES.items()},
       **{f"audio_quality.{k}": (f, TQ, JQ) for k, f in QUALITY.items()},
       **{f"av_sync.{k}": (f, TS, JSY) for k, f in SYNC.items()},
       **{f"video_metrics.{k}": (f, TV, JV) for k, f in VIDEO.items()}}


@pytest.mark.parametrize("name", list(ALL))
def test_copied_function_matches_jax(name):
    fn, port, jax_mod = ALL[name]
    got, want = fn(port), fn(jax_mod)
    if want is None:
        assert got is None
        return
    got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, equal_nan=True)


def test_lpips_runs_on_the_device_it_is_asked_for(tmp_path, monkeypatch):
    """LPIPS runs on CUDA unless the caller asks for the CPU, with no CPU
    fallback: without a card, "cuda" raises in _lpips_model, in
    evaluate_video_pair's default and in the CLI's; "cpu" runs (nan without
    the optional lpips package, as the JAX package gives)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    TVIO.write_frames(FRAMES, tmp_path / "a")
    TVIO.write_frames(FRAMES2, tmp_path / "b")
    for call in (lambda: TV._lpips_model("cuda"),
                 lambda: TV.evaluate_video_pair(tmp_path / "a", tmp_path / "b"),
                 lambda: TV.main(["--ref", str(tmp_path / "a"), "--est", str(tmp_path / "b")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    cpu = TV.evaluate_video_pair(tmp_path / "a", tmp_path / "b", lpips_device="cpu")
    assert np.isfinite(cpu["psnr_mean"])
    if TV.lpips_lib is None:
        assert TV._lpips_model("cpu") is None and np.isnan(cpu["lpips_mean"])
    else:
        assert next(TV._lpips_model("cpu").parameters()).device.type == "cpu"


def test_file_entry_points_match_jax(tmp_path):
    """The wav and frame-directory round trips and the file-level
    evaluators (evaluate_pair, evaluate_video_pair / _only, read_video_file)."""
    TA.write_wav(tmp_path / "ref.wav", Y, 8000)
    TA.write_wav(tmp_path / "est.wav", Z, 8000)
    _equal(TA.read_wav(tmp_path / "est.wav", sr=16000), JA.read_wav(tmp_path / "est.wav",
                                                                    sr=16000))
    got = TQ.evaluate_pair(str(tmp_path / "ref.wav"), str(tmp_path / "est.wav"), sr=8000)
    want = JQ.evaluate_pair(str(tmp_path / "ref.wav"), str(tmp_path / "est.wav"), sr=8000)
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k] is None) == (want[k] is None)
        if got[k] is not None:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    TVIO.write_frames(FRAMES, tmp_path / "a", mp4_path=tmp_path / "a.mp4", fps=8)
    JVIO.write_frames(FRAMES2, tmp_path / "b")
    _equal(TVIO.load_frames_dir(tmp_path / "a"), JVIO.load_frames_dir(tmp_path / "a"))
    _equal(TVIO.read_video_file(tmp_path / "a.mp4", (16, 16)),
           JVIO.read_video_file(tmp_path / "a.mp4", (16, 16)))
    for got, want in ((TV.evaluate_video_pair(tmp_path / "a", tmp_path / "b", lpips_device="cpu"),
                       JV.evaluate_video_pair(tmp_path / "a", tmp_path / "b")),
                      (TV.evaluate_video_only(tmp_path / "b"),
                       JV.evaluate_video_only(tmp_path / "b"))):
        assert got.keys() == want.keys()
        np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-6,
                                   equal_nan=True)
