"""The last one-card modules of the port against the JAX package, on the CPU
at small sizes:

* ``parallel.remat_core``: on and off give the same losses and grads (within
  1e-6 of the largest, bit-equal here) on the shrunk flagship with core
  dropout 0.1, the trainer's generator ends in the same state, and the
  flash forward runs twice a layer per step (the recompute), once without a
  graph;
* ``utils/profiling.py``: the FLOP counts and MFU equal the JAX package's,
  the peak by card name, ``calib_tflops`` None off CUDA, a span in a Chrome
  trace;
* ``run_training``'s ``denoiser_mfu`` equal to the JAX loop's formula at the
  logged step time, and with the mouth-crop stream on, at the tokens the
  core runs;
* ``ModalitySchedule`` / ``build_schedules_from_config``, the tokenizers,
  ``FramesDataset`` and ``AudioDataset`` equal to the JAX package's;
* the variational VideoVAE (mu path, given noise, KL, the autoencode) within
  1e-5 of JAX's, both archs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import (native_loaders, perturb, shrunk_cfg,  # noqa: F401 (a fixture)
                           shrunk_flagship_cfg)
from multimodal_diffusion_torch.datasets import audio_dataset as TAD
from multimodal_diffusion_torch.datasets import frames_dataset as TFD
from multimodal_diffusion_torch.models import schedules as TSch
from multimodal_diffusion_torch.models import tokenizers as TTok
from multimodal_diffusion_torch.models import vae_video3d as TV
from multimodal_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
from multimodal_diffusion_torch.ops import flash_attention as t_fa
from multimodal_diffusion_torch.ops.attention import attention_path
from multimodal_diffusion_torch.train import trainer as TT
from multimodal_diffusion_torch.utils import profiling as TP
from multimodal_diffusion_torch.utils.convert import load_jax_params
from multimodal_diffusion_tpu.datasets import audio_dataset as JAD
from multimodal_diffusion_tpu.datasets import frames_dataset as JFD
from multimodal_diffusion_tpu.media.audio_io import write_wav
from multimodal_diffusion_tpu.models import schedules as JSch
from multimodal_diffusion_tpu.models import tokenizers as JTok
from multimodal_diffusion_tpu.models import vae_video3d as JV
from multimodal_diffusion_tpu.ops.tokenize import num_chunks as j_num_chunks
from multimodal_diffusion_tpu.train.trainer import latent_shapes_from_config
from multimodal_diffusion_tpu.utils import profiling as JP


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# parallel.remat_core
# ---------------------------------------------------------------------------


def _flagship_with_dropout(remat: bool):
    cfg = shrunk_flagship_cfg()
    cfg["model"]["core"]["dropout"] = 0.1
    cfg["parallel"] = {"remat_core": remat}
    return cfg


def _batch(shapes, seed=0):
    rng = np.random.default_rng(seed)
    B = shapes["video"][0]
    return {"video": rng.uniform(0, 1, shapes["video"]).astype(np.float32),
            "audio": rng.uniform(-1, 1, shapes["audio"]).astype(np.float32),
            "has_video": np.ones(B, bool), "has_audio": np.ones(B, bool)}


@pytest.fixture
def count_forwards(monkeypatch):
    """Counts the flash forward's calls (its plain version on the CPU)."""
    calls = [0]
    real = t_fa.flash_forward_reference

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    monkeypatch.setattr(t_fa, "flash_forward_reference", counted)
    return calls


def _remat_run(remat: bool, calls):
    """One decode step's loss and grads under the trainer's own draws and
    dropout masks, then two train steps: (loss, grads, forward calls of the
    gradient pass, the generator's state after it, the steps' metrics, the
    parameters after them, the generator's state after them)."""
    cfg = _flagship_with_dropout(remat)
    with attention_path("kernel"):
        bundle = TT.create_trainer(cfg, device="cpu", batch_size=2)
        assert bundle.model.core.cfg.remat is remat and bundle.model.core.cfg.dropout == 0.1
        batch = _batch(bundle.latent_shapes)
        model, sc = bundle.model.train(), bundle.step_config
        named = list(model.named_parameters())
        calls[0] = 0
        draws = TT.draw_step_randomness(bundle.state.generator, sc)
        loss, _ = TT.train_loss(model, sc, bundle.abar_v, bundle.abar_a,
                                TT.batch_to_device(batch, bundle.device), 0.0, draws, True)
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        n_calls, gen_state = calls[0], bundle.state.generator.get_state()
        metrics = [bundle.train_step(bundle.state, batch, t) for t in (0.0, 1.0)]
    after = {n: p.detach().clone() for n, p in named}
    return (loss.detach(), dict(zip([n for n, _ in named], grads)), n_calls, gen_state,
            metrics, after, bundle.state.generator.get_state())


def test_remat_core_gives_the_same_losses_grads_and_draws(count_forwards):
    """Dropout 0.1 in every block: the recompute redraws the forward's masks
    from the saved generator state and hands the generator back as it found
    it, so grads, the steps after and the generator all agree; the forward
    runs once more per layer in the backward pass."""
    off = _remat_run(False, count_forwards)
    on = _remat_run(True, count_forwards)
    n_layers = shrunk_flagship_cfg()["model"]["core"]["n_layers"]
    assert (off[2], on[2]) == (n_layers, 2 * n_layers)
    assert float(on[0]) == float(off[0])
    top = max(float(g.abs().max()) for g in off[1].values() if g is not None)
    for name, g in off[1].items():
        if g is None:
            assert on[1][name] is None, name
            continue
        assert float((on[1][name] - g).abs().max()) <= 1e-6 * top, name
    assert torch.equal(on[3], off[3]) and torch.equal(on[6], off[6])
    for m_on, m_off in zip(on[4], off[4]):
        for k in m_off:
            assert float(m_on[k]) == float(m_off[k]), k
    for name, p in off[5].items():
        assert float((on[5][name] - p).abs().max()) <= 1e-6 * max(1.0, float(p.abs().max())), \
            name


def test_remat_changes_nothing_without_a_graph(count_forwards):
    """Eval mode, or no grad: one forward a layer, the same output."""
    outs = {}
    for remat in (False, True):
        bundle = TT.create_trainer(_flagship_with_dropout(remat), device="cpu", batch_size=2)
        core = bundle.model.core
        x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 12, 64))
                             .astype(np.float32))
        count_forwards[0] = 0
        with attention_path("kernel"):
            with torch.no_grad():
                a = core.train()(x)  # dropout on, no graph
            gen = bundle.state.generator.get_state()
            b = core.eval()(x.requires_grad_())  # graph, eval mode
        assert count_forwards[0] == 2 * core.cfg.n_layers
        outs[remat] = (a, b.detach(), gen)
    assert all(torch.equal(p, q) for p, q in zip(outs[True], outs[False]))


def test_remat_recompute_keeps_the_forward_path_after_its_scope(count_forwards):
    """The kernel path forced around the forward only: backward() runs after
    the scope has closed, and the recompute still takes the kernels' plain
    versions (one more forward a layer), so every gradient is the bits of
    the same step without remat."""
    grads, calls = {}, {}
    for remat in (False, True):
        torch.manual_seed(0)
        net = MMDiT(MMDiTConfig(d_model=64, n_layers=2, n_heads=2, dropout=0.0,
                                remat=remat)).train()
        x = torch.randn((2, 12, 64), generator=torch.Generator().manual_seed(1),
                        requires_grad=True)
        count_forwards[0] = 0
        with attention_path("kernel"):
            loss = net(x).square().mean()
        loss.backward()
        calls[remat] = count_forwards[0]
        grads[remat] = [x.grad] + [p.grad for p in net.parameters()]
    assert (calls[False], calls[True]) == (2, 4)
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))


# ---------------------------------------------------------------------------
# utils/profiling.py and the trainer's MFU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(421, 1024, 16, 4.0), (133, 512, 8, 4.0), (64, 384, 12, 4.0),
                                  (37, 96, 3, 2.5)])
def test_flop_counts_and_mfu_equal_jax(args):
    assert TP.flops_mmdit_forward(*args) == JP.flops_mmdit_forward(*args)
    for dual in (True, False):
        assert TP.flops_denoiser_step(8, *args, cfg_dual=dual) == \
            JP.flops_denoiser_step(8, *args, cfg_dual=dual)
    rate = 3.0 * 8 * TP.flops_mmdit_forward(*args) / 0.1
    assert TP.mfu(rate) == JP.mfu(rate)  # both the CPU's entry here
    assert TP.device_peak_flops() == JP.device_peak_flops() == TP.PEAK_FLOPS["cpu"]


def test_profiling_without_a_card(tmp_path):
    """No calibration or memory figures off CUDA; a span opened under
    torch.profiler is a range of the exported Chrome trace."""
    assert TP.calib_tflops() is None and JP.calib_tflops() is None
    assert TP.device_memory_stats() is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with TP.span("a_range"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "a_range" for e in trace["traceEvents"])


def test_device_peak_flops_by_card_name(monkeypatch):
    """The H100 SXM's dense bf16 989 TFLOP/s by name; a card it does not
    know raises rather than reading the CPU's figure; a CPU device reads the
    CPU's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert TP.device_peak_flops() == 989e12
    assert TP.mfu(989e12 / 4) == 0.25
    assert TP.device_peak_flops("cpu") == 5e10
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA Made Up")
    with pytest.raises(KeyError, match="Made Up"):
        TP.device_peak_flops()


def test_run_training_logs_the_jax_denoiser_mfu():
    """denoiser_mfu = mfu(3 B flops_mmdit_forward(nv + na) / dt) with the JAX
    package's functions and token counts at the logged step time; no
    vs-calib figure off CUDA (calib_tflops is None, as in the JAX loop)."""
    cfg = shrunk_cfg()
    cfg["training"]["log_every"] = 1
    bundle = TT.create_trainer(cfg, device="cpu")
    logs = []
    TT.run_training(cfg, bundle, iter([_batch(bundle.latent_shapes)] * 2),
                    log_fn=lambda step, m: logs.append(m), max_steps=2)
    assert len(logs) == 2
    B = int(cfg["data"]["batch_size"])
    s = latent_shapes_from_config(cfg, B)
    tube, chunk = cfg["tokenizer"]["video"]["tube"], cfg["tokenizer"]["audio"]["chunk"]
    nv = (s["z_video"][2] // tube["t"]) * (s["z_video"][3] // tube["h"]) * \
        (s["z_video"][4] // tube["w"])
    na = j_num_chunks(s["z_audio"][2], chunk["length"], chunk["stride"])
    core = cfg["model"]["core"]
    flops = 3.0 * B * JP.flops_mmdit_forward(nv + na, core["d_model"], core["n_layers"],
                                             core["mlp_ratio"])
    for m in logs:
        want = JP.mfu(flops / (1.0 / m["steps_per_sec"]))
        np.testing.assert_allclose(m["denoiser_mfu"], want, rtol=1e-9)
        assert "denoiser_mfu_vs_calib" not in m


def test_run_training_mfu_counts_the_mouth_tokens():
    """With the mouth-crop stream on, denoiser_mfu counts the tokens the core
    runs, nv + na + nm (the JAX loop's formula leaves out nm; ROADMAP.md's
    notes): at the shrunk flagship 48 mouth tokens, a 12 x 16 box in 4 x 8
    tubes over 8 frames; tools/bench.py's train line counts the same."""
    cfg = shrunk_flagship_cfg()
    cfg["training"]["log_every"] = 1
    bundle = TT.create_trainer(cfg, device="cpu")
    logs = []
    TT.run_training(cfg, bundle, iter([_batch(bundle.latent_shapes)] * 2),
                    log_fn=lambda step, m: logs.append(m), max_steps=2)
    B = int(cfg["data"]["batch_size"])
    s = latent_shapes_from_config(cfg, B)
    tube, chunk = cfg["tokenizer"]["video"]["tube"], cfg["tokenizer"]["audio"]["chunk"]
    nv = (s["z_video"][2] // tube["t"]) * (s["z_video"][3] // tube["h"]) * \
        (s["z_video"][4] // tube["w"])
    na = j_num_chunks(s["z_audio"][2], chunk["length"], chunk["stride"])
    mouth = cfg["conditioning"]["mouth_crop"]
    h0, h1, w0, w1 = mouth["box"]
    nm = (s["video"][2] // mouth["tube"]["t"]) * ((h1 - h0) // mouth["tube"]["h"]) * \
        ((w1 - w0) // mouth["tube"]["w"])
    assert nm == 48
    assert TP.denoiser_tokens(bundle.model, s) == nv + na + nm
    core = cfg["model"]["core"]
    flops = 3.0 * B * JP.flops_mmdit_forward(nv + na + nm, core["d_model"], core["n_layers"],
                                             core["mlp_ratio"])
    assert TP.denoiser_train_flops(bundle.model, s) == flops
    assert len(logs) == 2
    for m in logs:
        np.testing.assert_allclose(m["denoiser_mfu"], JP.mfu(flops * m["steps_per_sec"]),
                                   rtol=1e-9)


# ---------------------------------------------------------------------------
# schedules, tokenizers, datasets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["cosine", "linear", "sigmoid"])
def test_modality_schedule_equals_jax(kind):
    j = JSch.ModalitySchedule.make(kind=kind, steps=50, min_beta=2e-4, max_beta=3e-2)
    t = TSch.ModalitySchedule.make(kind=kind, steps=50, min_beta=2e-4, max_beta=3e-2)
    assert (t.kind, t.steps) == (j.kind, j.steps)
    for f in ("betas", "alphas", "alphas_cumprod"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    np.testing.assert_array_equal(t.make_sampling_schedule(7), j.make_sampling_schedule(7))
    rng = np.random.default_rng(0)
    z0, noise, eps = (rng.normal(size=(2, 3, 4)).astype(np.float32) for _ in range(3))
    tt, tp = np.array([49, 10]), np.array([30, -1])
    jz, jn = j.q_sample(jnp.asarray(z0), jnp.asarray(tt), jnp.asarray(noise))
    tz, tn = t.q_sample(_t(z0), _t(tt), _t(noise))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for eta in (0.0, 0.5):
        want = j.ddim_step(jnp.asarray(z0), jnp.asarray(tt), jnp.asarray(tp), jnp.asarray(eps),
                           eta=eta, noise=jnp.asarray(noise))
        got = t.ddim_step(_t(z0), _t(tt), _t(tp), _t(eps), eta=eta, noise=_t(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.timestep_embedding(_t(tt), 16).numpy(),
                               np.asarray(j.timestep_embedding(jnp.asarray(tt), 16)),
                               rtol=1e-6, atol=1e-6)
    drawn, _ = t.q_sample(_t(z0), _t(tt), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == z0.shape and not torch.equal(drawn, tz)
    with pytest.raises(ValueError):
        t.q_sample(_t(z0), _t(tt))


def test_build_schedules_from_config_equals_jax():
    cfg = shrunk_flagship_cfg()
    j, t = JSch.build_schedules_from_config(cfg), TSch.build_schedules_from_config(cfg)
    assert set(t) == set(j) == {"video", "audio"}
    for mod in t:
        np.testing.assert_array_equal(t[mod].alphas_cumprod, j[mod].alphas_cumprod)


def test_tokenizers_equal_jax():
    rng = np.random.default_rng(3)
    z = rng.normal(size=(2, 8, 4, 6, 6)).astype(np.float32)
    jv, tv = JTok.VideoTokenizer(8, 2, 3, 3), TTok.VideoTokenizer(8, 2, 3, 3)
    assert tv.token_dim == jv.token_dim == 144
    tok = tv.encode(_t(z))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jv.encode(jnp.asarray(z))))
    np.testing.assert_array_equal(tv.decode(tok, 4, 6, 6).numpy(), z)
    za = rng.normal(size=(2, 8, 150)).astype(np.float32)
    for length, stride in ((4, 4), (8, 4)):
        ja, ta = JTok.AudioTokenizer(8, length, stride), TTok.AudioTokenizer(8, length, stride)
        assert (ta.token_dim, ta.num_tokens(150)) == (ja.token_dim, ja.num_tokens(150))
        tok = ta.encode(_t(za))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ja.encode(jnp.asarray(za))))
        np.testing.assert_allclose(ta.decode(tok, 150).numpy(),
                                   np.asarray(ja.decode(jnp.asarray(tok.numpy()), 150)),
                                   rtol=1e-6, atol=1e-6)


def _equal_items(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def frame_clips(tmp_path_factory):
    """Three clip directories of 5, 7 and 3 JPEG frames (20x16), and a
    manifest of two of them."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(4)
    for i, n in enumerate((5, 7, 3)):
        d = root / f"clip_{i:03d}"
        d.mkdir()
        for t in range(n):
            Image.fromarray(rng.integers(0, 256, (16, 20, 3), dtype=np.uint8)).save(
                d / f"frame_{t:06d}.jpg")
    manifest = root / "clips.json"
    manifest.write_text(json.dumps({"clips": [
        {"video_frames_dir": str(root / "clip_001"), "audio_wav_path": ""},
        {"video_frames_dir": str(root / "clip_002"), "audio_wav_path": ""}]}))
    return root, manifest


@pytest.mark.parametrize("source", ["dir", "manifest"])
@pytest.mark.parametrize("device_preprocess", [False, True])
def test_frames_dataset_equals_jax(frame_clips, source, device_preprocess, native_loaders):
    """Clips of 6 frames at 16x16 (fewer frames repeat the last; 20x16
    frames are resized) from a directory of clip_* folders or a manifest
    (which takes AVManifestDataset's float layout either way); both
    packages' native decoders whole first (``native_loaders``)."""
    root, manifest = frame_clips
    src = root if source == "dir" else manifest
    kw = dict(clip_seconds=1.5, fps=4, size_hw=(16, 16), device_preprocess=device_preprocess)
    j, t = JFD.FramesDataset(src, **kw), TFD.FramesDataset(src, **kw)
    assert len(t) == len(j) == (3 if source == "dir" else 2) and t.T == j.T == 6
    for i in range(len(t)):
        _equal_items(t[i], j[i])
    with pytest.raises(FileNotFoundError):
        TFD.FramesDataset(_empty_dir(root), **kw)


def _empty_dir(root):
    d = root / "empty"
    d.mkdir(exist_ok=True)
    return d


@pytest.mark.parametrize("source", ["dir", "manifest"])
def test_audio_dataset_equals_jax(tmp_path, source):
    """Wavs shorter and longer than the clip, at the dataset's rate and at
    another (resampled), stereo averaged to mono."""
    rng = np.random.default_rng(5)
    files = []
    for i, (n, sr, ch) in enumerate(((6000, 8000, 1), (12000, 8000, 1), (9000, 16000, 2))):
        wav = rng.uniform(-0.5, 0.5, (n, ch) if ch > 1 else n).astype(np.float32)
        files.append(tmp_path / "wav" / f"a_{i}.wav")
        write_wav(files[-1], wav, sr)
    src = tmp_path / "wav"
    if source == "manifest":
        src = tmp_path / "clips.json"
        src.write_text(json.dumps({"clips": [{"audio_wav_path": str(f)} for f in files]}))
    j = JAD.AudioDataset(src, clip_seconds=1.0, sr=8000)
    t = TAD.AudioDataset(src, clip_seconds=1.0, sr=8000)
    assert len(t) == len(j) == 3 and t.L == j.L == 8000
    for i in range(3):
        _equal_items(t[i], j[i])
        assert t[i]["audio"].shape == (1, 8000) and t[i]["video"] is None
    with pytest.raises(FileNotFoundError):
        TAD.AudioDataset(_empty_dir(tmp_path))


# ---------------------------------------------------------------------------
# the variational VideoVAE
# ---------------------------------------------------------------------------


def _vae_cfg(arch: str) -> dict:
    return {"in_ch": 3, "variational": True, "arch": arch,
            "latent": {"channels": 4, "t_down": 2, "s_down": 4},
            "encoder": {"base": 8, "blocks": 1, "hidden": 16}, "decoder": {"base": 8, "blocks": 1}}


@pytest.mark.parametrize("arch", ["conv", "patch"])
def test_variational_video_vae_matches_jax(arch):
    """mu (no rng / no noise), mu + eps exp(logv / 2) with JAX's own eps,
    the fp32 KL mean and the full autoencode, within 1e-5; to_mu and
    to_logv carried by the converter."""
    jc = JV.VideoVAEConfig.from_dict(_vae_cfg(arch))
    jm = JV.VideoVAE(jc)
    x = np.random.default_rng(6).uniform(0, 1, (2, 3, 4, 8, 8)).astype(np.float32)
    params = perturb(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"], 7)
    tm = load_jax_params(TV.VideoVAE(TV.VideoVAEConfig.from_dict(_vae_cfg(arch))), params)
    assert {"to_mu.weight", "to_logv.bias"} <= set(tm.state_dict())
    key = jax.random.PRNGKey(3)
    j_mu, j_kld = jm.apply({"params": params}, jnp.asarray(x), method=jm.encode_with_kld)
    j_z, j_kld2 = jm.apply({"params": params}, jnp.asarray(x), key, method=jm.encode_with_kld)
    j_xhat, j_z3, j_kld3 = jm.apply({"params": params}, jnp.asarray(x), key)
    eps = np.asarray(jax.random.normal(key, np.asarray(j_mu).transpose(0, 2, 3, 4, 1).shape,
                                       jnp.float32)).transpose(0, 4, 1, 2, 3)
    with torch.no_grad():
        mu, kld = tm.encode_with_kld(_t(x))
        z, kld2 = tm.encode_with_kld(_t(x), noise=_t(eps))
        xhat, z3, kld3 = tm(_t(x), noise=_t(eps))
        drawn = tm.encode(_t(x), generator=torch.Generator().manual_seed(0))
    for got, want in ((mu, j_mu), (z, j_z), (z3, j_z3), (xhat, j_xhat)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for got, want in ((kld, j_kld), (kld2, j_kld2), (kld3, j_kld3)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert not torch.equal(z, mu) and not torch.equal(drawn, mu) and drawn.shape == mu.shape


def test_variational_vae_weights_carry_both_ways_in_the_av_model():
    """The shrunk mvp config with video.variational: every JAX leaf, to_mu
    and to_logv among them, to the port and back bit for bit."""
    from _torch_parity import jax_model_and_params
    from multimodal_diffusion_torch.models.diffusion import (AVDiffusionConfig,
                                                             AVDiffusionModel)
    from multimodal_diffusion_torch.utils.convert import (_leaves, jax_params_to_state_dict,
                                                          state_dict_to_jax_params)

    cfg = shrunk_cfg()
    cfg["video"]["variational"] = True
    _, params = jax_model_and_params(cfg)
    leaves = dict(_leaves(params))
    sd = jax_params_to_state_dict(params)
    assert {"vid_vae.to_mu.weight", "vid_vae.to_logv.bias"} <= set(sd)
    assert not any(k.startswith("vid_vae.to_lat") for k in sd)
    model = AVDiffusionModel(AVDiffusionConfig.from_config(cfg))
    model.load_state_dict(sd, strict=True)
    back = dict(_leaves(state_dict_to_jax_params(model.state_dict())))
    assert back.keys() == leaves.keys()
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg="/".join(k))
