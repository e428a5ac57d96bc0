"""The port's benchmark (multimodal_diffusion_torch/tools/bench.py) against
the repo root's bench.py, on the CPU at the shrunk configs:

* each task's JSON line has bench.py's keys, in bench.py's order (read from
  bench.py's own source), and a ``_cpu`` metric;
* the av pipeline (v2a and a2v, mvp and the flagship's options, whose v2a
  sampler gets no mouth tokens as bench.py gives none) on JAX weights
  converted with utils/convert.py and the same noise equals the JAX
  package's encode -> sampler_from_config -> decode: the sampled latents
  within 1e-4 of their magnitude, the decoded waveforms or frames within
  1e-4;
* the t2i pipeline at bench.py's widths (image size 64) equals the JAX
  package's make_t2i_sampler + decode_image under the same tolerances;
* the train task's blend of the decode step and the step without it.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.core import meta

import chip_smoke
from _torch_parity import jax_model_and_params, shrunk_cfg, shrunk_flagship_cfg, t2n
from multimodal_diffusion_torch.tools import bench as TB
from multimodal_diffusion_tpu.infer.ddim import sampler_from_config as jax_sampler_from_config
from multimodal_diffusion_tpu.models import latent_text2image as JL
from multimodal_diffusion_tpu.models.diffusion import AVDiffusionConfig, AVDiffusionModel
from multimodal_diffusion_tpu.models.mmdit import MMDiTConfig as JMMDiTConfig
from multimodal_diffusion_tpu.models.text_encoder import TextEncoderConfig, tokenize_text
from multimodal_diffusion_tpu.models.vae_image2d import ImageVAEConfig
from multimodal_diffusion_tpu.ops import schedule as JS
from multimodal_diffusion_tpu.train.trainer import latent_shapes_from_config

REPO = Path(__file__).resolve().parents[1]
AV_KEYS = ["metric", "value", "unit", "vs_baseline", "best_batch_latency_s",
           "p50_batch_latency_s", "p50_clips_per_sec", "spread_s", "calib_tflops"]
TRAIN_KEYS = ["metric", "value", "unit", "vs_baseline", "step_ms", "denoiser_mfu_est",
              "calib_tflops"]
RECON_KEYS = ["recon_step_ms", "norecon_step_ms", "recon_every"]
T2I_KEYS = ["metric", "value", "unit", "vs_baseline", "spread_s", "calib_tflops"]
SHORT = ["--cpu", "--steps", "2", "--repeats", "1", "--inner", "1", "--batch", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier runs six workers on a shared host, and
    torch's default of one thread per core oversubscribes it many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench_py_keys(func: str) -> list:
    """The keys of the dict that bench.py's `func` prints (json.dumps of a
    dict literal; a ``**extra`` spread contributes the keys of the dict
    literal assigned to ``extra`` in that function)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func)
    extra = []
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "extra" for t in node.targets)
                and node.value.keys):
            extra = [k.value for k in node.value.keys]
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps"):
            keys = []
            for k in node.args[0].keys:
                keys += [k.value] if k is not None else extra
            return keys
    raise AssertionError(f"no json.dumps in bench.py::{func}")


def test_key_lists_are_bench_pys():
    assert _bench_py_keys("main") == AV_KEYS
    assert _bench_py_keys("bench_train") == TRAIN_KEYS + RECON_KEYS
    assert _bench_py_keys("bench_t2i") == T2I_KEYS
    # the lists chip_smoke.py gates the card's lines on
    assert chip_smoke.BENCH_KEYS == {"av": AV_KEYS, "t2i": T2I_KEYS, "train": TRAIN_KEYS}
    assert chip_smoke.BENCH_RECON_KEYS == RECON_KEYS


def _config_file(tmp_path, cfg, name="cfg.yaml") -> str:
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _line(capsys) -> dict:
    import json

    out = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(out) == 1, out
    return json.loads(out[0])


@pytest.mark.parametrize("task,extra,keys", [
    ("av", [], AV_KEYS),
    ("av", ["--direction", "a2v"], AV_KEYS),
    ("t2i", ["--image-size", "64"], T2I_KEYS),
    ("train", [], TRAIN_KEYS),
], ids=["v2a", "a2v", "t2i", "train"])
def test_main_prints_bench_py_keys(tmp_path, capsys, task, extra, keys):
    argv = ["--task", task, *extra, *SHORT]
    if task != "t2i":
        argv += ["--config", _config_file(tmp_path, shrunk_cfg())]
    run = TB.main(argv)
    line = _line(capsys)
    assert list(line) == keys
    assert line == run.line
    assert line["metric"].endswith("_cpu")
    assert line["calib_tflops"] is None
    assert run.finite
    if task == "av":
        assert line["metric"].startswith(f"{extra[1] if extra else 'v2a'}_clips_per_sec_2step")
        assert line["value"] == pytest.approx(2 / line["best_batch_latency_s"], rel=1e-3)
        assert run.calls == 2 + 1 * 1
        assert run.tokens == run.padded_tokens == num_video_tokens(shrunk_cfg()) \
            + num_audio_tokens(shrunk_cfg())
    if task == "t2i":
        assert line["metric"] == "t2i64_images_per_sec_2step_cfg_b2_cpu"
        assert (run.tokens, run.padded_tokens) == (77 + 16, 128)


def num_video_tokens(cfg) -> int:
    _, _, T, H, W = latent_shapes_from_config(cfg, 1)["z_video"]
    tube = cfg["tokenizer"]["video"]["tube"]
    return (T // int(tube["t"])) * (H // int(tube["h"])) * (W // int(tube["w"]))


def num_audio_tokens(cfg) -> int:
    ch = cfg["tokenizer"]["audio"]["chunk"]
    return (int(cfg["audio"]["latent"]["frames_per_clip"]) - int(ch["length"])) \
        // int(ch["stride"]) + 1


def test_serving_sets_bench_pys_levers():
    args = TB.parse_args(["--task", "t2i", "--serving", "--steps", "50"])
    assert (args.sampler, args.steps, args.quant) == ("dpmpp_2m", 12, "int8")
    args = TB.parse_args([])
    assert (args.task, args.batch, args.steps, args.repeats, args.inner, args.direction,
            args.image_size, args.config, args.cpu, args.quant, args.sampler) == (
        "av", 8, 50, 7, 3, "v2a", 512, None, False, "none", "ddim")
    c = TB.t2i_config(512)
    assert (c.text.max_len + c.n_img_tokens, c.core.n_layers, c.core.n_heads,
            c.core.seq_multiple, c.text.core.n_layers) == (1101, 8, 4, 128, 4)


def _close(got: np.ndarray, want: np.ndarray, tol: float = 1e-4) -> None:
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(float(np.max(np.abs(want))), 1e-30), (err, float(np.max(np.abs(want))))


def _jax_av(cfg, params, direction, video, audio, z_init):
    model = AVDiffusionModel(AVDiffusionConfig.from_config(cfg, dtype=jnp.float32))
    target = "audio" if direction == "v2a" else "video"
    sample, _ = jax_sampler_from_config(model, cfg, target=target)

    @jax.jit
    def pipeline(params, video, audio, z_init):
        var = {"params": params}
        key = jax.random.PRNGKey(0)
        if target == "audio":
            z = sample(params, model.apply(var, video, method=model.encode_video), z_init, key)
            return z, model.apply(var, z, method=model.decode_audio)
        z = sample(params, model.apply(var, audio, method=model.encode_audio), z_init, key)
        return z, model.apply(var, z, method=model.decode_video)

    z, out = pipeline(params, jnp.asarray(video), jnp.asarray(audio), jnp.asarray(z_init))
    return np.asarray(z), np.asarray(out)


@pytest.mark.parametrize("make_cfg,direction", [
    (shrunk_cfg, "v2a"), (shrunk_cfg, "a2v"), (shrunk_flagship_cfg, "v2a"),
], ids=["mvp-v2a", "mvp-a2v", "flagship-v2a"])
def test_av_pipeline_matches_jax(make_cfg, direction):
    cfg = make_cfg(sampler_steps=3)
    _, params = jax_model_and_params(cfg, seed=1, jit=True)
    B = 2
    s = latent_shapes_from_config(cfg, B)
    rng = np.random.default_rng(3)
    video = rng.uniform(0, 1, s["video"]).astype(np.float32)
    audio = rng.uniform(-1, 1, s["audio"]).astype(np.float32)
    z_init = rng.normal(size=s["z_audio" if direction == "v2a" else "z_video"]).astype(
        np.float32)
    j_z, j_out = _jax_av(cfg, params, direction, video, audio, z_init)
    model, pipeline = TB.build_av_pipeline(cfg, direction, B, "cpu", params)
    z, out = pipeline(torch.from_numpy(video), torch.from_numpy(audio),
                      torch.from_numpy(z_init))
    assert out.dtype == torch.float32 and out.shape == j_out.shape
    _close(t2n(z), j_z)
    _close(t2n(out), j_out)
    if make_cfg is shrunk_flagship_cfg:
        # the mouth stream is in the sequence, zeroed: 48 of its tokens
        n, _ = TB.av_tokens(model, cfg)
        assert model.cfg.mouth_enabled
        assert n == num_video_tokens(cfg) + num_audio_tokens(cfg) + 48


def _jax_t2i_params(model, image_size: int, B: int):
    """bench.py's benchmark-speed weights: the init's shapes (eval_shape,
    no compute), every leaf N(0, 0.02) from np.random.default_rng(0)."""
    c = model.cfg
    lat = (B, c.vae.lat_ch, c.latent_hw, c.latent_hw)
    _, abar = JS.alphas_cumprod_from_betas(JS.make_beta_schedule(c.steps))
    abstract = meta.unbox(jax.eval_shape(
        lambda r: model.init({"params": r}, jnp.zeros((B, 3, image_size, image_size)),
                             jnp.asarray(tokenize_text(["x"] * B, 77)),
                             jnp.zeros((B,), jnp.int32), jnp.zeros(lat), jnp.asarray(abar)),
        jax.random.PRNGKey(0))["params"])
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.02, s.shape).astype(np.float32), abstract)


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp_2m"])
def test_t2i_pipeline_matches_jax(sampler):
    size, B, steps = 64, 2, 2
    model = JL.Text2ImageModel(JL.Text2ImageConfig(
        image_size=size, patch=2, width=512,
        vae=ImageVAEConfig(lat_ch=4, down=8, base=64, max_ch=256),
        text=TextEncoderConfig(width=256, max_len=77, core=JMMDiTConfig(
            d_model=256, n_layers=4, n_heads=4, dropout=0.0)),
        core=JMMDiTConfig(d_model=512, n_layers=8, n_heads=4, dropout=0.0, seq_multiple=128)))
    params = _jax_t2i_params(model, size, B)
    ids = tokenize_text([TB.T2I_PROMPT] * B, 77)
    neg = tokenize_text([TB.T2I_NEGATIVE] * B, 77)
    sample = JL.make_t2i_sampler(model, sampler_steps=steps, guidance_scale=5.0,
                                 sampler=sampler)
    key = jax.random.PRNGKey(5)

    @jax.jit
    def pipeline(params, ids, neg, key):
        z = sample(params, ids, neg, key)
        return z, model.apply({"params": params}, z, method=model.decode_image)

    j_z, j_img = (np.asarray(x) for x in pipeline(params, jnp.asarray(ids), jnp.asarray(neg),
                                                  key))
    # the JAX sampler's initial noise: the first split of its key
    z0 = np.asarray(jax.random.normal(jax.random.split(key)[1], j_z.shape, jnp.float32))
    tm, t_pipeline = TB.build_t2i_pipeline(size, "none", sampler, steps, "cpu", params)
    assert tm.cfg.core.n_layers == 8
    z, img = t_pipeline(torch.from_numpy(ids), torch.from_numpy(neg), torch.from_numpy(z0.copy()))
    _close(t2n(z), j_z)
    _close(t2n(img), j_img)


def test_train_blends_decode_and_plain_steps(tmp_path, capsys):
    cfg = shrunk_flagship_cfg()
    K = cfg["training"]["recon_every"]
    assert K > 1
    run = TB.main(["--task", "train", "--config", _config_file(tmp_path, cfg), *SHORT])
    line = _line(capsys)
    assert list(line) == TRAIN_KEYS + RECON_KEYS
    assert line["recon_every"] == K
    blend = (line["recon_step_ms"] + (K - 1) * line["norecon_step_ms"]) / K
    assert line["step_ms"] == pytest.approx(blend, abs=0.01)
    assert line["value"] == pytest.approx(2 / (line["step_ms"] / 1e3), rel=1e-3)
    # 2 warm-ups and 5 decode steps, then 1 warm-up and 5 steps without it
    assert run.calls == 2 + 5 + 1 + 5 and run.finite
    # the two step functions: the decode on every call, and never
    bundle, batch, steps = TB.build_train_bench(cfg, 2, "cpu")
    assert set(steps) == {"recon", "norecon"}
    for _ in range(2):
        assert float(steps["recon"](bundle.state, batch, 1.0)["loss_recon"]) > 0.0
        assert float(steps["norecon"](bundle.state, batch, 1.0)["loss_recon"]) == 0.0
    bundle, _, steps = TB.build_train_bench(shrunk_cfg(), 2, "cpu")
    assert set(steps) == {"recon"} and steps["recon"] is bundle.train_step
