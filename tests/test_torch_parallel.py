"""The port's mesh, sharding, data and tensor parallelism, batch-sharded
sampling and the multi-process train_joint CLI, on world-2 gloo groups of
spawned CPU processes (``parallel/launch.py``; the rank bodies are in
``tests/_torch_dist.py``), held against the JAX package on a 2-device
sub-mesh of its 8 virtual CPU devices and against the port's one-process
run, at the shrunk mvp config, fp32:

  * ranks take the coordinates JAX's make_mesh gives devices, and the same
    layouts raise;
  * shard_batch, the tensor-parallel axes of every core parameter against
    infer_param_shardings, and the state_dict cuts of utils/convert.py;
  * one train step under parallel.data 2 and under parallel.model 2: the
    loss within 1e-5 relative of JAX's layout and of one process, every
    gradient within 2e-4 of its largest magnitude, the parameters after the
    AdamW step within 1e-6 of one process's AdamW on those gradients and
    bit-equal across the ranks; with core dropout 0.1 the one-process
    masks (the losses within 1e-5 relative);
  * v2a sampling with the batch over 'data': the sampler's latents against
    JAX's batch-sharded sampler, and sample_one_direction against one
    process (the JAX test's tolerances);
  * train_joint under WORLD_SIZE 2 (data 2): the lead rank's checkpoint
    loads in one process and equals every rank's parameters;
  * run_training on a card with no peak figure logs denoiser_mfu as nan.
"""

import copy
import warnings

import jax
import numpy as np
import pytest
import torch
import yaml

import _torch_dist as D
from _torch_parity import (jax_layout_loss_and_grads, jax_model_and_params, shrunk_cfg)
from multimodal_diffusion_torch.parallel import mesh as TMesh
from multimodal_diffusion_torch.parallel import sharding as TSh
from multimodal_diffusion_torch.parallel.launch import run_ranks
from multimodal_diffusion_torch.train import trainer as TT
from multimodal_diffusion_torch.utils import convert as TC
from multimodal_diffusion_torch.utils.convert import jax_params_to_state_dict
from multimodal_diffusion_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_diffusion_tpu.train.trainer import latent_shapes_from_config

B = 4
LAYOUTS = {"data": {"data": 2}, "model": {"data": 1, "model": 2}}


def _cfg(dropout=0.0):
    cfg = shrunk_cfg(sampler_steps=2)
    cfg["training"]["scheduler"] = {"name": "none"}  # the step moves every parameter
    cfg["model"]["core"]["dropout"] = dropout
    return cfg


def _inputs(cfg):
    s = latent_shapes_from_config(cfg, B)
    rng = np.random.default_rng(0)
    batch = {"video": rng.uniform(0, 1, s["video"]).astype(np.float32),
             "audio": rng.uniform(-1, 1, s["audio"]).astype(np.float32),
             "has_video": np.array([True, True, False, True]),
             "has_audio": np.array([True, False, True, True])}
    draws = {"t_v": np.array([10, 900, 40, 300]), "t_a": np.array([500, 3, 7, 999]),
             "noise_v": rng.normal(size=s["z_video"]).astype(np.float32),
             "noise_a": rng.normal(size=s["z_audio"]).astype(np.float32),
             "cfg_u": np.array([0.05, 0.9, 0.5, 0.01], np.float32),
             "clean_u": np.array([0.5, 0.5, 0.1, 0.9], np.float32)}
    return batch, draws


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    _, params = jax_model_and_params(cfg, seed=3, jit=True)
    state = {k: v.numpy() for k, v in jax_params_to_state_dict(params).items()}
    batch, draws = _inputs(cfg)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (4, 8, 32, 32, 3), dtype=np.uint8)
    z_v0 = rng.normal(size=(4, 8, 2, 4, 4)).astype(np.float32)
    z_init = rng.normal(size=(4, 8, 50)).astype(np.float32)
    return cfg, params, state, batch, draws, frames, z_v0, z_init


def _tame(cfg):
    """Guidance 1.0: an untrained model at high guidance amplifies
    reduction-order noise through the sampler (the JAX test's setting)."""
    cfg = copy.deepcopy(cfg)
    cfg["sampling"]["guidance_scale"]["audio"] = 1.0
    return cfg


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """8 streamed record clips and a train_joint config with parallel.data
    2, 2 steps: (its directory, the CLI's argv)."""
    from test_torch_train_joint import _config, _write
    from multimodal_diffusion_torch.datasets.records import write_record_shards

    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(1)
    clips = ({"video": rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
              "audio": rng.uniform(-1, 1, (8000,)).astype(np.float32)} for _ in range(8))
    write_record_shards(clips, tmp / "rec", video_shape=(8, 32, 32, 3),
                        audio_shape=(8000,), clips_per_shard=4, fps=8, sr=8000)
    cfg = _config(tmp, records=tmp / "rec")
    cfg["parallel"] = {"data": 2, "model": 1}
    cfg["training"].update(max_steps=2, ckpt_every=2)
    return tmp, ["--config", _write(tmp, cfg), "--device", "cpu"]


@pytest.fixture(scope="module")
def ranks(setup, cli):
    """Every world-2 run of this file in one spawn: the two layouts' train
    steps (targets video, then audio), each again with dropout 0.1, the
    sampler on rows, sample_one_direction over 'data', the transfers and
    the train_joint CLI."""
    cfg, _, state, batch, draws, frames, z_v0, z_init = setup
    jobs = []
    for layout in LAYOUTS.values():
        jobs += [("train_step", (cfg, layout, state, batch, draws, 1.0)),
                 ("train_step", (cfg, layout, state, batch, draws, 0.0)),
                 ("train_step", (_cfg(0.1), layout, state, batch, draws, 0.0))]
    jobs += [("sampler_rows", (_tame(cfg), state, z_v0, z_init)),
             ("sample", (cfg, {"data": 2}, state, frames, 7)),
             ("transfers", ()),
             ("train_joint_cli", (cli[1],))]
    return run_ranks(D.battery, 2, jobs)


def _one_process(fn, *args):
    return getattr(D, fn)(0, 1, *args)


# ---------------------------------------------------------------------------
# mesh and sharding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", [dict(data=-1, model=1), dict(data=-1, model=2),
                                    dict(data=2, model=2, context=2),
                                    dict(data=2, model=1, pipe=2), dict(data=2, model=2)])
def test_mesh_shapes_follow_jax(layout):
    """Rank r sits where JAX's make_mesh puts device r of 8 (a smaller mesh
    uses the first ranks), with the same shape and axis names."""
    devices = jax.devices()[:8]
    jm = jax_make_mesh(**layout, devices=devices)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(8):
        m = TMesh.make_mesh(**layout, world=8, rank=r)
        assert m.shape == dict(jm.shape) and m.axis_names == jm.axis_names
        where = np.argwhere(ids == devices[r].id)
        if len(where):
            assert tuple(m.coords[a] for a in m.axis_names) == tuple(where[0])
        else:
            assert not m.active


def test_mesh_rejects_what_jax_rejects():
    for kw, msg in ((dict(data=-1, model=3), "not divisible"),
                    (dict(data=4, model=4), "needs more than 8 devices")):
        with pytest.raises(ValueError, match=msg):
            jax_make_mesh(**kw, devices=jax.devices()[:8])
        with pytest.raises(ValueError, match=msg):
            TMesh.make_mesh(**kw, world=8, rank=0)
    assert TMesh.make_mesh().shape == {"data": 1, "model": 1}  # one process


def test_shard_batch_splits_leading_axis():
    mesh = [TMesh.make_mesh(data=2, world=2, rank=r) for r in range(2)]
    batch = {"x": np.arange(8).reshape(4, 2), "odd": np.arange(3), "s": np.float32(1.0),
             "t": torch.arange(4)}
    parts = [TSh.shard_batch(m, batch) for m in mesh]
    np.testing.assert_array_equal(np.concatenate([p["x"] for p in parts]), batch["x"])
    assert parts[1]["x"].tolist() == [[4, 5], [6, 7]] and parts[1]["t"].tolist() == [2, 3]
    assert parts[0]["odd"] is batch["odd"] and parts[0]["s"] is batch["s"]
    # with the global batch size given, this rank's rows pass through
    assert TSh.shard_batch(mesh[1], {"x": batch["x"][:2]}, batch_size=4)["x"].shape == (2, 2)


def test_transfers_keep_every_dtypes_bits(ranks):
    """parallel/comm.py moves bf16, fp16 and bool as bytes (gloo's all_gather
    has no 16-bit integer type) and fp32 as itself: every rank receives
    exactly what the others hold."""
    held = [np.arange(12, dtype=np.float32).reshape(2, 3, 2) + 100 * r for r in range(2)]
    for dtype in ("torch.bfloat16", "torch.float16", "torch.bool", "torch.float32"):
        cast = (lambda a: (a != 0).astype(np.float32)) if dtype == "torch.bool" else (lambda a: a)
        for r in range(2):
            gathered, ringed, bcast, *sent = ranks[r][8][dtype]
            np.testing.assert_array_equal(gathered, np.concatenate([cast(h) for h in held], 1))
            np.testing.assert_array_equal(ringed, cast(held[1 - r]))
            np.testing.assert_array_equal(bcast, cast(held[0]))
            if r == 1:
                np.testing.assert_array_equal(sent[0], cast(held[0]))


def test_param_axes_follow_jax_shardings():
    """Every core parameter's mesh axes equal infer_param_shardings' spec
    (a kernel's spec read in the port's [out, in] order)."""
    from multimodal_diffusion_tpu.models.mmdit import MMDiT, MMDiTConfig
    from multimodal_diffusion_tpu.parallel.sharding import infer_param_shardings

    mesh = jax_make_mesh(data=4, model=2, devices=jax.devices()[:8])
    m = MMDiT(MMDiTConfig(d_model=64, n_layers=1, n_heads=4, dropout=0.0))
    boxed = m.init(jax.random.PRNGKey(0), jax.numpy.zeros((1, 8, 64)))["params"]
    specs = infer_param_shardings(mesh, boxed)
    flat = jax.tree_util.tree_leaves_with_path(specs)
    assert len(flat) == 11
    for path, sh in flat:
        keys = ("core",) + tuple(k.key for k in path)
        name = TC.torch_key(keys)
        ndim = 2 if keys[-1] == "kernel" else 1
        spec = tuple(sh.spec) + (None,) * (ndim - len(sh.spec))
        want = spec[::-1] if keys[-1] == "kernel" else spec
        got = TSh.param_mesh_axes(name) or (None,) * len(want)
        assert got == want, name


def test_state_dict_cuts_round_trip_and_match_jax(setup):
    """tp_slice / tp_unslice over a state_dict and the pipeline stage cuts
    are exact inverses; the attention out, fc1 and fc2 parts equal the
    JAX device shards of infer_param_shardings; a stage's blocks equal the
    JAX per-stage tree {block_i} converted."""
    from multimodal_diffusion_tpu.parallel.pipeline import (stack_stage_params,
                                                            unstack_stage_params)
    from multimodal_diffusion_torch.parallel.pipeline import (
        stack_stage_params as t_stack, unstack_stage_params as t_unstack)

    _, params, state, *_ = setup
    sd = {k: torch.from_numpy(v) for k, v in state.items()}
    parts = [{k: TSh.tp_slice(k, v, 2, i) for k, v in sd.items()} for i in range(2)]
    whole = {k: TSh.tp_unslice(k, [p[k] for p in parts]) for k in sd}
    assert all(torch.equal(whole[k], sd[k]) for k in sd)
    q = sd["core.blocks.0.attn.qkv.weight"].reshape(3, 4, 16, 64)  # (q|k|v, head, Dh, in)
    assert torch.equal(parts[1]["core.blocks.0.attn.qkv.weight"], q[:, 2:].reshape(-1, 64))
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    for name, path in (("attn.out", ("attn", "out")), ("mlp.fc1", ("mlp", "fc1")),
                       ("mlp.fc2", ("mlp", "fc2"))):
        kernel = params["core"]["block_1"][path[0]][path[1]]["kernel"]
        spec = {"attn.out": ("model", None), "mlp.fc1": (None, "model"),
                "mlp.fc2": ("model", None)}[name]
        arr = jax.device_put(kernel, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(*spec)))
        for i, shard in enumerate(sorted(arr.addressable_shards, key=lambda s: s.device.id)):
            np.testing.assert_array_equal(
                parts[i][f"core.blocks.1.{name}.weight"].numpy(), np.asarray(shard.data).T)
    stages = [TC.pipeline_stage_state_dict(sd, 2, s) for s in range(2)]
    joined = TC.pipeline_gather_state_dicts(stages, sd)
    assert set(joined) == set(sd) and all(torch.equal(joined[k], sd[k]) for k in sd)
    per_stage = [{"core": {"block_0": params["core"][f"block_{s}"]}} for s in range(2)]
    for s in range(2):
        conv = jax_params_to_state_dict(per_stage[s])
        assert set(conv) == set(stages[s])
        assert all(torch.equal(conv[k], stages[s][k]) for k in conv)
    stacked = stack_stage_params([p["core"] for p in per_stage])
    t_stacked = t_stack(stages)
    back = t_unstack(t_stacked, 2)
    assert all(torch.equal(back[s][k], stages[s][k]) for s in range(2) for k in stages[s])
    np.testing.assert_array_equal(
        t_stacked["core.blocks.0.mlp.fc1.weight"].numpy(),
        np.swapaxes(np.asarray(stacked["block_0"]["mlp"]["fc1"]["kernel"]), 1, 2))
    assert len(unstack_stage_params(stacked, 2)) == 2


# ---------------------------------------------------------------------------
# data and tensor parallelism: one train step
# ---------------------------------------------------------------------------


def _job(layout_name, which):
    return list(LAYOUTS).index(layout_name) * 3 + which


@pytest.mark.parametrize("target", [0, 1], ids=["video", "audio"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_step_matches_jax_and_one_process(setup, ranks, layout, target):
    cfg, params, state, batch, draws, *_ = setup
    tiv = 1.0 - target
    j_loss, j_grads = jax_layout_loss_and_grads(cfg, params, batch, draws, tiv,
                                                LAYOUTS[layout])
    one = _one_process("train_step", cfg, {}, state, batch, draws, tiv)
    got = [r[_job(layout, target)] for r in ranks]
    for metrics, grads, after in got:
        np.testing.assert_allclose(metrics["loss"], j_loss, rtol=1e-5)
        np.testing.assert_allclose(metrics["loss"], one[0]["loss"], rtol=1e-5)
        for name, ref in one[1].items():
            jref = j_grads[name].numpy()
            for want in (ref, jref):
                np.testing.assert_allclose(grads[name], want, rtol=0,
                                           atol=2e-4 * np.abs(want).max() + 1e-12,
                                           err_msg=name)
    # the replicas stay equal, and took one-process AdamW on their gradients
    for name in got[0][2]:
        np.testing.assert_array_equal(got[0][2][name], got[1][2][name])
    bundle = TT.create_trainer(cfg, device="cpu", batch_size=B)
    bundle.model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    bundle.state.optimizer.step([torch.from_numpy(got[0][1][n])
                                 for n in bundle.state.optimizer.names])
    for name, p in bundle.model.named_parameters():
        np.testing.assert_allclose(got[0][2][name], p.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_dropout_draws_the_one_process_masks(setup, ranks, layout):
    """Core and head dropout 0.1: each rank's slice of the one-process
    masks, so the step's loss and gradient norm are the one process's."""
    _, _, state, batch, draws, *_ = setup
    one = _one_process("train_step", _cfg(0.1), {}, state, batch, draws, 0.0)
    no_drop = _one_process("train_step", _cfg(0.0), {}, state, batch, draws, 0.0)
    assert abs(one[0]["loss"] - no_drop[0]["loss"]) > 1e-4  # the masks matter
    for r in ranks:
        metrics = r[_job(layout, 2)][0]
        np.testing.assert_allclose(metrics["loss"], one[0]["loss"], rtol=1e-5)
        np.testing.assert_allclose(metrics["grad_norm"], one[0]["grad_norm"], rtol=1e-4)


# ---------------------------------------------------------------------------
# batch-sharded sampling
# ---------------------------------------------------------------------------


def test_sampler_batch_sharded_matches_jax(setup, ranks):
    """The JAX package's test_sampler_batch_sharded_matches_single_device on
    ranks: 2 DDIM steps, guidance 1.0, the batch over data 2 (its
    tolerances)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimodal_diffusion_tpu.infer.ddim import sampler_from_config
    from multimodal_diffusion_tpu.models.diffusion import AVDiffusionConfig, AVDiffusionModel
    from multimodal_diffusion_tpu.parallel.sharding import batch_sharding

    cfg, params, state, *_, z_v0, z_init = setup
    jcfg = _tame(cfg)
    mesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    jm = AVDiffusionModel(AVDiffusionConfig.from_config(jcfg))
    sample, _ = sampler_from_config(jm, jcfg, target="audio")
    want = np.asarray(sample(jax.device_put(params, NamedSharding(mesh, P())),
                             jax.device_put(z_v0, batch_sharding(mesh, 5)),
                             jax.device_put(z_init, batch_sharding(mesh, 3)),
                             jax.random.PRNGKey(2)))
    got = [r[6] for r in ranks]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, rtol=5e-3, atol=5e-4)


def test_sample_one_direction_over_data_matches_one_process(setup, ranks):
    cfg, _, state, _, _, frames, *_ = setup
    one = _one_process("sample", cfg, {}, state, frames, 7)
    for r in ranks:
        assert r[7].shape == one.shape == (4, 8000)
        np.testing.assert_allclose(r[7], one, rtol=5e-3, atol=5e-4)


# ---------------------------------------------------------------------------
# the train_joint CLI on two processes, and the MFU without a peak figure
# ---------------------------------------------------------------------------


def test_train_joint_on_two_ranks(ranks, cli):
    """data 2 over WORLD_SIZE 2, 8 streamed record clips, 2 steps: both
    ranks end at step 2 with equal parameters, only the lead rank wrote, and
    its checkpoint loads in one process bit-equal."""
    from multimodal_diffusion_torch.train import checkpoint as TCk

    tmp = cli[0]
    (step0, p0), (step1, p1) = (r[9] for r in ranks)
    assert step0 == step1 == 2
    assert all(np.array_equal(p0[k], p1[k]) for k in p0)
    mgr = TCk.CheckpointManager(tmp / "run/ckpt")
    assert mgr.all_steps() == [2]
    restored = TCk.params_only_tree(mgr.restore(2))
    assert all(np.array_equal(restored[k].numpy(), p0[k]) for k in p0)
    lines = (tmp / "run/logs/metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2  # one writer


def test_run_training_without_a_peak_figure_logs_nan_mfu(monkeypatch):
    """A card the profiling table does not know: one warning, denoiser_mfu
    nan, and the steps run."""
    def unknown(device=None):
        raise KeyError("no dense bf16 peak known for 'NVIDIA Made-Up Card'")

    monkeypatch.setattr(TT, "device_peak_flops", unknown)
    cfg = _cfg()
    cfg["training"]["log_every"] = 1
    bundle = TT.create_trainer(cfg, device="cpu")
    batch, _ = _inputs(cfg)
    batch = {k: v[:2] for k, v in batch.items()}
    logs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = TT.run_training(cfg, bundle, iter([batch, batch]), max_steps=2,
                                log_fn=lambda s, m: logs.append(m))
    assert state.step == 2 and len(logs) == 2
    assert all(np.isnan(m["denoiser_mfu"]) and np.isfinite(m["loss"]) for m in logs)
    assert sum("denoiser_mfu is logged as nan" in str(w.message) for w in caught) == 1


def test_shrunk_config_is_the_jax_dry_run_config():
    from __graft_entry__ import _shrunk_cfg
    from multimodal_diffusion_torch.utils.io import shrunk_config

    assert shrunk_config() == _shrunk_cfg()
    assert yaml.safe_dump(shrunk_config()) == yaml.safe_dump(_shrunk_cfg())
