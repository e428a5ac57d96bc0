"""Tensor-parallel storage under ``parallel.model: 2``: each rank holds only
its part of the core's split projections (qkv and fc1 rows, attention out
and fc2 columns), of their gradients, Adam moments and EMA shadow, as the
JAX package's parameter shardings place them. World-2 gloo groups of spawned
CPU processes (``tests/_torch_dist.py``), the shrunk mvp config, fp32:

  * the parts' shapes, and each rank's bytes of parameters, gradients, EMA
    and moments equal to the whole model's less half of the split ones';
  * the seeded init, gathered, bit-equal to one process's;
  * one train step (the clip active): the loss within 1e-5 relative of one
    process and of the JAX package on its data 1 x model 2 CPU mesh, the
    clip's global norm within 1e-5 of one process's, every gathered
    gradient within 2e-4 of its largest magnitude of both, the parameters
    after AdamW within 1e-6 of one process's AdamW on those gradients, and
    the replicated parameters' gradients bit-equal on the two ranks;
  * a checkpoint from model 2 (bf16 moments, gradient accumulation) to one
    process and back to model 2 through ``train_joint --resume``, bit for
    bit at every crossing;
  * the int8 core under model 2 bit-equal to one process's int8 core (its
    input gradient, through the absmax scales, within 1e-5), and within
    5e-3 of its magnitude of the JAX int8 core on a 2-device mesh;
    an int8 v2a batch under model 2 bit-equal to one process's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import _torch_dist as D
from _torch_parity import jax_layout_loss_and_grads, jax_model_and_params, shrunk_cfg
from multimodal_diffusion_torch.parallel.launch import run_ranks
from multimodal_diffusion_torch.parallel.sharding import is_split, local_shape
from multimodal_diffusion_torch.train import checkpoint as TC
from multimodal_diffusion_torch.train import trainer as TT
from multimodal_diffusion_torch.utils.convert import jax_params_to_state_dict
from multimodal_diffusion_tpu.models import mmdit as JM
from multimodal_diffusion_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_diffusion_tpu.parallel.sharding import infer_param_shardings
from multimodal_diffusion_tpu.train.trainer import latent_shapes_from_config

B = 4
MODEL2 = {"data": 1, "model": 2}
CLIP = 0.1  # below the step's gradient norm: the clip scales every gradient
CORE = dict(d_model=64, n_layers=2, n_heads=4, mlp_ratio=2.0, dropout=0.0, attn_dropout=0.0,
            norm="rmsnorm", token_dropout=0.0)


def _cfg(**training):
    cfg = shrunk_cfg(sampler_steps=2)
    cfg["training"]["scheduler"] = {"name": "none"}  # the step moves every parameter
    cfg["training"]["grad_clip_norm"] = CLIP
    cfg["model"]["core"]["dropout"] = 0.0
    cfg["training"].update(training)
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


def _bf16_all_cfg():
    cfg = _cfg()
    cfg["training"]["optimizer"]["mv_dtype"] = "bf16"
    cfg["training"]["ema"] = {"use_ema": True, "decay": 0.999, "scope": "all"}
    return cfg


def _int8_cfg():
    cfg = _cfg()
    cfg["model"]["core"]["quant"] = "int8"
    return cfg


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    _, params = jax_model_and_params(cfg, seed=3, jit=True)
    state = {k: v.numpy() for k, v in jax_params_to_state_dict(params).items()}
    batch, draws = _inputs(cfg)
    x = jax.random.normal(jax.random.PRNGKey(2), (2, 96, 64), jnp.float32)
    core = JM.MMDiT(JM.MMDiTConfig(**CORE, quant="int8"))
    boxed = core.init({"params": jax.random.PRNGKey(3)}, x)["params"]
    rng = np.random.default_rng(9)
    cparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, 0.05, np.shape(a)).astype(
            np.float32), meta.unbox(boxed))
    cstate = {k[len("core."):]: v.numpy()
              for k, v in jax_params_to_state_dict({"core": cparams}).items()}
    frames = np.random.default_rng(5).integers(0, 256, (4, 8, 32, 32, 3), dtype=np.uint8)
    return cfg, params, state, batch, draws, (np.asarray(x), boxed, cparams, cstate), frames


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """8 streamed record clips and the three train_joint configs of the
    checkpoint chain (bf16 moments, 2 micro-batches a step, core dropout
    0.1): model 2 for 3 steps into run/ckpt; the one-process config that
    restores it; model 2 resuming from `one` to step 4."""
    from multimodal_diffusion_torch.datasets.records import write_record_shards
    from test_torch_train_joint import _config, _write

    tmp = tmp_path_factory.mktemp("tp_chain")
    rng = np.random.default_rng(1)
    clips = ({"video": rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
              "audio": rng.uniform(-1, 1, (8000,)).astype(np.float32)} for _ in range(8))
    write_record_shards(clips, tmp / "rec", video_shape=(8, 32, 32, 3),
                        audio_shape=(8000,), clips_per_shard=4, fps=8, sr=8000)
    cfg = _config(tmp, records=tmp / "rec", max_steps=3, ckpt_every=100)
    cfg["training"]["optimizer"]["mv_dtype"] = "bf16"
    cfg["data"]["grad_accum_steps"] = 2
    cfg["parallel"] = dict(MODEL2)
    one = copy.deepcopy(cfg)
    one["parallel"] = {"data": 1, "model": 1}
    resume = copy.deepcopy(cfg)
    resume["paths"]["ckpt_dir"] = str(tmp / "one")
    resume["paths"]["log_dir"] = str(tmp / "resume_logs")
    return (tmp, ["--config", _write(tmp, cfg), "--device", "cpu"], one,
            ["--config", _write(tmp, resume, "resume.yaml"), "--device", "cpu", "--resume",
             "--max-steps", "4"])


@pytest.fixture(scope="module")
def ranks(setup, chain):
    """Every world-2 run of this file in one spawn."""
    cfg, _, state, batch, draws, (x, _, _, cstate), frames = setup
    _, argv_model2, one_cfg, argv_resume = chain
    jobs = [("tp_trainer", (cfg, MODEL2, state, batch, draws, 0.0)),
            ("tp_trainer", (_bf16_all_cfg(), MODEL2, state, batch, draws, 1.0)),
            ("tp_checkpoint_chain", (argv_model2, one_cfg, argv_resume,
                                     str(chain[0] / "one"))),
            ("int8_core", (CORE, MODEL2, cstate, x)),
            ("sample", (_int8_cfg(), MODEL2, state, frames, 7))]
    return run_ranks(D.battery, 2, jobs)


def _one_process(fn, *args):
    return getattr(D, fn)(0, 1, *args)


# ---------------------------------------------------------------------------
# parts and bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("job", [0, 1], ids=["fp32_moments_core_ema", "bf16_moments_all_ema"])
def test_each_rank_holds_parts_and_the_exact_bytes(setup, ranks, job):
    cfg = setup[0] if job == 0 else _bf16_all_cfg()
    whole = TT.create_trainer(cfg, device="cpu", batch_size=B)
    params = dict(whole.model.named_parameters())
    mv = 2 if job == 1 else 4
    split_numel = sum(p.numel() for n, p in params.items() if is_split(n))
    assert split_numel > 0

    def expected(names, itemsize):
        return itemsize * sum(int(np.prod(local_shape(n, params[n].shape, 2))) for n in names)

    want = {"params": expected(params, 4), "grads": expected(params, 4),
            "ema": expected(whole.state.ema, 4), "mu": expected(params, mv),
            "nu": expected(params, mv)}
    # whole-model bytes less half of the split ones'
    assert want["params"] == 4 * (sum(p.numel() for p in params.values()) - split_numel // 2)
    for r in ranks:
        got = r[job]
        assert got["bytes"] == want
        for n, p in params.items():
            part = local_shape(n, p.shape, 2)
            assert got["shapes"][n] == got["moment_shapes"][n] == part, n
            if n in got["ema_shapes"]:
                assert got["ema_shapes"][n] == part
        core = [n for n in params if is_split(n)]
        assert {n.rsplit(".", 2)[1] for n in core} == {"qkv", "out", "fc1", "fc2"}
        assert got["shapes"]["core.blocks.0.attn.qkv.weight"] == (96, 64)
        assert got["shapes"]["core.blocks.0.attn.out.weight"] == (64, 32)
        assert got["shapes"]["core.blocks.0.attn.out.bias"] == (64,)


def test_init_under_model2_gathers_to_the_one_process_init(setup, ranks):
    one = TT.create_trainer(setup[0], device="cpu", batch_size=B)
    for r in ranks:
        init = r[0]["init"]
        for n, p in one.model.named_parameters():
            np.testing.assert_array_equal(init[n], p.detach().numpy(), err_msg=n)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------


def test_step_matches_one_process_and_jax(setup, ranks):
    cfg, params, state, batch, draws, *_ = setup
    j_loss, j_grads = jax_layout_loss_and_grads(cfg, params, batch, draws, 0.0, MODEL2)
    one = _one_process("train_step", cfg, {}, state, batch, draws, 0.0)
    assert one[0]["grad_norm"] > CLIP  # the clip scales the step
    for r in ranks:
        got = r[0]
        np.testing.assert_allclose(got["metrics"]["loss"], j_loss, rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["loss"], one[0]["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], one[0]["grad_norm"], rtol=1e-5)
        for name, ref in one[1].items():
            for want in (ref, j_grads[name].numpy()):
                np.testing.assert_allclose(got["grads"][name], want, rtol=0,
                                           atol=2e-4 * np.abs(want).max() + 1e-12,
                                           err_msg=name)
    # both ranks took one-process AdamW (with its clip) on the gathered gradients
    for name in ranks[0][0]["params"]:
        np.testing.assert_array_equal(ranks[0][0]["params"][name], ranks[1][0]["params"][name])
    bundle = TT.create_trainer(cfg, device="cpu", batch_size=B)
    bundle.model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    bundle.state.optimizer.step([torch.from_numpy(ranks[0][0]["grads"][n])
                                 for n in bundle.state.optimizer.names])
    for name, p in bundle.model.named_parameters():
        np.testing.assert_allclose(ranks[0][0]["params"][name], p.detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_replicated_gradients_are_equal_on_the_model_ranks(ranks):
    """No sum over 'model' is needed for them: copy_to_group's backward
    hands both ranks the whole input gradient."""
    g0, g1 = (r[0]["replicated_grads"] for r in ranks)
    assert set(g0) == set(g1) and len(g0) > 0
    for n in g0:
        np.testing.assert_array_equal(g0[n], g1[n], err_msg=n)


def test_bf16_moments_and_ema_all_step_matches_one_process(setup, ranks):
    cfg = _bf16_all_cfg()
    _, _, state, batch, draws, *_ = setup
    one = _one_process("train_step", cfg, {}, state, batch, draws, 1.0)
    for r in ranks:
        np.testing.assert_allclose(r[1]["metrics"]["loss"], one[0]["loss"], rtol=1e-5)
        np.testing.assert_allclose(r[1]["metrics"]["grad_norm"], one[0]["grad_norm"],
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _assert_trees_equal(a, b):
    from test_torch_train_joint import _assert_trees_equal as equal

    equal(a, b)
    acc_a, acc_b = a["opt_state"]["acc"], b["opt_state"]["acc"]
    assert acc_a.keys() == acc_b.keys()
    for k in acc_a:
        assert torch.equal(acc_a[k], acc_b[k]), k


def test_checkpoint_crosses_model2_one_process_model2(chain, ranks):
    """The lead rank's file holds whole tensors equal to the gathered state;
    one process restores it bit for bit; train_joint --resume under model 2
    restores that process's checkpoint bit for bit and runs on."""
    tmp = chain[0]
    saved = TC.CheckpointManager(tmp / "run/ckpt")
    assert saved.all_steps() == [3]
    tree = saved.restore(3)
    assert tree["params"]["core.blocks.0.attn.qkv.weight"].shape == (192, 64)
    assert any(float(t.abs().max()) > 0 for t in tree["opt_state"]["acc"].values())
    first0, one_tree, _, _ = ranks[0][2]
    for r in ranks:
        first, _, restored, step = r[2]
        _assert_trees_equal(first, tree)
        _assert_trees_equal(restored, one_tree)
        assert step == 4
    _assert_trees_equal(one_tree, tree)


# ---------------------------------------------------------------------------
# int8 under model 2
# ---------------------------------------------------------------------------


def test_int8_core_under_model2_is_one_process_int8(setup, ranks):
    """Bit-equal to one process's int8 core (the row-split projections take
    the group's absmax scales and sum int32 products), and within 5e-3 of
    its magnitude of the JAX int8 core whose parameters XLA partitions over
    a data 1 x model 2 mesh (the one-process tolerance of
    tests/test_torch_quant.py)."""
    x, boxed, cparams, cstate = setup[5]
    one, one_gx, shapes = _one_process("int8_core", CORE, {}, cstate, x)
    assert shapes == ((192, 64), (64, 64))
    for r in ranks:
        out, gx, shapes = r[3]
        assert shapes == ((96, 64), (64, 32))
        np.testing.assert_array_equal(out, one)
        # the gradient through the group's absmax scales (fp32 sums over
        # the group in another order)
        np.testing.assert_allclose(gx, one_gx, rtol=0, atol=1e-5 * np.abs(one_gx).max())
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    core = JM.MMDiT(JM.MMDiTConfig(**CORE, quant="int8"))
    placed = jax.device_put(cparams, infer_param_shardings(mesh, boxed))
    want = np.asarray(jax.jit(lambda p, xx: core.apply({"params": p}, xx, deterministic=True))(
        placed, jnp.asarray(x)))
    np.testing.assert_allclose(ranks[0][3][0], want, rtol=0, atol=5e-3 * np.abs(want).max())


def test_int8_sample_under_model2_is_one_process_int8(setup, ranks):
    _, _, state, *_, frames = setup
    one = _one_process("sample", _int8_cfg(), {}, state, frames, 7)
    for r in ranks:
        assert r[4].shape == one.shape == (4, 8000)
        np.testing.assert_array_equal(r[4], one)


# ---------------------------------------------------------------------------
# what an NCCL group is handed
# ---------------------------------------------------------------------------


_TRANSFERS = {
    "all_reduce_": lambda comm, t, g: comm.all_reduce_(t, g),
    "all_reduce_max_": lambda comm, t, g: comm.all_reduce_max_(t, g),
    "all_gather": lambda comm, t, g: comm.all_gather(t, g, 0),
    "broadcast_": lambda comm, t, g: comm.broadcast_(t, 0, g),
    "ring_exchange": lambda comm, t, g: comm.ring_exchange([t], g, [0, 1]),
    "send": lambda comm, t, g: comm.send(t, 1, g),
    "recv": lambda comm, t, g: comm.recv(t, 1, g),
}


@pytest.mark.parametrize("transfer", sorted(_TRANSFERS))
def test_a_host_tensor_never_reaches_an_nccl_group(monkeypatch, transfer):
    """NCCL takes CUDA tensors only: every transfer refuses a host tensor
    before it reaches such a group."""
    from multimodal_diffusion_torch.parallel import comm

    monkeypatch.setattr(comm.dist, "get_backend", lambda group: "nccl")
    monkeypatch.setattr(comm.dist, "get_rank", lambda group=None: 0)
    for name in ("all_reduce", "all_gather", "broadcast", "send", "recv", "batch_isend_irecv"):
        monkeypatch.setattr(comm.dist, name, lambda *a, **k: pytest.fail("reached the group"))
    with pytest.raises(ValueError, match="NCCL"):
        _TRANSFERS[transfer](comm, torch.ones(2, 3), object())


def test_checkpoint_gathers_the_live_tensors(monkeypatch):
    """state_to_tree hands the 'model' group the parameters', EMA's and
    optimizer's own tensors, where they live (on the card under NCCL), and
    copies the gathered whole to the host only after: never a host copy of
    a device tensor."""
    from multimodal_diffusion_torch.parallel import comm

    cfg = _bf16_all_cfg()
    cfg["data"]["grad_accum_steps"] = 2  # the accumulator is gathered too
    st = TT.create_trainer(cfg, device="cpu", batch_size=B).state
    opt, group = st.optimizer, object()
    live = {t.data_ptr() for t in (*opt.params, *opt.mu, *opt.nu, *opt.acc, *st.ema.values())}
    handed = []

    def all_gather(t, g, dim):
        assert g is group
        handed.append(t.data_ptr())
        return torch.cat([t, t], dim)

    monkeypatch.setattr(comm, "group_size", lambda g: 1 if g is None else 2)
    monkeypatch.setattr(comm, "all_gather", all_gather)
    st.mesh = type("ModelMesh", (), {"group": lambda self, axis: group})()
    opt.tp_group = group
    tree = TC.state_to_tree(st)
    n_split = sum(is_split(n) for n in opt.names)
    # parameters, mu, nu, acc and the EMA (scope all) of every split one
    assert len(handed) == 5 * n_split > 0
    assert set(handed) <= live
    assert tree["opt_state"]["acc"]["core.blocks.0.mlp.fc1.weight"].shape == (256, 64)


_REPLICATED_LAYOUTS = {"model": {"data": 1, "model": 2}, "context": {"data": 1, "context": 2},
                       "pipe": {"data": 1, "pipe": 2}}


@pytest.fixture(scope="module")
def replicated_grads():
    return run_ranks(D.reduced_replicated_grads, 2, list(_REPLICATED_LAYOUTS.values()))


@pytest.mark.parametrize("axis", sorted(_REPLICATED_LAYOUTS))
def test_a_replicated_gradient_is_the_first_ranks(replicated_grads, axis):
    """Gradients that differ by rank (as a nondeterministic kernel's may):
    over 'model' a split part stays the rank's own and a replicated one is
    the first rank's; over 'context' and 'pipe' the core blocks' are summed
    and the rest is the first rank's. A replicated parameter stays one
    value on every rank."""
    i = list(_REPLICATED_LAYOUTS).index(axis)
    got = [r[i] for r in replicated_grads]
    if axis == "model":
        assert got == [[0.0, 1.0, 2.0], [10.0, 1.0, 2.0]]
    else:
        assert got == [[10.0, 12.0, 2.0], [10.0, 12.0, 2.0]]
