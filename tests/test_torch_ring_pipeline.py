"""The port's ring attention, context parallelism and pipeline parallelism
on world-2 gloo groups of spawned CPU processes (``parallel/launch.py``;
rank bodies in ``tests/_torch_dist.py``), held against the JAX package on
a 2-device sub-mesh of its 8 virtual CPU devices (the Pallas kernels of its
flash ring in interpret mode) and against the port's one-process run, fp32:

  * ring_attention_sharded, einsum and flash, unmasked and masked (ragged
    key rows across the shard boundary, one row with no valid key):
    outputs and the gradients of q, k and v against JAX's ring (1e-5);
    the fully masked row's output and grads exact zeros; bad shapes and an
    unknown impl raise;
  * the MMDiT core under context 2 (einsum and flash rings, RoPE at the
    shards' global positions, a padding mask, N = 15 padded to 16 by
    lcm(seq_multiple, 2)): output and gradients of x and every parameter
    against JAX's context-parallel core and the one-process core;
  * the core under pipe 2 (2 microbatches, masked) and
    mmdit_pipeline_apply on an ordinary core, against JAX's pipelined
    core;
  * one train step from config under context 2 (einsum and flash) and pipe
    2: the loss within 1e-5 relative of JAX's layout and of one process,
    every gradient within 2e-4 of its largest magnitude, the replicas'
    parameters equal;
  * v2a sampling under context 2 against one process;
  * the dry run (tools/dryrun_multichip.py) on 4 ranks prints the JAX
    dry run's OK line.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import _torch_dist as D
from _torch_parity import jax_layout_loss_and_grads, jax_model_and_params, shrunk_cfg
from multimodal_diffusion_torch.ops.ring_attention import ring_attention_sharded
from multimodal_diffusion_torch.parallel.launch import run_ranks
from multimodal_diffusion_torch.parallel.mesh import make_mesh
from multimodal_diffusion_torch.utils.convert import jax_params_to_state_dict, torch_key
from multimodal_diffusion_tpu.models.mmdit import MMDiT as JMMDiT, MMDiTConfig as JMMDiTConfig
from multimodal_diffusion_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_diffusion_tpu.train.trainer import latent_shapes_from_config

RING_SHAPE = (2, 2, 32, 16)
CORE = dict(d_model=32, n_layers=2, n_heads=4, mlp_ratio=2.0, dropout=0.0,
            attn_dropout=0.0, norm="rmsnorm", rope=True, token_dropout=0.0)
CORE_CASES = {  # name: (port core kwargs over CORE, layout, N, masked)
    "context_einsum": ({}, {"data": 1, "context": 2}, 16, True),
    "context_flash": ({"context_flash": True}, {"data": 1, "context": 2}, 16, True),
    "context_padded": ({"seq_multiple": 4}, {"data": 1, "context": 2}, 15, False),
    "pipe": ({"pipe_microbatches": 2}, {"data": 1, "pipe": 2}, 16, True),
}
STEP_LAYOUTS = {"context": {"data": 1, "context": 2},
                "context_flash": {"data": 1, "context": 2, "context_flash": True},
                "pipe": {"data": 1, "pipe": 2, "pipe_microbatches": 2}}


def _ring_inputs(masked):
    rng = np.random.default_rng(1)
    q, k, v, dout = (rng.standard_normal(RING_SHAPE).astype(np.float32) for _ in range(4))
    valid = None
    if masked:
        valid = np.ones((RING_SHAPE[0], RING_SHAPE[2]), bool)
        valid[0, 13:] = False  # crosses the shard boundary at 16
        valid[1, :] = False    # no valid key anywhere
    return q, k, v, valid, dout


def _core_inputs(N, masked, B=4):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, N, 32)).astype(np.float32)
    dout = rng.standard_normal((B, N, 32)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((B, N), bool)
        mask[1, 11:] = True
        mask[3, 5:] = True
    return x, mask, dout


def _step_setup():
    cfg = shrunk_cfg(sampler_steps=2)
    cfg["training"]["scheduler"] = {"name": "none"}
    # 16 video + 12 audio tokens = 28, divisible by context 2
    cfg["audio"]["latent"]["frames_per_clip"] = 48
    B = 2
    s = latent_shapes_from_config(cfg, B)
    rng = np.random.default_rng(4)
    batch = {"video": rng.uniform(0, 1, s["video"]).astype(np.float32),
             "audio": rng.uniform(-1, 1, s["audio"]).astype(np.float32),
             "has_video": np.array([True, True]), "has_audio": np.array([True, False])}
    draws = {"t_v": np.array([10, 900]), "t_a": np.array([500, 3]),
             "noise_v": rng.normal(size=s["z_video"]).astype(np.float32),
             "noise_a": rng.normal(size=s["z_audio"]).astype(np.float32),
             "cfg_u": np.array([0.05, 0.9], np.float32),
             "clean_u": np.array([0.5, 0.5], np.float32)}
    return cfg, batch, draws


@pytest.fixture(scope="module")
def core_params():
    x = jnp.zeros((1, 16, 32))
    params = JMMDiT(JMMDiTConfig(**CORE)).init({"params": jax.random.PRNGKey(3)}, x)["params"]
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    state = {k[len("core."):]: v.numpy()
             for k, v in jax_params_to_state_dict({"core": params}).items()}
    return params, state


@pytest.fixture(scope="module")
def step_setup():
    cfg, batch, draws = _step_setup()
    _, params = jax_model_and_params(cfg, seed=5, jit=True)
    state = {k: v.numpy() for k, v in jax_params_to_state_dict(params).items()}
    return cfg, params, state, batch, draws


@pytest.fixture(scope="module")
def ranks(core_params, step_setup):
    """Every world-2 run of this file in one spawn."""
    _, cstate = core_params
    cfg, _, state, batch, draws = step_setup
    jobs = {}
    for impl in ("einsum", "flash"):
        for masked in (False, True):
            jobs[("ring", impl, masked)] = ("ring", (*_ring_inputs(masked), impl))
    for name, (kw, layout, N, masked) in CORE_CASES.items():
        jobs[("core", name)] = ("core", ({**CORE, **kw}, layout, cstate,
                                         *_core_inputs(N, masked)))
    x, mask, dout = _core_inputs(16, True)
    jobs[("pipeline_apply",)] = ("pipeline", (CORE, cstate, x, mask, dout, 2))
    for name, layout in STEP_LAYOUTS.items():
        jobs[("step", name)] = ("train_step", (D.layout_cfg(cfg, layout), layout, state,
                                               batch, draws, 0.0))
    frames = np.random.default_rng(6).integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8)
    jobs[("sample",)] = ("sample", (cfg, {"data": 1, "context": 2}, state, frames, 3))
    keys = list(jobs)
    out = run_ranks(D.battery, 2, [jobs[k] for k in keys])
    return [dict(zip(keys, r)) for r in out]


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


def _jax_ring(impl, masked):
    from multimodal_diffusion_tpu.ops.ring_attention import ring_attention_sharded as jring

    q, k, v, valid, dout = _ring_inputs(masked)
    mesh = jax_make_mesh(data=1, model=1, context=2, devices=jax.devices()[:2])
    kv = None if valid is None else jnp.asarray(valid)

    @jax.jit
    def run(q, k, v, dout):
        out, vjp = jax.vjp(lambda a, b, c: jring(a, b, c, mesh, axis="context", kv_valid=kv,
                                                 impl=impl), q, k, v)
        return (out, *vjp(dout))

    return run(q, k, v, dout)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_ring_attention_matches_jax_both_directions(ranks, impl, masked):
    """Batch row 1 has no valid key: the port gives exact zeros there, in
    the output and every gradient (the kernels' contract). JAX's flash ring
    does too; its einsum ring's q gradient is NaN in that row, so the rows
    compared with JAX there are the others."""
    want = _jax_ring(impl, masked)
    rows = [0] if masked else [0, 1]
    for r in ranks:
        for name, got, ref in zip(("out", "dq", "dk", "dv"), r[("ring", impl, masked)], want):
            np.testing.assert_allclose(got[rows], np.asarray(ref)[rows], rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            if masked:
                assert not np.any(got[1]), f"{name}: the row with no valid key is not zeros"
                if impl == "flash":
                    assert not np.any(np.asarray(ref)[1])


def test_ring_attention_rejects_bad_shapes():
    mesh = make_mesh(data=1, context=2, world=2, rank=0)
    q = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="kv_valid"):
        ring_attention_sharded(q, q, q, mesh, "context", kv_valid=torch.ones(1, 4, dtype=bool))
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention_sharded(q[:, :, :7], q[:, :, :7], q[:, :, :7], mesh, "context")
    with pytest.raises(ValueError, match="einsum|flash"):
        ring_attention_sharded(q, q, q, mesh, "context", impl="dense")


# ---------------------------------------------------------------------------
# the core under context and pipe
# ---------------------------------------------------------------------------


def _jax_core(name, params):
    """JAX's core on its own layout: output and the gradients of <out, dout>
    w.r.t. x and the params (as the port's state_dict)."""
    kw, layout, N, masked = CORE_CASES[name]
    x, mask, dout = _core_inputs(N, masked)
    axes = {k: v for k, v in layout.items() if k in ("data", "context", "pipe")}
    mesh = jax_make_mesh(**axes, devices=jax.devices()[:2])
    extra = {"mesh": mesh}
    if "context" in axes:
        extra.update(context_axis="context", context_flash=kw.get("context_flash", False),
                     seq_multiple=kw.get("seq_multiple", 1))
    else:
        extra.update(pipe_axis="pipe", pipe_microbatches=kw["pipe_microbatches"])
    net = JMMDiT(JMMDiTConfig(**CORE, **extra))
    m = None if mask is None else jnp.asarray(mask)

    @jax.jit
    def run(p, xx, dout):
        out, vjp = jax.vjp(lambda p, xx: net.apply({"params": p}, xx, m), p, xx)
        return (out, *vjp(dout))

    out, gp, gx = run(params, jnp.asarray(x), jnp.asarray(dout))
    grads = {k[len("core."):]: v.numpy()
             for k, v in jax_params_to_state_dict({"core": gp}).items()}
    return np.asarray(out), np.asarray(gx), grads, mask


def _one_process_core(name, state):
    kw, _, N, masked = CORE_CASES[name]
    return D.core(0, 1, {**CORE, **{k: v for k, v in kw.items()
                                    if k == "seq_multiple"}}, {}, state,
                  *_core_inputs(N, masked))


def _assert_core(got, want, keep):
    out, gx, grads = got
    np.testing.assert_allclose(out[keep], want[0][keep], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gx, want[1], rtol=0, atol=2e-4 * np.abs(want[1]).max())
    for n, g in want[2].items():
        np.testing.assert_allclose(grads[n], g, rtol=0, atol=2e-4 * np.abs(g).max() + 1e-12,
                                   err_msg=n)


@pytest.mark.parametrize("name", list(CORE_CASES))
def test_core_layout_matches_jax_and_one_process(ranks, core_params, name):
    params, state = core_params
    jout, jgx, jgrads, mask = _jax_core(name, params)
    # JAX's pipelined core leaves a padded query row to its stage; compare the
    # real tokens' outputs there, as its own test does
    keep = (np.ones(jout.shape[:2], bool) if mask is None or "context" in name
            else ~mask)
    one = _one_process_core(name, state)
    for r in ranks:
        got = r[("core", name)]
        _assert_core(got, (jout, jgx, jgrads), keep)
        _assert_core(got, one, keep)


def test_mmdit_pipeline_apply_matches_jax(ranks, core_params):
    from multimodal_diffusion_tpu.parallel.pipeline import mmdit_pipeline_apply

    params, _ = core_params
    x, mask, dout = _core_inputs(16, True)
    mesh = jax_make_mesh(data=1, model=1, pipe=2, devices=jax.devices()[:2])
    cfg = JMMDiTConfig(**CORE)
    want = np.asarray(jax.jit(lambda p, xx, m: mmdit_pipeline_apply(
        cfg, p, xx, mesh, n_microbatches=2, key_padding_mask=m))(
            params, jnp.asarray(x), jnp.asarray(mask)))
    for r in ranks:
        out = r[("pipeline_apply",)][0]
        np.testing.assert_allclose(out[~mask], want[~mask], rtol=2e-5, atol=2e-5)
    assert torch_key(("core", "block_1", "attn", "qkv", "kernel")) == "core.blocks.1.attn.qkv.weight"


# ---------------------------------------------------------------------------
# train steps from config, sampling, the dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(STEP_LAYOUTS))
def test_train_step_from_config_matches_jax_and_one_process(ranks, step_setup, layout):
    cfg, params, state, batch, draws = step_setup
    j_loss, j_grads = jax_layout_loss_and_grads(cfg, params, batch, draws, 0.0,
                                                STEP_LAYOUTS[layout])
    one = D.train_step(0, 1, cfg, {}, state, batch, draws, 0.0)
    got = [r[("step", layout)] for r in ranks]
    for metrics, grads, _ in got:
        np.testing.assert_allclose(metrics["loss"], j_loss, rtol=1e-5)
        np.testing.assert_allclose(metrics["loss"], one[0]["loss"], rtol=1e-5)
        for name, ref in one[1].items():
            for want in (ref, j_grads[name].numpy()):
                np.testing.assert_allclose(grads[name], want, rtol=0,
                                           atol=2e-4 * np.abs(want).max() + 1e-12,
                                           err_msg=name)
    for name in got[0][2]:
        np.testing.assert_array_equal(got[0][2][name], got[1][2][name])


def test_sampling_under_context_matches_one_process(ranks, step_setup):
    cfg, _, state, *_ = step_setup
    frames = np.random.default_rng(6).integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8)
    one = D.sample(0, 1, cfg, {}, state, frames, 3)
    for r in ranks:
        np.testing.assert_allclose(r[("sample",)], one, rtol=5e-3, atol=5e-4)


def test_dryrun_multichip_on_four_ranks():
    from multimodal_diffusion_torch.tools.dryrun_multichip import dryrun_multichip

    line = dryrun_multichip(4, device="cpu")
    assert line == ("[dryrun_multichip] OK: 1 train step + 2-step sharded sampling on mesh "
                    "data=2 x model=2 (4 devices) + 1 pipelined train step on mesh data=2 x "
                    "pipe=2 + 1 flash-ring CP train step on mesh data=2 x context=2")
