"""Checkpoints between the JAX package and the port, on the CPU:

* the port's orbax reader (no orbax, no tensorstore) against orbax's own
  restore, leaf for leaf and bit for bit, on checkpoints the JAX package's
  CheckpointManager writes here (fp32 and bf16 moments, optax.MultiSteps,
  EMA scope core and all, arrays split into several chunks) and on the
  committed fixture; its key-value store against tensorstore's;
* ``restore_jax_state``: the next AdamW update against optax's from the
  restored opt_state, the loss and every grad against the JAX package;
* the inverse weight carry (port -> JAX params) bit-equal, and its .npz run
  through the JAX model;
* the reference implementation's ``step_650.pt`` in the port against the
  JAX package loaded through ``tools/port_reference_checkpoint.py``."""

import hashlib
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from _torch_orbax import FIXTURE, FIXTURE_STEPS, fixture_cfg
from _torch_parity import perturb, shrunk_cfg, shrunk_flagship_cfg, t2n, torch_model
from multimodal_diffusion_torch.infer import sample_clip
from multimodal_diffusion_torch.models.diffusion import AVDiffusionConfig, AVDiffusionModel
from multimodal_diffusion_torch.tools.export_jax_params import export_params
from multimodal_diffusion_torch.train import checkpoint as TC
from multimodal_diffusion_torch.train import orbax_reader as R
from multimodal_diffusion_torch.train import trainer as TT
from multimodal_diffusion_torch.utils import zstd
from multimodal_diffusion_torch.utils.convert import (_leaves, jax_params_to_state_dict,
                                                      state_dict_to_jax_params)
from multimodal_diffusion_torch.utils.reference_checkpoint import reference_state_dict
from multimodal_diffusion_tpu.ops import schedule as JS
from multimodal_diffusion_tpu.train import checkpoint as JC
from multimodal_diffusion_tpu.train import losses as JL
from multimodal_diffusion_tpu.train import trainer as JT

REPO = Path(__file__).resolve().parents[1]
REF_DIR = REPO / "docs" / "parity" / "ref_run"
STEP = 3


# ---------------------------------------------------------------------------
# JAX checkpoints written here
# ---------------------------------------------------------------------------


def _cfg(mv_dtype="fp32", accum=1, scope="core"):
    cfg = shrunk_cfg()
    cfg["training"]["optimizer"].update(mv_dtype=mv_dtype, lr=0.05)
    cfg["training"]["max_steps"] = 10
    cfg["training"]["ema"] = {"use_ema": True, "decay": 0.9, "scope": scope}
    cfg["data"]["grad_accum_steps"] = accum
    return cfg


CASES = {"fp32": _cfg(), "bf16": _cfg("bf16"), "multisteps": _cfg(accum=2),
         "ema_all": _cfg(scope="all")}


def _grads(params, seed, scale):
    rng = np.random.default_rng(seed)
    n = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    return jax.tree_util.tree_map(
        lambda p: (scale * rng.normal(size=np.shape(p)) / np.sqrt(n)).astype(np.float32), params)


def jax_model_and_shapes(cfg):
    """The JAX AVDiffusionModel of `cfg` and its params' shapes, traced with
    jax.eval_shape (nothing is run)."""
    from flax.core import meta

    from multimodal_diffusion_tpu.models.diffusion import (AVDiffusionConfig as JaxConfig,
                                                           AVDiffusionModel as JaxModel)

    model = JaxModel(JaxConfig.from_config(cfg, dtype=jnp.float32))
    mini = JT.minimal_init_shapes(cfg)
    T = int(cfg["diffusion"]["video"]["steps"])
    shapes = jax.eval_shape(lambda: meta.unbox(model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros(mini["video"]), jnp.zeros(mini["audio"]),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32), jnp.zeros(mini["z_video"]),
        jnp.zeros(mini["z_audio"]), jnp.ones((T,)), jnp.ones((T,)))["params"]))
    return model, shapes


def jax_params(cfg, seed=0):
    """Seeded N(0, 0.05) params in the JAX model's tree and shapes."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: rng.normal(0, 0.05, s.shape).astype(np.float32),
                                  jax_model_and_shapes(cfg)[1])


def jax_state_tree(cfg, seed=0):
    """A JAX training-state tree as the JAX package's state_to_tree gives it:
    seeded params, the optax state of make_optimizer(cfg) after three
    updates (global grad norm 3, then 0.5 and 0.2: clipped once), an EMA of
    the config's scope, step 3; plus the jitted optimizer step (grads,
    opt_state, params) -> (params, opt_state)."""
    params = jax_params(cfg, seed)
    tx, _ = JT.make_optimizer(cfg)
    opt_state = jax.jit(tx.init)(params)
    step = jax.jit(lambda g, s, p: _apply(tx, g, s, p))
    p = params
    for i, scale in enumerate((3.0, 0.5, 0.2)):
        p, opt_state = step(_grads(params, 10 * seed + i, scale), opt_state, p)
    scope = cfg["training"]["ema"]["scope"]
    ema = perturb(params if scope == "all" else params["core"], seed + 5)
    tree = {"step": np.asarray(STEP, np.int32), "params": jax.device_get(p),
            "opt_state": jax.device_get(opt_state), "ema_core": ema}
    return tree, step


def _apply(tx, grads, opt_state, params):
    updates, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state


def save_jax(tree, ckpt_dir, chunk_byte_size=None):
    """Save with the JAX package's CheckpointManager (chunk_byte_size: split
    each array into chunks of at most that many bytes, through orbax's
    SaveArgs)."""
    import orbax.checkpoint as ocp

    mgr = JC.CheckpointManager(ckpt_dir)
    if chunk_byte_size is None:
        mgr.save(STEP, tree, meta={"experiment": "interchange"}, wait=True)
    else:
        args = jax.tree_util.tree_map(lambda _: ocp.SaveArgs(chunk_byte_size=chunk_byte_size),
                                      tree)
        mgr._mgr.save(STEP, args=ocp.args.StandardSave(tree, save_args=args))
        mgr.wait()
    mgr.close()
    return Path(ckpt_dir)


def orbax_restore(ckpt_dir, step=STEP, template=None):
    mgr = JC.CheckpointManager(ckpt_dir)
    out = mgr.restore(step, template=template)
    mgr.close()
    return out


def _structure(tree):
    """The containers of a tree (type and keys), leaves replaced by 'leaf'."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree).__name__, [_structure(v) for v in tree]
    return None if tree is None else "leaf"


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_bit_equal_to_orbax(port_tree, orbax_tree):
    """Same containers, same leaves: every leaf's dtype and bits equal
    (orbax's restore without a template gives a 0-d array the shape [1];
    the port keeps the stored shape [])."""
    assert _structure(port_tree) == _structure(orbax_tree)
    port = dict(R.tree_leaves(port_tree))
    ref = dict(R.tree_leaves(orbax_tree))
    assert port.keys() == ref.keys()
    for path, t in port.items():
        want = np.asarray(ref[path])
        assert str(t.dtype).split(".")[-1] == want.dtype.name, path
        got = t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        if got.shape == () and want.shape == (1,):
            want = want.reshape(())
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, _bits(want), err_msg="/".join(path))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """{case: (cfg, the tree saved, its jitted optimizer step, the
    checkpoint dir)}."""
    out = {}
    for name, cfg in CASES.items():
        tree, tx = jax_state_tree(cfg, seed=len(out))
        out[name] = (cfg, tree, tx, save_jax(tree, tmp_path_factory.mktemp(name)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_reader_matches_orbax_bit_for_bit(written, case):
    cfg, tree, _, ckpt = written[case]
    step, port = R.read_orbax_checkpoint(ckpt)
    assert step == STEP and R.orbax_steps(ckpt) == [STEP]
    assert_bit_equal_to_orbax(port, orbax_restore(ckpt))
    assert R.read_meta(ckpt, STEP) == {"experiment": "interchange"}
    mv = torch.bfloat16 if case == "bf16" else torch.float32
    adam = TC._nodes_with(port["opt_state"], {"count", "mu", "nu"})
    assert len(adam) == 1 and int(adam[0]["count"]) == (1 if case == "multisteps" else 3)
    assert {t.dtype for _, t in R.tree_leaves(adam[0]["mu"])} == {mv}
    assert bool(TC._nodes_with(port["opt_state"], {"mini_step", "acc_grads"})) == (
        case == "multisteps")


def test_reader_reads_arrays_split_into_chunks(written, tmp_path):
    """chunk_byte_size 1 KiB: the [64, 192] qkv kernels are 48 chunks of
    [4, 64], ragged edges included; 0-d and 1-D leaves too."""
    ckpt = save_jax(written["bf16"][1], tmp_path, chunk_byte_size=1024)
    store = R.OcdbtStore(ckpt / str(STEP) / R.ITEM)
    meta = json.loads(store.read("params.core.block_0.attn.qkv.kernel/.zarray"))
    assert meta["shape"] == [64, 192] and meta["chunks"] != meta["shape"]
    chunk_keys = [k for k in store.keys()
                  if k.startswith(b"params.core.block_0.attn.qkv.kernel/") and b".z" not in k]
    assert len(chunk_keys) > 1
    _, port = R.read_orbax_checkpoint(ckpt)
    assert_bit_equal_to_orbax(port, orbax_restore(ckpt))


def test_reader_reads_python_scalars_and_empty_containers(tmp_path):
    """Python int and float leaves (orbax's 'scalar' kind) come back as
    Python numbers, a numpy scalar as a 0-d tensor, empty containers as
    themselves, as orbax restores them."""
    tree = {"a": 3, "b": 2.5, "c": np.float32(1.5), "d": {}, "e": (np.arange(3),)}
    mgr = JC.CheckpointManager(tmp_path)
    mgr.save(1, tree, wait=True)
    mgr.close()
    step, port = R.read_orbax_checkpoint(tmp_path)
    ref = orbax_restore(tmp_path, 1)
    assert (port["a"], port["b"], port["d"]) == (ref["a"], ref["b"], ref["d"]) == (3, 2.5, {})
    assert type(port["a"]) is int and type(port["b"]) is float
    assert port["c"].shape == () and float(port["c"]) == 1.5
    assert_bit_equal_to_orbax({"e": port["e"]}, {"e": ref["e"]})


def test_store_lists_and_reads_what_tensorstore_does(written, tmp_path):
    """Every key and value of an orbax step's OCDBT store, and of a store
    tensorstore writes with 400-byte nodes (interior nodes, values in data
    files beside inline ones) over 12 commits."""
    import tensorstore as ts

    root = written["bf16"][3] / str(STEP) / R.ITEM
    kv = ts.KvStore.open(f"file://{root}/|ocdbt:").result()
    keys = kv.list().result()
    store = R.OcdbtStore(root)
    assert sorted(keys) == store.keys()
    assert all(kv[k] == store.read(k) for k in keys)

    small = tmp_path / "small"
    spec = ts.KvStore.Spec(f"file://{small}/|ocdbt:").to_json()
    spec["config"] = {"max_decoded_node_bytes": 400, "max_inline_value_bytes": 16}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(0)
    for commit in range(12):
        for i in rng.choice(60, 8, replace=False):
            kv[f"k{i:03d}/{'x' * (i % 7)}"] = rng.bytes(int(rng.integers(0, 40)))
    store = R.OcdbtStore(small)
    keys = kv.list().result()
    assert sorted(keys) == store.keys() and len(keys) > 40
    assert all(kv[k] == store.read(k) for k in keys)
    assert store.read("no/such/key") is None


def _copy_step(src, dst):
    shutil.copytree(src, dst)
    return dst / str(STEP) / R.ITEM


def _edit_metadata(item, fn):
    meta = json.loads((item / "_METADATA").read_text())
    fn(meta)
    (item / "_METADATA").write_text(json.dumps(meta))


def _flip_manifest_byte(item):
    b = bytearray((item / "manifest.ocdbt").read_bytes())
    b[20] ^= 1
    (item / "manifest.ocdbt").write_bytes(bytes(b))


BREAKS = {
    "zarr3": (lambda item: _edit_metadata(item, lambda m: m.update(use_zarr3=True)), "zarr3"),
    "no_ocdbt": (lambda item: _edit_metadata(item, lambda m: m.update(use_ocdbt=False)), "OCDBT"),
    "two_writers": (lambda item: (item / "ocdbt.process_1").mkdir(), "2 writing processes"),
    "checksum": (_flip_manifest_byte, "checksum"),
    "value_type": (lambda item: _edit_metadata(item, lambda m: next(iter(
        m["tree_metadata"].values()))["value_metadata"].update(value_type="string",
                                                               skip_deserialize=False)),
                   "value type"),
    "missing_chunk": (None, "missing"),
}


@pytest.mark.parametrize("case", list(BREAKS))
def test_reader_raises_on_what_it_does_not_read(written, tmp_path, case):
    item = _copy_step(written["fp32"][3], tmp_path / "ckpt")
    brk, match = BREAKS[case]
    if brk is not None:
        brk(item)
        with pytest.raises(R.OrbaxFormatError, match=match):
            R.read_orbax_checkpoint(tmp_path / "ckpt")
        return
    store = R.OcdbtStore(item)
    del store._values[b"params.core.RMSNorm_0.scale/0"]
    with pytest.raises(R.OrbaxFormatError, match=match):
        R.read_array(store, "params.core.RMSNorm_0.scale")


@pytest.mark.parametrize("zarray,match", [
    ({"compressor": {"id": "blosc"}}, "compressor"),
    ({"dimension_separator": "/"}, "separator"),
    ({"dtype": ">f4"}, "dtype"),
    ({"zarr_format": 3}, "zarr_format"),
])
def test_read_array_raises_on_other_zarr_layouts(zarray, match):
    class Store:
        def read(self, key):
            meta = {"zarr_format": 2, "shape": [2], "chunks": [2], "dtype": "<f4",
                    "compressor": None, "filters": None, "order": "C"}
            meta.update(zarray)
            return json.dumps(meta).encode() if key.endswith(".zarray") else bytes(8)

    with pytest.raises(R.OrbaxFormatError, match=match):
        R.read_array(Store(), "a")


def test_tmp_directories_and_port_steps_are_not_orbax_steps(written, tmp_path):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(written["fp32"][3], ckpt)
    shutil.copytree(ckpt / str(STEP), ckpt / "5.orbax-checkpoint-tmp-123")
    (ckpt / "7").mkdir()
    torch.save({}, ckpt / "7" / "params.pt")
    assert R.orbax_steps(ckpt) == [STEP]
    assert TC.checkpoint_format(ckpt / "7") == "port"
    assert TC.checkpoint_format(ckpt / str(STEP)) == "jax"
    assert TC.checkpoint_format(ckpt / "5.orbax-checkpoint-tmp-123") == "jax"


@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("n", [0, 5, 70_000, 1_500_000])
def test_zstd_decompresses_what_zstandard_compresses(n, content_size):
    import zstandard

    rng = np.random.default_rng(n)
    data = rng.integers(0, 4, n, dtype=np.uint8).tobytes()
    frame = zstandard.ZstdCompressor(level=3, write_content_size=content_size).compress(data)
    assert zstd.decompress(frame).tobytes() == data
    assert zstd.decompress(frame + frame, size_hint=2 * n).tobytes() == data + data
    with pytest.raises(ValueError):
        zstd.decompress(b"not a frame")


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------


def test_fixture_leaves_match_leaves_json_and_orbax():
    """The port reads every leaf of tests/torch_fixtures/orbax_spec8_tiny
    bit-equal to orbax's restore and to leaves.json's sha256 (what
    chip_smoke.py checks on the card); the fixture stays under 2 MB."""
    ckpt = FIXTURE / "ckpt"
    step, port = R.read_orbax_checkpoint(ckpt)
    assert step == FIXTURE_STEPS
    assert_bit_equal_to_orbax(port, orbax_restore(ckpt, FIXTURE_STEPS))
    records = {r["path"]: r for r in json.loads((FIXTURE / "leaves.json").read_text())}
    leaves = {"/".join(p): t for p, t in R.tree_leaves(port)}
    assert leaves.keys() == records.keys()
    for path, t in leaves.items():
        bits = t.view(torch.uint16) if t.dtype == torch.bfloat16 else t
        assert hashlib.sha256(bits.numpy().tobytes()).hexdigest() == records[path]["sha256"]
        assert str(t.dtype).split(".")[-1] == records[path]["dtype"]
    assert yaml.safe_load((FIXTURE / "config.yaml").read_text()) == fixture_cfg()
    assert sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file()) < 2_000_000


# ---------------------------------------------------------------------------
# restore_jax_state
# ---------------------------------------------------------------------------


def _restored_bundle(written, case):
    cfg, tree, tx, ckpt = written[case]
    bundle = TT.create_trainer(cfg, device="cpu")
    TC.restore_jax_state(bundle.state, R.read_orbax_checkpoint(ckpt)[1])
    return bundle


@pytest.mark.parametrize("case", ["fp32", "bf16", "multisteps"])
def test_restored_optimizer_next_update_matches_optax(written, case):
    """Two more updates (MultiSteps: the pending micro-batch completes an
    update, the next starts one) from the restored AdamW against optax's
    tx.update from the restored opt_state: fp32 params and moments 1e-6;
    bf16 moments within one bf16 ulp (2^-8 relative), params within
    1.5 * 2^-8 of the summed LRs."""
    cfg, tree, tx, ckpt = written[case]
    bundle = _restored_bundle(written, case)
    opt = bundle.state.optimizer
    template = {"step": tree["step"], "params": tree["params"], "opt_state": tree["opt_state"],
                "ema_core": tree["ema_core"]}
    restored = orbax_restore(ckpt, template=template)
    j_params, j_state = restored["params"], restored["opt_state"]
    for i in range(2):
        g = _grads(tree["params"], 100 + i, 0.4)
        j_params, j_state = tx(g, j_state, j_params)
        sd = jax_params_to_state_dict(g)
        opt.step([sd[n] for n in opt.names])
    want = jax_params_to_state_dict(j_params)
    # bf16 moments: a rounding tie of a stored moment can fall either way
    # (tests/test_torch_flagship.py::test_optimizer_across_a_recon_boundary_
    # matches_optax), moving a parameter by up to 1.5 * 2^-8 of the LRs
    # applied since
    lrs = sum(TT.make_lr_schedule(cfg)(c) for c in range(STEP, opt.count))
    p_tol = 1e-6 if case != "bf16" else 1.5 * 2 ** -8 * lrs
    for name, p in bundle.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=p_tol, err_msg=name)
    adam = [s for s in jax.tree_util.tree_leaves(
        j_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    assert opt.count == int(adam.count)
    tol = 1e-6 if case != "bf16" else 2 ** -8
    moments = [("mu", opt.mu, adam.mu), ("nu", opt.nu, adam.nu)]
    if case == "multisteps":
        assert opt.mini_step == int(j_state.mini_step) == 1
        moments.append(("acc", opt.acc, j_state.acc_grads))
    for key, mine, theirs in moments:
        ref = jax_params_to_state_dict(theirs)
        for n, t in zip(opt.names, mine):
            r = ref[n].numpy()
            np.testing.assert_allclose(t.float().numpy(), r, rtol=tol,
                                       atol=tol * np.abs(r).max(), err_msg=f"{key} {n}")


@pytest.mark.parametrize("case", ["fp32", "ema_all"])
def test_restored_state_holds_the_tree(written, case):
    """Params, EMA (keyed by the port's names, scope core or all), step,
    count, mini_step and the accumulator are the tree's, bit for bit; the
    generator is the config's seed's."""
    cfg, tree, _, _ = written[case]
    bundle = _restored_bundle(written, case)
    state = bundle.state
    assert state.step == STEP
    for name, t in jax_params_to_state_dict(tree["params"]).items():
        assert torch.equal(dict(bundle.model.named_parameters())[name].detach(), t), name
    ema = tree["ema_core"] if case == "ema_all" else {"core": tree["ema_core"]}
    want = jax_params_to_state_dict(ema)
    assert state.ema.keys() == want.keys()
    assert all(torch.equal(state.ema[k], want[k]) for k in want)
    fresh = TT.create_trainer(cfg, device="cpu")
    assert torch.equal(state.generator.get_state(), fresh.state.generator.get_state())


def test_restore_refuses_a_mismatched_config(written):
    tree = R.read_orbax_checkpoint(written["fp32"][3])[1]
    for cfg, match in ((_cfg("bf16"), "mv_dtype"), (_cfg(accum=2), "grad_accum_steps"),
                       (_cfg(scope="all"), "scope")):
        with pytest.raises(ValueError, match=match):
            TC.restore_jax_state(TT.create_trainer(cfg, device="cpu").state, tree)


@pytest.fixture(scope="module")
def loss_inputs():
    cfg = CASES["fp32"]
    s = JT.latent_shapes_from_config(cfg, 2)
    rng = np.random.default_rng(0)
    batch = {"video": rng.uniform(0, 1, s["video"]).astype(np.float32),
             "audio": rng.uniform(-1, 1, s["audio"]).astype(np.float32),
             "has_video": np.array([True, True]), "has_audio": np.array([True, False])}
    draws = {"t_v": np.array([10, 900]), "t_a": np.array([500, 3]),
             "noise_v": rng.normal(size=s["z_video"]).astype(np.float32),
             "noise_a": rng.normal(size=s["z_audio"]).astype(np.float32),
             "cfg_u": np.array([0.05, 0.9], np.float32), "clean_u": np.array([0.5, 0.5],
                                                                             np.float32)}
    _, abar = JS.alphas_cumprod_from_betas(JS.make_beta_schedule(1000, "cosine", 1e-4, 0.02))
    return s, batch, draws, abar


def test_restored_loss_and_every_grad_match_jax(written, loss_inputs):
    """The restored model's train loss (audio the target, fixed draws, no
    dropout) within 1e-5 relative of the JAX package's on the checkpoint's
    params; every grad within 2e-4 of its largest magnitude."""
    cfg, tree, _, _ = written["fp32"]
    s, batch, d, abar = loss_inputs
    jm = jax_model_and_shapes(cfg)[0]
    keep_nt = 1.0 - (d["cfg_u"] < 0.1).astype(np.float32)

    def loss_fn(p):
        out = jm.apply({"params": p}, batch["video"], batch["audio"], d["t_v"], d["t_a"],
                       d["noise_v"], d["noise_a"], jnp.asarray(abar), jnp.asarray(abar),
                       jnp.asarray(keep_nt), jnp.ones(2), deterministic=True)
        return JL.mse_targets_only(out["eps_v"], out["eps_a"], out["eps_true_v"],
                                   out["eps_true_a"], jnp.asarray(0.0),
                                   jnp.asarray(batch["has_video"]),
                                   jnp.asarray(batch["has_audio"]))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(tree["params"])
    j_grads = jax_params_to_state_dict(j_grads)
    model = _restored_bundle(written, "fp32").model.eval()
    sc = TT.StepConfig(z_video_shape=s["z_video"], z_audio_shape=s["z_audio"], T_v=1000,
                       T_a=1000, cfg_drop_prob=0.1)
    ab = torch.from_numpy(abar)
    loss, _ = TT.train_loss(model, sc, ab, ab, TT.batch_to_device(batch, torch.device("cpu")),
                            0.0, {k: torch.from_numpy(v) for k, v in d.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    for name, p in model.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        ref = j_grads[name].numpy()
        np.testing.assert_allclose(g, ref, rtol=0, atol=2e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=name)


def test_build_components_reads_a_jax_checkpoint(written):
    """paths.ckpt_path at an orbax directory, at <dir>/<step> and at
    <dir>/latest: the params, or with use_ema the params with the EMA core."""
    cfg, tree, _, ckpt = written["fp32"]
    want = jax_params_to_state_dict(tree["params"])
    ema = jax_params_to_state_dict({"core": tree["ema_core"]})
    for path in (ckpt, ckpt / str(STEP), ckpt / "latest"):
        for use_ema in (False, True):
            c = {**cfg, "paths": {"ckpt_path": str(path)}}
            sd = sample_clip.build_components(c, device="cpu", use_ema=use_ema).state_dict()
            for k, v in want.items():
                assert torch.equal(sd[k], ema.get(k, v) if use_ema else v), (path, k)


def test_a_named_checkpoint_that_is_not_there_raises(written, tmp_path, capsys):
    """--ckpt naming a missing .pt, a missing directory, an empty one or a
    missing step raises; a config's own paths.ckpt_path that holds nothing
    samples with seeded random weights after a warning, as the JAX package
    does."""
    cfg, _, _, ckpt = written["fp32"]
    (tmp_path / "empty").mkdir()
    for path in (tmp_path / "step_1.pt", tmp_path / "absent", tmp_path / "absent" / "latest",
                 tmp_path / "empty", tmp_path / "empty" / "latest", ckpt / "9"):
        with pytest.raises(FileNotFoundError, match="--ckpt"):
            sample_clip.config_with_checkpoint(cfg, str(path))
    assert sample_clip.config_with_checkpoint(cfg, str(ckpt / "latest"))["paths"][
        "ckpt_path"] == str(ckpt / "latest")
    c = {**cfg, "paths": {"ckpt_path": str(tmp_path / "absent" / "latest")}}
    sd = sample_clip.build_components(c, device="cpu").state_dict()
    assert "[warn] checkpoint path" in capsys.readouterr().out
    fresh = sample_clip.build_components({**cfg, "paths": {}}, device="cpu").state_dict()
    assert "[info] no ckpt_path" in capsys.readouterr().out
    assert all(torch.equal(sd[k], v) for k, v in fresh.items())


def test_train_joint_resumes_from_a_jax_checkpoint(written, tmp_path, monkeypatch):
    """The JAX package's step-3 checkpoint in paths.ckpt_dir: --resume
    restores it through restore_jax_state and trains on to step 5, saving
    the port's own checkpoint beside it."""
    from multimodal_diffusion_torch.datasets.records import write_record_shards
    from multimodal_diffusion_torch.train import train_joint

    cfg, tree, _, ckpt = written["bf16"]
    cfg = json.loads(json.dumps(cfg))
    run = tmp_path / "run"
    shutil.copytree(ckpt, run / "ckpt")
    rng = np.random.default_rng(3)
    write_record_shards(({"video": rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
                          "audio": rng.uniform(-1, 1, 8000).astype(np.float32)}
                         for _ in range(4)), tmp_path / "records", video_shape=(8, 32, 32, 3),
                        audio_shape=(8000,), clips_per_shard=4, fps=8, sr=8000)
    cfg["paths"] = {"out_root": str(run), "ckpt_dir": str(run / "ckpt"),
                    "log_dir": str(run / "logs"), "samples_dir": str(run / "samples")}
    cfg["data"].update(records_dir=str(tmp_path / "records"), device_resident=True,
                       device_preprocess=True, num_workers=2)
    cfg["data"].pop("val_split_glob", None)
    cfg["training"].update(log_every=1, ckpt_every=100, val_every=0)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    restored = []
    real = TC.restore_jax_state

    def spy(state, t):
        real(state, t)
        restored.append({k: v.clone() for k, v in state.model.state_dict().items()})

    class Writer:  # the metrics, without TensorBoard's import
        def __init__(self, log_dir):
            self.rows = []

        def write(self, step, scalars):
            self.rows.append(step)

        def close(self):
            pass

    monkeypatch.setattr(train_joint, "restore_jax_state", spy)
    monkeypatch.setattr(train_joint, "MetricWriter", Writer)
    state = train_joint.main(["--config", str(path), "--device", "cpu", "--resume",
                              "--max-steps", "5"])
    assert state.step == 5 and len(restored) == 1
    want = jax_params_to_state_dict(tree["params"])
    assert all(torch.equal(restored[0][k], v) for k, v in want.items())
    assert TC.checkpoint_format(run / "ckpt" / "5") == "port"
    assert R.orbax_steps(run / "ckpt") == [STEP]


# ---------------------------------------------------------------------------
# the inverse carry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make_cfg", [shrunk_cfg, shrunk_flagship_cfg], ids=["mvp", "flagship"])
def test_state_dict_to_jax_params_is_the_exact_inverse(make_cfg):
    """JAX params (the model's own tree and shapes) -> the port -> back, bit
    for bit; and the port model's state_dict lands on exactly that tree."""
    cfg = make_cfg()
    params = jax_params(cfg, seed=1)
    sd = jax_params_to_state_dict(params)
    back = state_dict_to_jax_params(sd)
    a, b = dict(_leaves(params)), dict(_leaves(back))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))
    again = jax_params_to_state_dict(back)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    port = AVDiffusionModel(AVDiffusionConfig.from_config(cfg)).state_dict()
    from_port = dict(_leaves(state_dict_to_jax_params(port)))
    assert {k: v.shape for k, v in from_port.items()} == {k: v.shape for k, v in a.items()}


_DENOISE = {}


def _denoise(jm):
    """jax.jit of the JAX model's denoise_tokens (params, *inputs), the video
    grid static; one per model."""
    if id(jm) not in _DENOISE:
        _DENOISE[id(jm)] = jax.jit(
            lambda p, *a: jm.apply({"params": p}, *a, method=jm.denoise_tokens),
            static_argnums=(5,))
    return _DENOISE[id(jm)]


def test_exported_npz_runs_in_the_jax_model(tmp_path):
    """A port checkpoint (written by its CheckpointManager) -> export to
    .npz -> the JAX model on those params gives the port's denoiser output
    within 1e-5."""
    cfg = shrunk_cfg()
    jm, _ = jax_model_and_shapes(cfg)
    tm = torch_model(cfg, jax_params(cfg, seed=2))
    TC.CheckpointManager(tmp_path / "ckpt").save(1, {"params": tm.state_dict(), "ema_core": {}})
    from multimodal_diffusion_torch.tools import export_jax_params

    export_jax_params.main(["--ckpt", str(tmp_path / "ckpt"), "--out", str(tmp_path / "p.npz")])
    tree = {}
    for path, a in np.load(tmp_path / "p.npz").items():
        node = tree
        for k in path.split("/")[:-1]:
            node = node.setdefault(k, {})
        node[path.split("/")[-1]] = a
    rng = np.random.default_rng(0)
    tok_v = rng.normal(size=(2, 8, 16)).astype(np.float32)
    tok_a = rng.normal(size=(2, 12, 32)).astype(np.float32)
    t = np.array([3, 700])
    j = _denoise(jm)(tree, tok_v, tok_a, t, t, (2, 2, 2))
    with torch.no_grad():
        p = tm.denoise_tokens(torch.from_numpy(tok_v), torch.from_numpy(tok_a),
                              torch.from_numpy(t), torch.from_numpy(t), (2, 2, 2))
    for key in ("eps_v", "eps_a"):
        np.testing.assert_allclose(t2n(p[key]), np.asarray(j[key]), rtol=1e-5, atol=1e-5)
    assert len(export_params(tm.state_dict(), tmp_path / "q.npz")) == len(tm.state_dict())


# ---------------------------------------------------------------------------
# the reference implementation's checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    """The reference config (d=256, 4 layers, 4 heads of 64), the JAX model
    and its params from step_650.pt through tools/port_reference_checkpoint.py
    (live and EMA), and the port's model loaded from the same file."""
    from multimodal_diffusion_tpu.utils.io import load_config
    from tools.port_reference_checkpoint import port_reference_state

    cfg = load_config(REF_DIR / "config.yaml")
    cfg["diffusion"]["audio"]["sampler_steps"] = 3
    jm, shapes = jax_model_and_shapes(cfg)
    template = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), shapes)
    raw = torch.load(REF_DIR / "step_650.pt", map_location="cpu", weights_only=True)
    ref_state = {k: {kk: vv.numpy() for kk, vv in v.items()}
                 for k, v in raw.items() if isinstance(v, dict) and k != "opt"}
    out = {}
    for use_ema in (False, True):
        j_params = port_reference_state(ref_state, cfg, template, use_ema=use_ema)
        tm = AVDiffusionModel(AVDiffusionConfig.from_config(cfg, dtype=torch.float32))
        step, sd = reference_state_dict(REF_DIR / "step_650.pt", cfg, tm, use_ema)
        assert step == 650
        tm.load_state_dict(sd, strict=True)
        out[use_ema] = (j_params, tm.eval())
    return cfg, jm, out


@pytest.mark.parametrize("use_ema", [False, True], ids=["live", "ema"])
def test_reference_checkpoint_denoise_matches_jax(reference, use_ema):
    """5,250,996 parameters loaded strictly; denoise_tokens (96 video + 37
    audio tokens, CFG-style keep flags) within 1e-5 of the JAX package."""
    cfg, jm, out = reference
    j_params, tm = out[use_ema]
    assert sum(p.numel() for p in tm.parameters()) == 5_250_996
    assert all(float(v.abs().max()) == 0 for k, v in tm.state_dict().items()
               if k.startswith("embed."))
    rng = np.random.default_rng(5)
    tok_v = rng.normal(size=(2, 96, 256)).astype(np.float32)
    tok_a = rng.normal(size=(2, 37, 32)).astype(np.float32)
    t_v, t_a = np.array([0, 0]), np.array([999, 412])
    keep = np.array([1.0, 0.0], np.float32)
    j = _denoise(jm)(j_params, tok_v, tok_a, t_v, t_a, (6, 4, 4), keep, np.ones(2, np.float32))
    with torch.no_grad():
        p = tm.denoise_tokens(*(torch.from_numpy(x) for x in (tok_v, tok_a, t_v, t_a)),
                              (6, 4, 4), torch.from_numpy(keep), torch.ones(2))
    for key in ("eps_v", "eps_a", "h_v", "h_a"):
        ref = np.asarray(j[key])
        np.testing.assert_allclose(t2n(p[key]), ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()), err_msg=key)


def test_reference_checkpoint_v2a_sample_matches_jax(reference):
    """One v2a clip (B = 1, 3 DDIM steps, guidance 3) with the EMA weights:
    the sampled latent within 1e-4 of its magnitude. The reference predicts
    eps: after 3 steps the latent still carries the first step's division by
    sqrt(alpha_bar[999]) = 4.9e-5, and the decoder's tanh saturates, so the
    waveforms are compared only for shape and finiteness (as
    tests/test_torch_slice.py does under eps)."""
    from multimodal_diffusion_torch.infer.ddim import sampler_from_config as t_sampler
    from multimodal_diffusion_tpu.infer.ddim import sampler_from_config as j_sampler

    cfg, jm, out = reference
    j_params, tm = out[True]
    rng = np.random.default_rng(6)
    video = rng.uniform(0, 1, (1, 3, 48, 128, 128)).astype(np.float32)
    z_init = rng.normal(size=(1, 8, 150)).astype(np.float32)
    var = {"params": j_params}
    j_sample, _ = j_sampler(jm, cfg, target="audio")
    j_z = np.asarray(j_sample(j_params, jm.apply(var, jnp.asarray(video),
                                                 method=jm.encode_video), jnp.asarray(z_init)))
    j_wav = np.asarray(jm.apply(var, jnp.asarray(j_z), method=jm.decode_audio))
    t_sample, _ = t_sampler(cfg, target="audio")
    with torch.inference_mode():
        t_z = t_sample(tm, tm.encode_video(torch.from_numpy(video)), torch.from_numpy(z_init))
        t_wav = t2n(tm.decode_audio(t_z))
    np.testing.assert_allclose(t2n(t_z), j_z, rtol=0, atol=1e-4 * max(1.0, np.abs(j_z).max()))
    assert t_wav.shape == j_wav.shape == (1, 1, 48000) and np.all(np.isfinite(t_wav))


def test_build_components_reads_the_reference_pt(reference):
    """paths.ckpt_path naming the .pt (and the sampling CLI's --ckpt):
    strictly loaded, the EMA core with use_ema."""
    cfg, _, out = reference
    for use_ema in (False, True):
        c = sample_clip.config_with_checkpoint(cfg, str(REF_DIR / "step_650.pt"))
        sd = sample_clip.build_components(c, device="cpu", use_ema=use_ema).state_dict()
        want = out[use_ema][1].state_dict()
        assert all(torch.equal(sd[k], want[k]) for k in want)
