"""Rank bodies of the port's multi-rank tests, run by
``multimodal_diffusion_torch.parallel.launch.run_ranks`` in spawned
processes. This module imports no JAX: a spawned child imports it to find
its function, and the JAX references run in the test process only.

Every body takes numpy inputs and returns numpy outputs (rank order), so
the test process compares them with the JAX package's run and with the
port's one-process run."""

from __future__ import annotations

import numpy as np
import torch

from multimodal_diffusion_torch.parallel.mesh import make_mesh


AXES = ("data", "model", "context", "pipe")


def mesh_of(layout):
    """make_mesh over the axes of a parallel block (other keys ignored)."""
    return make_mesh(**{k: v for k, v in layout.items() if k in AXES})


def _t(x, **kw):
    return None if x is None else torch.as_tensor(np.asarray(x), **kw)


def _n(x):
    """A numpy copy (a CPU fp32 tensor's .numpy() would share its memory)."""
    return None if x is None else x.detach().float().cpu().numpy().copy()


def _whole(named, mesh):
    """{name: numpy} of the whole tensors of `named`: a split parameter's
    part (or its gradient's) is gathered over the mesh's 'model' group."""
    from multimodal_diffusion_torch.parallel.sharding import tp_gather

    group = None if mesh is None else mesh.group("model")
    return {n: None if t is None else _n(tp_gather(n, t, group)) for n, t in named}


def ring(rank, world, q, k, v, kv_valid, dout, impl):
    """ring_attention_sharded on the whole [B, H, N, Dh] held by every rank:
    (out, dq, dk, dv) with dout as the output's gradient."""
    from multimodal_diffusion_torch.ops.ring_attention import ring_attention_sharded

    mesh = make_mesh(data=1, model=1, context=world)
    q, k, v = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = ring_attention_sharded(q, k, v, mesh, "context", _t(kv_valid), impl)
    out.backward(_t(dout))
    return _n(out), _n(q.grad), _n(k.grad), _n(v.grad)


def core(rank, world, core_kw, layout, state, x, mask, dout, train=False, seed=0):
    """An MMDiT core (MMDiTConfig(**core_kw)) with `state` as its weights on
    the mesh `layout` (make_mesh kwargs): its output on x [B, N, d] (mask
    [B, N] True = PAD, or None) and the gradients of <out, dout> w.r.t. x
    and every parameter, the parameters' summed over the layout as the
    trainer sums them (and gathered whole over 'model')."""
    from multimodal_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig, set_dropout_generator
    from multimodal_diffusion_torch.train.trainer import reduce_gradients

    mesh = make_mesh(**layout)
    axes = {"context": "context_axis", "pipe": "pipe_axis", "model": "model_axis"}
    kw = {axes[a]: a for a in axes if mesh.size(a) > 1}
    net = MMDiT(MMDiTConfig(**core_kw, mesh=mesh, **kw))
    net.load_state_dict({k: _t(v) for k, v in state.items()})
    net.train(train)
    set_dropout_generator(net, torch.Generator().manual_seed(seed))
    xt = _t(x).requires_grad_(True)
    out = net(xt, _t(mask))
    (out.float() * _t(dout)).sum().backward()
    names = [n for n, _ in net.named_parameters()]
    grads = reduce_gradients(["core." + n for n in names], list(net.parameters()),
                             _core_only(mesh))
    return _n(out), _n(xt.grad), _whole(zip(names, grads), mesh)


def _core_only(mesh):
    """The mesh without its data axis: a core test feeds every rank the
    same batch, so nothing is summed over data."""
    class _NoData:
        def __init__(self, m):
            self.m = m

        def size(self, axis):
            return 1 if axis == "data" else self.m.size(axis)

        def group(self, axis):
            return self.m.group(axis)

        def members(self, axis):
            return self.m.members(axis)

    return _NoData(mesh)


def layout_cfg(cfg, layout):
    """cfg with the make_mesh kwargs `layout` over its parallel block."""
    return {**cfg, "parallel": {**(cfg.get("parallel") or {}), **layout}}


def train_step(rank, world, cfg, layout, state, batch, draws, target_is_video):
    """One train step through create_trainer on the mesh `layout` (the
    global batch and draws handed to every rank), from the weights `state`:
    (the step's metrics, the gradients the optimizer took, the parameters
    after the step), whole (a split parameter's parts gathered)."""
    from multimodal_diffusion_torch.train.trainer import create_trainer

    mesh = mesh_of(layout)
    bundle = create_trainer(layout_cfg(cfg, layout), device="cpu",
                            batch_size=len(batch["audio"]), mesh=mesh)
    model, st = bundle.model, bundle.state
    model.load_state_dict({k: _t(v) for k, v in state.items()})
    st.ema = {k: v.detach().clone() for k, v in model.named_parameters() if k in st.ema}
    taken = []
    step = st.optimizer.step
    st.optimizer.step = lambda grads: (taken.extend(
        torch.zeros_like(p) if g is None else g.clone()
        for p, g in zip(st.optimizer.params, grads)), step(grads))[1]
    metrics = bundle.train_step(st, batch, target_is_video,
                                {k: _t(v) for k, v in draws.items()})
    names = st.optimizer.names
    return ({k: float(v) for k, v in metrics.items()}, _whole(zip(names, taken), mesh),
            _whole(model.named_parameters(), mesh))


def sample(rank, world, cfg, layout, state, prompt_video, seed):
    """sample_one_direction (v2a) of the whole batch on the mesh `layout`."""
    from multimodal_diffusion_torch.infer.sample_clip import (build_components,
                                                              sample_one_direction)

    mesh = mesh_of(layout)
    cfg = layout_cfg(cfg, layout)
    model = build_components(cfg, device="cpu", mesh=mesh)
    model.load_state_dict({k: _t(v) for k, v in state.items()})
    out = sample_one_direction(cfg=cfg, model=model, prompt_modality="video",
                               prompt_video=prompt_video, device="cpu", mesh=mesh,
                               generator=torch.Generator().manual_seed(seed))
    return out["audio"]


def sampler_rows(rank, world, cfg, state, z_v0, z_init):
    """The port's v2a sampler (sampler_from_config) on this rank's rows of
    the global latents over a data mesh of `world`, gathered: the JAX
    package's batch-sharded sampling test, on ranks."""
    from multimodal_diffusion_torch.infer.ddim import sampler_from_config
    from multimodal_diffusion_torch.models.diffusion import AVDiffusionConfig, AVDiffusionModel
    from multimodal_diffusion_torch.parallel import comm
    from multimodal_diffusion_torch.parallel.sharding import shard_batch

    mesh = make_mesh(data=world)
    model = AVDiffusionModel(AVDiffusionConfig.from_config(cfg)).eval()
    model.load_state_dict({k: _t(v) for k, v in state.items()})
    sample, _ = sampler_from_config(cfg, target="audio")
    with torch.inference_mode():
        z = sample(model, shard_batch(mesh, _t(z_v0)), shard_batch(mesh, _t(z_init)))
        return _n(comm.all_gather(z, mesh.group("data"), 0))


def train_joint_cli(rank, world, argv):
    """train_joint.main under WORLD_SIZE = world (the launcher's group is
    already joined): the final state's step and parameters. The metric
    writer keeps to its JSONL file: TensorBoard's import (TensorFlow, ~10 s
    here) is made to fail."""
    import sys

    from multimodal_diffusion_torch.train import train_joint

    sys.modules["torch.utils.tensorboard"] = None
    state = train_joint.main(argv)
    return state.step, {n: _n(p) for n, p in state.model.named_parameters()}


def pipeline(rank, world, core_kw, state, x, mask, dout, n_microbatches):
    """mmdit_pipeline_apply of an ordinary MMDiT core over a pipe mesh of
    `world` stages: the output and the gradients of <out, dout> w.r.t. x
    and the parameters (summed over the stages)."""
    from multimodal_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
    from multimodal_diffusion_torch.parallel import comm
    from multimodal_diffusion_torch.parallel.pipeline import mmdit_pipeline_apply

    mesh = make_mesh(data=1, pipe=world)
    net = MMDiT(MMDiTConfig(**core_kw)).eval()
    net.load_state_dict({k: _t(v) for k, v in state.items()})
    xt = _t(x).requires_grad_(True)
    out = mmdit_pipeline_apply(net, xt, mesh, "pipe", n_microbatches, _t(mask))
    (out * _t(dout)).sum().backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in net.named_parameters()}
    comm.sum_over([g for n, g in grads.items() if n.startswith("blocks.")], mesh.group("pipe"))
    return _n(out), _n(xt.grad), {n: _n(g) for n, g in grads.items()}


def battery(rank, world, jobs):
    """Run several bodies of this module in one spawn: jobs is a list of
    (function name, args); returns their results in order."""
    return [globals()[name](rank, world, *args) for name, args in jobs]


def transfers(rank, world):
    """all_gather, the ring step, broadcast and send / recv over a group of
    `world` of bf16, fp16, bool and fp32 [2, 3, 2] tensors (rank r's hold
    100 r + 0..11): what each rank received, as fp32."""
    from multimodal_diffusion_torch.parallel import comm

    mesh = make_mesh(data=1, context=world)
    group, members = mesh.group("context"), mesh.members("context")
    out = {}
    for dtype in (torch.bfloat16, torch.float16, torch.bool, torch.float32):
        t = (torch.arange(12).reshape(2, 3, 2) + 100 * rank).to(dtype)
        got = [comm.all_gather(t, group, 1), comm.ring_exchange([t], group, members)[0],
               comm.broadcast_(t.clone(), members[0], group)]
        if rank == 0:
            comm.send(t, members[1], group)
        else:
            got.append(comm.recv(t, members[0], group))
        out[str(dtype)] = [_n(g) for g in got]
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def tp_trainer(rank, world, cfg, layout, state, batch, draws, target_is_video):
    """create_trainer on the mesh `layout` and one train step from the
    weights `state`: the seeded init gathered whole, this rank's tensors'
    shapes and bytes (parameters, the gradients the optimizer took, EMA,
    moments), the metrics, the gradients and the parameters after the step
    gathered whole, and this rank's own gradients of the replicated
    parameters."""
    from multimodal_diffusion_torch.parallel.sharding import is_split
    from multimodal_diffusion_torch.train.trainer import create_trainer

    mesh = mesh_of(layout)
    bundle = create_trainer(layout_cfg(cfg, layout), device="cpu",
                            batch_size=len(batch["audio"]), mesh=mesh)
    model, st = bundle.model, bundle.state
    init = _whole(model.named_parameters(), mesh)
    model.load_state_dict({k: _t(v) for k, v in state.items()})
    with torch.no_grad():
        for k, v in st.ema.items():
            v.copy_(dict(model.named_parameters())[k])
    taken = []
    step = st.optimizer.step
    st.optimizer.step = lambda grads: (taken.extend(
        torch.zeros_like(p) if g is None else g.float().clone()
        for p, g in zip(st.optimizer.params, grads)), step(grads))[1]
    metrics = bundle.train_step(st, batch, target_is_video,
                                {k: _t(v) for k, v in draws.items()})
    names, opt = st.optimizer.names, st.optimizer
    return {
        "init": init,
        "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
        "moment_shapes": {n: tuple(m.shape) for n, m in zip(names, opt.mu)},
        "ema_shapes": {n: tuple(v.shape) for n, v in st.ema.items()},
        "bytes": {"params": _nbytes(model.parameters()), "grads": _nbytes(taken),
                  "ema": _nbytes(st.ema.values()), "mu": _nbytes(opt.mu),
                  "nu": _nbytes(opt.nu)},
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": _whole(zip(names, taken), mesh),
        "replicated_grads": {n: _n(g) for n, g in zip(names, taken) if not is_split(n)},
        "params": _whole(model.named_parameters(), mesh),
    }


def tp_checkpoint_chain(rank, world, argv_model2, cfg_one, argv_resume, one_dir):
    """A checkpoint from model 2 to one process and back, in one spawn:
    train_joint under `argv_model2` (parallel.model 2) saves its last step;
    rank 0 restores it into a one-process trainer of `cfg_one` and saves
    that trainer's tree under `one_dir`; then train_joint `argv_resume`
    (model 2, --resume from `one_dir`) restores it. Returns the model-2
    run's final tree (gathered), the one-process tree (rank 0) and the
    tree the resumed model-2 run restored (gathered), and its last step."""
    import sys

    from multimodal_diffusion_torch.train import checkpoint as TC
    from multimodal_diffusion_torch.train import train_joint
    from multimodal_diffusion_torch.train.trainer import create_trainer

    sys.modules["torch.utils.tensorboard"] = None
    first = train_joint.main(argv_model2)
    first_tree = TC.state_to_tree(first)
    one_tree = None
    if rank == 0:
        bundle = create_trainer(cfg_one, device="cpu", mesh=make_mesh(world=1, rank=0))
        src = TC.CheckpointManager(cfg_one["paths"]["ckpt_dir"])
        TC.restore_state(bundle.state, src.restore())
        one_tree = TC.state_to_tree(bundle.state)
        TC.CheckpointManager(one_dir).save(one_tree["step"], one_tree)
    torch.distributed.barrier()
    restored = []

    def spy(state, tree):
        TC.restore_state(state, tree)
        restored.append(TC.state_to_tree(state))

    train_joint.restore_state = spy
    try:
        second = train_joint.main(argv_resume)
    finally:
        train_joint.restore_state = TC.restore_state
    return first_tree, one_tree, restored[0], second.step


def int8_core(rank, world, core_kw, layout, state, x):
    """An int8 MMDiT core (eval) with `state` on the mesh `layout`: its
    output on x, the gradient of the output's sum w.r.t. x (it flows
    through the activation scales, as the guided sampler's does), and this
    rank's qkv / out weight shapes."""
    from multimodal_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig

    mesh = make_mesh(**layout)
    kw = {"model_axis": "model"} if mesh.size("model") > 1 else {}
    net = MMDiT(MMDiTConfig(**core_kw, quant="int8", mesh=mesh, **kw)).eval()
    net.load_state_dict({k: _t(v) for k, v in state.items()})
    xt = _t(x).requires_grad_(True)
    out = net(xt)
    out.sum().backward()
    attn = net.blocks[0].attn
    return _n(out), _n(xt.grad), (tuple(attn.qkv.weight.shape), tuple(attn.out.weight.shape))


def nccl_tp_checkpoint(rank, world, cfg, batch, draws, n_steps):
    """parallel.model = world over NCCL, one card a rank: `n_steps` train
    steps from the seeded init, then the checkpoint tree that every rank
    gathers (state_to_tree), on the host."""
    from multimodal_diffusion_torch.train import checkpoint as TC
    from multimodal_diffusion_torch.train.trainer import create_trainer

    torch.cuda.set_device(rank)
    layout = {"data": 1, "model": world}
    bundle = create_trainer(layout_cfg(cfg, layout), device="cuda",
                            batch_size=len(batch["audio"]), mesh=mesh_of(layout))
    d = {k: _t(v).cuda() for k, v in draws.items()}
    for _ in range(n_steps):
        bundle.train_step(bundle.state, batch, 0.0, d)
    return TC.state_to_tree(bundle.state)


def reduced_replicated_grads(rank, world, layouts):
    """reduce_gradients on each mesh of `layouts` for a split parameter, a
    core block's replicated one and one outside the core, whose gradients
    differ by rank (10 rank + their index): what each rank gets back."""
    from multimodal_diffusion_torch.train.trainer import reduce_gradients

    names = ["core.blocks.0.attn.qkv.weight", "core.blocks.0.norm1.weight",
             "adapt_v.proj.weight"]
    out = []
    for layout in layouts:
        params = [torch.zeros(6, 4), torch.zeros(4), torch.zeros(3, 4)]
        for i, p in enumerate(params):
            p.grad = torch.full_like(p, float(10 * rank + i))
        out.append([float(g.flatten()[0]) for g in reduce_gradients(names, params,
                                                                    mesh_of(layout))])
    return out
