"""Joint A<->V diffusion training on one CUDA card (counterpart of the JAX
``train/trainer.py``).

One step: normalise the uint8 video on the device -> encode -> q_sample ->
denoise -> target-only MSE (+ alignment, sync and reconstruction losses) ->
backward -> global-norm clip -> AdamW (warmup-cosine LR, decoupled weight
decay on every parameter) -> EMA of the core. The attention of the core runs
through the flash-attention kernels, forward and backward. The
reconstruction decode runs on every ``training.recon_every``-th step only;
one step function serves both kinds of step.

Randomness is split from the body: ``draw_step_randomness`` draws a step's
timesteps, latent noise and CFG/clean-conditioning uniforms from the
trainer's ``torch.Generator``; the step body takes them as arguments, so a
test hands both frameworks the same numpy draws. Dropout draws from the same
generator. Nothing uses torch's global RNG.

``parallel.remat_core`` recomputes each core block's activations in the
backward pass (``models/mmdit.py::remat_block``). ``run_training`` logs the
denoiser's MFU (``utils/profiling.py::denoiser_train_flops``): the JAX
loop's formula at the tokens the core runs, the mouth-crop stream's too.

Layouts over ranks (``parallel.data``, ``model``, ``context``, ``pipe``;
``parallel/mesh.py``): every rank draws the one-process step's randomness
(and dropout masks) for the global batch and keeps its part. Under
``parallel.model: n`` a rank holds only its part of the core's split
projections (``parallel/sharding.py::is_split``), of their gradients, Adam
moments and EMA shadow, as the JAX package's parameter shardings place them
(its optimizer state and EMA inherit those shardings); everything else is
whole on every rank. After the backward pass the gradients are summed so
every rank holds its part of the one-process gradient:

  * over 'data', every gradient: each rank's loss is its rows' share of the
    global batch's loss (the losses divide by the global batch's counts,
    ``train/losses.py``), so the sum is the global loss's gradient;
  * over 'context' and over 'pipe', the core blocks' parameters: each rank
    runs them on its token shard, or its stage's blocks only.

Nothing is summed over 'model': a split parameter's part is reached only by
this rank's heads and units, so its gradient is already whole, and the
layouts' entry and exit collectives (``parallel/comm.py``) hand every rank
the whole gradient of every replicated parameter. Each such gradient (over
'model', and over 'context' or 'pipe' outside the core blocks) is then
taken from the group's first rank, one broadcast a step: the ranks compute
it alike, but equal only up to the kernels' nondeterminism, and a
replicated parameter must stay one value on every rank. The clip's global norm
sums the parts' squares over 'model' and counts each replicated parameter
once; AdamW and the EMA then run on each rank's tensors.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from itertools import islice
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..datasets.loader import copy_to_device, device_prefetch
from ..models.diffusion import AVDiffusionConfig, AVDiffusionModel, init_weights
from ..models.mmdit import set_dropout_generator, split_dropout
from ..ops import schedule as S
from ..parallel import comm
from ..parallel.mesh import make_mesh_from_config
from ..parallel.sharding import is_split, replicated, shard_batch, tp_gather, tp_part
from ..utils.io import compute_dtype_from_config, latent_shapes_from_config, resolve_device
from ..utils.profiling import calib_tflops, denoiser_train_flops, device_peak_flops
from .losses import (alignment_loss, mse_targets_only, reconstruction_loss,
                     sync_contrastive_loss)
from .mask_schedule import Any2AnySchedule


# ---------------------------------------------------------------------------
# learning rate and optimizer
# ---------------------------------------------------------------------------


def make_lr_schedule(cfg: Dict) -> Callable[[int], float]:
    """count -> learning rate, with optax's warmup_cosine_decay_schedule
    semantics (init 0, linear warmup to `lr` over max(1, warmup_steps), then
    cosine decay to 0 at max_steps), or a constant `lr`."""
    opt = cfg["training"]["optimizer"]
    sched = cfg["training"].get("scheduler", {}) or {}
    lr = float(opt["lr"])
    if str(sched.get("name", "none")).lower() != "cosine":
        return lambda count: lr
    warmup = max(1, int(sched.get("warmup_steps", 0)))
    total = max(int(cfg["training"].get("max_steps", 100_000)), warmup + 1)
    decay = total - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        done = min(count - warmup, decay)
        return lr * 0.5 * (1.0 + math.cos(math.pi * done / decay))

    return schedule


def global_norm(tensors: Sequence[torch.Tensor], split: Sequence[bool] = (),
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the device.
    Under tensor parallelism `split` flags the tensors that are this rank's
    parts over the 'model' `group`: their squares are summed over the group
    and the others' (whole, equal on every rank) counted once."""
    norms = torch.stack([n.float() for n in torch._foreach_norm(list(tensors))])
    if group is None or not any(split):
        return torch.linalg.vector_norm(norms)
    sq = norms.square()
    flags = torch.tensor(list(split), dtype=torch.bool, device=sq.device)
    return torch.sqrt(comm.all_reduce_(sq[flags].sum(), group) + sq[~flags].sum())


class AdamW:
    """optax.chain(clip_by_global_norm, adamw) with optax.MultiSteps
    accumulation, over torch._foreach ops.

    * clip: grads scaled by clip / norm when norm >= clip (no epsilon, as
      optax; torch's clip_grad_norm_ adds 1e-6);
    * Adam moments stored in `mv_dtype` (fp32 or bf16); all arithmetic is
      fp32 and the stored moments are rounded once per step, and the update
      reads the rounded moments;
    * decoupled weight decay on every parameter (biases, norm scales and
      embedding tables too), then the step by lr(count) read at the count
      before the increment: the first update of a warmup run moves nothing;
    * accum_steps > 1: the running mean of k micro-batch grads is applied
      every k-th call; the other calls change no parameter;
    * `tp_group`: the 'model' group under tensor parallelism; the split
      parameters are this rank's parts, and so are their moments and
      accumulator (the clip's norm is the whole model's, ``grad_norm``).
    """

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]],
                 lr_schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.05, clip_norm: float = 1.0,
                 mv_dtype: torch.dtype = torch.float32, accum_steps: int = 1,
                 tp_group=None):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.tp_group = tp_group
        self.tp_n, self.tp_i = comm.group_size(tp_group), comm.group_rank(tp_group)
        self.split = [self.tp_n > 1 and is_split(n) for n in self.names]
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.clip_norm, self.mv_dtype, self.accum_steps = clip_norm, mv_dtype, accum_steps
        self.count = 0  # applied updates (optax's inner count)
        self.mini_step = 0  # micro-batches accumulated since the last update
        self.mu = [torch.zeros_like(p, dtype=mv_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=mv_dtype) for p in self.params]
        self.acc = ([torch.zeros_like(p, dtype=torch.float32) for p in self.params]
                    if accum_steps > 1 else None)

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> bool:
        """Take one micro-batch's grads (None = zero); returns True when the
        parameters were updated."""
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(self.params, grads)]
        if self.acc is None:
            self._apply(grads)
            return True
        # running mean over the micro-batches (optax use_grad_mean)
        diff = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(diff, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, diff)
        if self.mini_step < self.accum_steps - 1:
            self.mini_step += 1
            return False
        self._apply(self.acc)
        torch._foreach_zero_(self.acc)
        self.mini_step = 0
        return True

    def grad_norm(self, grads: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """The whole model's global norm of `grads` (one per parameter; None
        is left out)."""
        kept = [(g, s) for g, s in zip(grads, self.split) if g is not None]
        return global_norm([g for g, _ in kept], [s for _, s in kept], self.tp_group)

    def _apply(self, grads: List[torch.Tensor]) -> None:
        norm = self.grad_norm(grads)
        factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                             self.clip_norm / norm)
        g = torch._foreach_mul(grads, factor)
        b1, b2 = self.b1, self.b2
        stored = self.mu + self.nu
        if self.mv_dtype == torch.float32:
            mv = stored  # updated in place
        else:
            mv = [torch.empty_like(x, dtype=torch.float32) for x in stored]
            torch._foreach_copy_(mv, stored)
        m, v = mv[:len(self.mu)], mv[len(self.mu):]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        if self.mv_dtype != torch.float32:
            torch._foreach_copy_(stored, mv)  # one rounding per step
            torch._foreach_copy_(mv, stored)  # the update reads the rounded moments
        lr = self.lr_schedule(self.count)
        self.count += 1
        denom = torch._foreach_div(v, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m, 1.0 - b1 ** self.count)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, self.params, alpha=self.wd)
        torch._foreach_add_(self.params, upd, alpha=-lr)

    def state_dict(self) -> Dict[str, Any]:
        """Count, mini-step and the moments (and accumulator) as CPU copies
        of whole tensors: under tensor parallelism the parts are gathered
        over the 'model' group where they live, before the copy to the host
        (every rank of the group calls it)."""
        def named(ts):
            return None if ts is None else {
                n: tp_gather(n, t.detach(), self.tp_group).cpu().clone()
                for n, t in zip(self.names, ts)}
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": named(self.mu), "nu": named(self.nu), "acc": named(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """The inverse of state_dict; a split parameter's moments may also
        be whole (a checkpoint's): this rank's part is cut."""
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for key in ("mu", "nu", "acc"):
            dst = getattr(self, key)
            if dst is None:
                continue
            for n, t in zip(self.names, dst):
                t.copy_(tp_part(n, state[key][n], t.shape, self.tp_n, self.tp_i))


def _mv_dtype(cfg: Dict) -> torch.dtype:
    mv = str(cfg["training"]["optimizer"].get("mv_dtype", "fp32")).lower()
    if mv in ("fp32", "float32", ""):
        return torch.float32
    if mv in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"training.optimizer.mv_dtype must be fp32|bf16, got {mv!r}")


def make_optimizer(cfg: Dict, named_params: Sequence[Tuple[str, torch.Tensor]],
                   tp_group=None) -> AdamW:
    """The optimizer of ``training.optimizer`` (AdamW), ``training.scheduler``,
    ``training.grad_clip_norm`` and ``data.grad_accum_steps``, on the
    parameters of a rank of the 'model' group `tp_group` (or of one
    process)."""
    t = cfg["training"]
    opt = t["optimizer"]
    betas = opt.get("betas", (0.9, 0.95))
    return AdamW(named_params, make_lr_schedule(cfg), b1=float(betas[0]), b2=float(betas[1]),
                 eps=float(opt.get("eps", 1e-8)),
                 weight_decay=float(opt.get("weight_decay", 0.05)),
                 clip_norm=float(t.get("grad_clip_norm", 1.0)), mv_dtype=_mv_dtype(cfg),
                 accum_steps=int(cfg["data"].get("grad_accum_steps", 1)), tp_group=tp_group)


# ---------------------------------------------------------------------------
# state and step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """Everything a step reads and writes. The parameters live in `model`;
    `mesh` is the layout they are held in (None: one process)."""

    step: int
    model: AVDiffusionModel
    optimizer: AdamW
    ema: Dict[str, torch.Tensor]  # shadow of the core's parameters (scope core) or of all
    generator: torch.Generator
    mesh: Any = None


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The fixed quantities of a train step (from the config and the batch
    size)."""

    z_video_shape: Tuple[int, ...]
    z_audio_shape: Tuple[int, ...]
    T_v: int
    T_a: int
    cfg_drop_prob: float = 0.1
    clean_cond_prob: float = 0.0
    align_weight: float = 0.0
    sync_weight: float = 0.0
    sync_tau: float = 0.1
    sync_source: str = "video"  # "video" | "mouth": the stream the sync loss reads
    video_time_chunks: int = 1
    mouth_time_chunks: int = 1
    recon_weight: float = 0.0
    recon_every: int = 1  # the reconstruction decode runs on every recon_every-th step
    ema_decay: float = 0.999
    use_ema: bool = True


def draw_step_randomness(generator: torch.Generator, sc: StepConfig) -> Dict[str, torch.Tensor]:
    """A step's random values, on the generator's device: timesteps t_v, t_a
    [B]; latent noise noise_v, noise_a; uniforms cfg_u (CFG condition drop)
    and clean_u (clean conditioning) [B]."""
    dev = generator.device
    B = sc.z_video_shape[0]
    return {
        "t_v": torch.randint(0, sc.T_v, (B,), generator=generator, device=dev),
        "t_a": torch.randint(0, sc.T_a, (B,), generator=generator, device=dev),
        "noise_v": torch.randn(sc.z_video_shape, generator=generator, device=dev),
        "noise_a": torch.randn(sc.z_audio_shape, generator=generator, device=dev),
        "cfg_u": torch.rand((B,), generator=generator, device=dev),
        "clean_u": torch.rand((B,), generator=generator, device=dev),
    }


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on `device`; uint8 video [B, T, H, W, 3] is cast,
    scaled to [0, 1] and moved to [B, 3, T, H, W] there (4x fewer bytes to
    copy than float32)."""
    out = {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
           for k in ("video", "audio", "has_video", "has_audio") if batch.get(k) is not None}
    if out["video"].dtype == torch.uint8:
        out["video"] = out["video"].float().permute(0, 4, 1, 2, 3) / 255.0
    return out


def train_loss(model: AVDiffusionModel, sc: StepConfig, abar_v: torch.Tensor,
               abar_a: torch.Tensor, batch: Dict[str, torch.Tensor], target_is_video: float,
               draws: Dict[str, torch.Tensor], with_recon: Optional[bool] = None,
               group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The train loss of one batch (on the device, video already [B, 3, T, H,
    W] float) under the given draws; returns (loss, its parts).
    ``with_recon`` says whether this step decodes and takes the
    reconstruction loss (None: whenever sc.recon_weight > 0). `group`: the
    data-parallel group whose ranks hold the rest of the batch (each
    rank's loss is then its share of the global batch's loss)."""
    if with_recon is None:
        with_recon = sc.recon_weight > 0.0
    t_v, t_a = draws["t_v"], draws["t_a"]
    if sc.clean_cond_prob > 0.0:
        # force the CONDITIONING modality's t to 0 (video conditions when
        # the target is audio, and vice versa)
        clean = draws["clean_u"] < sc.clean_cond_prob
        if target_is_video:
            t_a = torch.where(clean, torch.zeros_like(t_a), t_a)
        else:
            t_v = torch.where(clean, torch.zeros_like(t_v), t_v)
    # CFG condition drop: the non-target modality is kept with probability
    # 1 - cfg_drop_prob per sample, the target always
    keep_nontarget = 1.0 - (draws["cfg_u"] < sc.cfg_drop_prob).float()
    w_v = float(target_is_video)
    keep_v = w_v + (1.0 - w_v) * keep_nontarget
    keep_a = w_v * keep_nontarget + (1.0 - w_v)
    # the mouth-crop stream conditions only: on when video conditions, dropped
    # with it under CFG (the model ignores keep_m when the stream is off)
    keep_m = (1.0 - w_v) * keep_nontarget
    out = model(batch["video"], batch["audio"], t_v, t_a, draws["noise_v"], draws["noise_a"],
                abar_v, abar_a, keep_v, keep_a, keep_m=keep_m, with_recon=with_recon)
    loss_main = mse_targets_only(out["eps_v"], out["eps_a"], out["eps_true_v"],
                                 out["eps_true_a"], target_is_video,
                                 batch.get("has_video"), batch.get("has_audio"), group=group)
    loss_align = alignment_loss(out["h_v"], out["h_a"], weight=sc.align_weight, group=group)
    if sc.sync_source == "mouth":
        # the mouth tokens' rate; a dropped or target-side stream carries no timing
        loss_sync = sync_contrastive_loss(out["h_m"], out["h_a"], sc.mouth_time_chunks,
                                          weight=sc.sync_weight, tau=sc.sync_tau,
                                          sample_weight=keep_m, group=group)
    else:
        loss_sync = sync_contrastive_loss(out["h_v"], out["h_a"], sc.video_time_chunks,
                                          weight=sc.sync_weight, tau=sc.sync_tau,
                                          group=group)
    if with_recon:
        loss_recon = reconstruction_loss(out["recon_v"], batch["video"], out["recon_a"],
                                         batch["audio"], weight=sc.recon_weight,
                                         has_video=batch.get("has_video"),
                                         has_audio=batch.get("has_audio"), group=group)
    else:
        loss_recon = torch.zeros((), device=loss_main.device)
    loss = loss_main + loss_align + loss_recon + loss_sync
    return loss, {"loss": loss, "loss_main": loss_main, "loss_align": loss_align,
                  "loss_recon": loss_recon, "loss_sync": loss_sync}


def reduce_gradients(names: Sequence[str], params: Sequence[torch.Tensor],
                     mesh) -> List[Optional[torch.Tensor]]:
    """The parameters' gradients summed over the mesh's groups as the module
    docstring says (a missing gradient counts as zero and becomes a tensor
    when any sum runs); nothing is summed over 'model', and a missing
    gradient stays missing under 'model' alone. A gradient that
    every rank of a 'model', 'context' or 'pipe' group computes whole (a
    replicated parameter's, outside the summed core blocks) is taken from
    the group's first rank: the ranks' copies are equal only up to the
    kernels' nondeterminism (a convolution's weight gradient summed by
    atomics), and a replicated parameter must stay one value."""
    grads = [p.grad for p in params]
    axes = [a for a in ("data", "model", "context", "pipe")
            if mesh is not None and mesh.size(a) > 1]
    if any(a != "model" for a in axes):
        grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                 for p, g in zip(params, grads)]
    for axis in axes:
        group = mesh.group(axis)
        if axis == "data":
            comm.sum_over(grads, group)
            continue
        if axis == "model":  # a split parameter's part is this rank's alone
            summed, whole = [], [i for i, n in enumerate(names) if not is_split(n)]
        else:
            summed = [i for i, n in enumerate(names) if n.startswith("core.blocks.")]
            whole = [i for i, n in enumerate(names) if not n.startswith("core.blocks.")]
        comm.sum_over([grads[i] for i in summed], group)
        comm.broadcast_over([grads[i] for i in whole], mesh.members(axis)[0], group)
    return grads


def _sum_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """0-d metrics summed over `group` (one transfer)."""
    keys = list(metrics)
    flat = comm.all_reduce_(torch.stack([metrics[k].detach().float() for k in keys]), group)
    return dict(zip(keys, flat.unbind()))


def build_train_step(sc: StepConfig, abar_v: torch.Tensor, abar_a: torch.Tensor, mesh=None):
    """Returns train_step(state, batch, target_is_video, draws=None) ->
    metrics (0-d tensors on the device: loss, loss_main, loss_align,
    loss_recon, loss_sync, grad_norm before the clip). `draws` default to a
    fresh draw from state.generator. With sc.recon_weight > 0 the step that
    brings state.step to a multiple of sc.recon_every decodes and takes the
    reconstruction loss; the others skip the decode (loss_recon 0), and a
    parameter that such a step gives no gradient still takes the optimizer's
    zero-gradient update (moment decay and weight decay).

    Under a `mesh` with 'data' > 1 the batch and the draws are the global
    batch's (``shard_batch`` keeps this rank's rows; a batch of this rank's
    rows passes through), the gradients are summed as ``reduce_gradients``
    says, and the metrics are the global batch's on every rank."""
    B = sc.z_video_shape[0]
    data_group = None if mesh is None else mesh.group("data")

    def train_step(state: TrainState, batch: Dict[str, Any], target_is_video: float,
                   draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        model = state.model.train()
        device = abar_v.device
        if draws is None:
            draws = draw_step_randomness(state.generator, sc)
        draws = shard_batch(mesh, draws, B)
        batch = shard_batch(mesh, batch, B)
        params = state.optimizer.params
        for p in params:
            p.grad = None
        with_recon = sc.recon_weight > 0.0 and (state.step + 1) % sc.recon_every == 0
        loss, metrics = train_loss(model, sc, abar_v, abar_a, batch_to_device(batch, device),
                                   target_is_video, draws, with_recon, data_group)
        loss.backward()
        grads = reduce_gradients(state.optimizer.names, params, mesh)
        if data_group is not None:
            metrics = _sum_metrics(metrics, data_group)
        with torch.no_grad():
            metrics["grad_norm"] = state.optimizer.grad_norm(grads)
            state.optimizer.step(grads)
            if sc.use_ema:
                named = dict(model.named_parameters())
                shadow = list(state.ema.values())
                torch._foreach_mul_(shadow, sc.ema_decay)
                torch._foreach_add_(shadow, [named[n] for n in state.ema],
                                    alpha=1.0 - sc.ema_decay)
        for p in params:
            p.grad = None
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def build_eval_step(sc: StepConfig, abar_v: torch.Tensor, abar_a: torch.Tensor, mesh=None):
    """Returns eval_step(model, batch, generator) -> {val_loss_video,
    val_loss_audio, val_loss}: per-modality target MSE with no CFG drop, no
    dropout, timesteps and noise from `generator`. With the mouth-crop stream
    enabled the audio loss comes from a second forward with the stream on
    (the v2a sampling configuration); the first keeps it zeroed, so the video
    loss never sees clean target pixels. Under 'data' > 1 each rank takes
    its rows and the losses are the global batch's."""
    B = sc.z_video_shape[0]
    data_group = None if mesh is None else mesh.group("data")

    @torch.no_grad()
    def eval_step(model: AVDiffusionModel, batch: Dict[str, Any],
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            b = batch_to_device(shard_batch(mesh, batch, B), abar_v.device)
            d = shard_batch(mesh, draw_step_randomness(generator, sc), B)
            def losses_of(keep_m, target_is_video):
                out = model(b["video"], b["audio"], d["t_v"], d["t_a"], d["noise_v"],
                            d["noise_a"], abar_v, abar_a, keep_m=keep_m)
                return [mse_targets_only(out["eps_v"], out["eps_a"], out["eps_true_v"],
                                         out["eps_true_a"], w, b.get("has_video"),
                                         b.get("has_audio"), group=data_group)
                        for w in target_is_video]

            if model.cfg.mouth_enabled:
                (loss_v,) = losses_of(None, (1.0,))
                (loss_a,) = losses_of(torch.ones(b["video"].shape[0], device=abar_v.device),
                                      (0.0,))
            else:
                loss_v, loss_a = losses_of(None, (1.0, 0.0))
        finally:
            model.train(was_training)
        if data_group is not None:
            loss_v, loss_a = comm.all_reduce_(torch.stack([loss_v, loss_a]), data_group).unbind()
        return {"val_loss_video": loss_v, "val_loss_audio": loss_a,
                "val_loss": 0.5 * (loss_v + loss_a)}

    return eval_step


@dataclasses.dataclass
class TrainerBundle:
    """What a training run needs: the state, the step functions and the
    shapes."""

    model: AVDiffusionModel
    state: TrainState
    train_step: Callable
    eval_step: Callable
    step_config: StepConfig
    latent_shapes: Dict[str, Tuple[int, ...]]
    abar_v: torch.Tensor
    abar_a: torch.Tensor
    device: torch.device
    mesh: Any = None


def run_validation(bundle: TrainerBundle, batches, n_batches: int = 8,
                   seed: int = 0) -> Dict[str, float]:
    """Average the eval step over up to n_batches with the live parameters;
    the draws come from a generator seeded with `seed`, so repeated
    validations see the same timesteps and noise."""
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    acc: Dict[str, list] = {}
    for batch in islice(batches, n_batches):
        for k, v in bundle.eval_step(bundle.model, batch, gen).items():
            acc.setdefault(k, []).append(float(v))
    return {k: float(np.mean(v)) for k, v in acc.items()}


def _abar(d: Dict, device: torch.device) -> torch.Tensor:
    betas = S.make_beta_schedule(int(d["steps"]), d["schedule"], float(d["min_beta"]),
                                 float(d["max_beta"]))
    return torch.from_numpy(S.alphas_cumprod_from_betas(betas)[1]).to(device)


def create_trainer(cfg: Dict, device="cuda", batch_size: Optional[int] = None,
                   seed: Optional[int] = None, mesh=None) -> TrainerBundle:
    """The model (seeded random init), optimizer, EMA shadow and generator on
    one device (CUDA unless `device="cpu"`; raises when CUDA is asked for and
    absent), and the step functions.

    `mesh` (default ``make_mesh_from_config(cfg)`` over the process group's
    ranks, or one rank) lays the step out over ranks, as the JAX package's
    create_trainer: `batch_size` is the GLOBAL batch (default
    ``data.batch_size`` x the 'data' size), the latent shapes and the draws
    are the global batch's, and every rank starts from the one-process init
    (each rank draws it from the seed; the replicated parameters are also
    broadcast from the lead rank) and keeps its part of the split
    parameters under ``parallel.model``, whose moments and EMA are parts
    too. A layout larger than the world raises ValueError.

    Sets torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 to False: fp32 matmuls and convolutions
    run in full fp32 (cuDNN would use TF32 for conv3d by default); bf16
    compute is unaffected."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_cfg = cfg["training"]
    sync_source = str(t_cfg.get("sync_loss_source", "video"))
    if sync_source not in ("video", "mouth"):
        raise ValueError(f"training.sync_loss_source must be video|mouth, got {sync_source!r}")
    recon_every = t_cfg.get("recon_every", 1)
    recon_every = 1 if recon_every is None else int(recon_every)
    if recon_every < 1:
        raise ValueError(f"training.recon_every must be >= 1, got {recon_every}")
    par = cfg.get("parallel", {}) or {}
    mesh = make_mesh_from_config(cfg) if mesh is None else mesh
    ema_cfg = t_cfg.get("ema", {"use_ema": True, "decay": 0.999}) or {}
    ema_scope = str(ema_cfg.get("scope", "core"))
    if ema_scope not in ("core", "all"):
        raise ValueError(f"training.ema.scope must be core|all, got {ema_scope!r}")

    model = AVDiffusionModel(AVDiffusionConfig.from_config(
        cfg, dtype=compute_dtype_from_config(cfg), remat=bool(par.get("remat_core", False)),
        mesh=mesh))
    if (sync_source == "mouth" and float(t_cfg.get("sync_loss_weight", 0.0)) > 0.0
            and not model.cfg.mouth_enabled):
        raise ValueError("training.sync_loss_source: mouth requires "
                         "conditioning.mouth_crop.enabled: true")
    cc = model.cfg.codec
    if cc.frames_per_clip:
        dur_est = cc.frames_per_clip * cc.hop_samples / float(cc.sr)
        want = float(cfg["data"].get("clip_seconds", dur_est))
        if abs(dur_est - want) > 0.02:
            warnings.warn(f"[AudioCodec] frames_per_clip x hop = {dur_est:.3f}s does not "
                          f"match clip_seconds={want:.3f}s; check audio latent config.")
    seed = int(cfg.get("seed", 0)) if seed is None else int(seed)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.to(dev).train()
    replicated(mesh, model.named_parameters())
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    set_dropout_generator(model, generator)
    n_data = mesh.size("data")
    # every dropout sees this rank's rows of the global batch
    split_dropout([model], 0, n_data, mesh.index("data"))

    if batch_size is None:
        batch_size = int(cfg["data"]["batch_size"]) * n_data
    batch_size = int(batch_size)
    if batch_size % n_data:
        raise ValueError(f"global batch {batch_size} not divisible by parallel.data={n_data}")
    shapes = latent_shapes_from_config(cfg, batch_size)
    abar_v = _abar(cfg["diffusion"]["video"], dev)
    abar_a = _abar(cfg["diffusion"]["audio"], dev)
    optimizer = make_optimizer(cfg, list(model.named_parameters()), mesh.group("model"))
    use_ema = bool(ema_cfg.get("use_ema", True))
    # the EMA shadows the core's parameters (scope core) or all of them
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()
            if ema_scope == "all" or n.startswith("core.")} if use_ema else {})
    sc = StepConfig(
        z_video_shape=shapes["z_video"], z_audio_shape=shapes["z_audio"],
        T_v=int(cfg["diffusion"]["video"]["steps"]), T_a=int(cfg["diffusion"]["audio"]["steps"]),
        cfg_drop_prob=float(t_cfg.get("cfg_drop_prob", 0.1)),
        clean_cond_prob=float(t_cfg.get("clean_cond_prob", 0.0)),
        align_weight=float(t_cfg.get("align_loss_weight", 0.0)),
        sync_weight=float(t_cfg.get("sync_loss_weight", 0.0)),
        sync_tau=float(t_cfg.get("sync_tau", 0.1)), sync_source=sync_source,
        video_time_chunks=shapes["z_video"][2] // model.cfg.tube[0],
        mouth_time_chunks=shapes["video"][2] // model.cfg.mouth_tube[0],
        recon_weight=float(t_cfg.get("recon_loss_weight", 0.0)), recon_every=recon_every,
        ema_decay=float(ema_cfg.get("decay", 0.999)), use_ema=use_ema)
    state = TrainState(step=0, model=model, optimizer=optimizer, ema=ema, generator=generator,
                       mesh=mesh)
    return TrainerBundle(model=model, state=state,
                         train_step=build_train_step(sc, abar_v, abar_a, mesh),
                         eval_step=build_eval_step(sc, abar_v, abar_a, mesh), step_config=sc,
                         latent_shapes=shapes, abar_v=abar_v, abar_a=abar_a, device=dev,
                         mesh=mesh)


# ---------------------------------------------------------------------------
# training loop driver (host side)
# ---------------------------------------------------------------------------


def run_training(cfg: Dict, bundle: TrainerBundle, batches: Iterator[Dict[str, Any]], *,
                 max_steps: Optional[int] = None, log_fn=None, checkpoint_fn=None,
                 val_fn=None, should_stop=None,
                 draws: Optional[Iterator[Dict[str, torch.Tensor]]] = None) -> TrainState:
    """Drive the step over a batch iterator: host batches (numpy) or batches
    already on the device (``datasets/records.py::device_resident_batches``).

    A background thread (``datasets/loader.py::device_prefetch``, depth
    ``data.prefetch_factor``) prepares each batch ahead of the step: its
    target is its own "target" entry when that names a modality, else the
    next pick of the Any2AnySchedule (seeded by cfg['seed']); a modality
    missing from it is zero-filled (its has_* mask keeps it out of the
    loss); on a CUDA device its host arrays are copied there on a side
    stream while the previous step runs, and tensors already there pass
    through untouched. log_fn(step, metrics) every `log_every` steps with the
    interval's mean metrics, steps_per_sec and clips_per_sec (one host sync
    per interval; with training.recon_every = K > 1 the steps without the
    decode count as loss_recon 0, so the logged loss_recon, and its share of
    the logged loss, is 1/K of a reconstruction step's), and the denoiser's
    MFU: ``denoiser_mfu`` = ``denoiser_train_flops`` (3 B
    flops_mmdit_forward at the tokens the core runs, nv + na + nm; the JAX
    loop leaves out the mouth-crop tokens nm) per step time over the
    device's peak, and on a card ``denoiser_mfu_vs_calib`` against
    ``calib_tflops()``, measured once at the start of the call;
    checkpoint_fn(step, state) every `ckpt_every`;
    val_fn(step, state) every `val_every`; `should_stop()` is polled after
    every step. `draws`: an iterator of each step's random values, handed to
    the step in place of its own draw from the trainer's generator (as
    ``train_step``'s `draws`; dropout still draws from the generator).

    Under a mesh every rank runs this loop on the same global batches (or
    its own rows of them, see build_train_step); a step's target is the
    lead rank's. A card without a known peak logs denoiser_mfu as nan
    (one warning) and trains."""
    t_cfg = cfg["training"]
    max_steps = max_steps if max_steps is not None else int(t_cfg["max_steps"])
    log_every = int(t_cfg.get("log_every", 50))
    ckpt_every = int(t_cfg.get("ckpt_every", 5000))
    val_every = int(t_cfg.get("val_every", 0) or 0)
    schedule = Any2AnySchedule(t_cfg.get("any2any_targets", {"video": 0.5, "audio": 0.5}),
                               seed=int(cfg.get("seed", 0)))
    state = bundle.state
    B, _, T, H, W = bundle.latent_shapes["video"]
    data_cfg = cfg.get("data", {}) or {}
    device_pre = bool(data_cfg.get("device_preprocess", bool(data_cfg.get("records_dir"))))

    def prep_and_put(batch):
        """The batch's target, zero-fill and copy (on the prefetch thread)."""
        target = batch.get("target")
        if isinstance(target, set):
            target = next(iter(target)) if target else "audio"
        if target not in ("video", "audio"):
            target = schedule.sample_target()
        if batch.get("video") is None:
            batch = dict(batch, video=np.zeros((B, T, H, W, 3), np.uint8) if device_pre
                         else np.zeros(bundle.latent_shapes["video"], np.float32))
        if batch.get("audio") is None:
            batch = dict(batch, audio=np.zeros(bundle.latent_shapes["audio"], np.float32))
        return copy_to_device(batch, bundle.device), 1.0 if target == "video" else 0.0

    denoiser_flops = denoiser_train_flops(bundle.model, bundle.latent_shapes)
    try:
        peak = device_peak_flops(bundle.device)
    except KeyError as err:
        warnings.warn(f"{err.args[0]}; denoiser_mfu is logged as nan")
        peak = math.nan
    several = (bundle.mesh is not None and math.prod(bundle.mesh.shape.values()) > 1
               and dist.is_initialized())
    calib = calib_tflops() if bundle.device.type == "cuda" else None

    pending: List[Dict[str, torch.Tensor]] = []
    t_last = time.perf_counter()
    depth = int(data_cfg.get("prefetch_factor", 2) or 2)
    stream = device_prefetch(islice(batches, max(0, max_steps - state.step)), prep_and_put,
                             depth=depth, device=bundle.device)
    try:
        for batch, target_is_video in stream:
            if several:
                # the batch's own target may differ between the ranks' rows,
                # and a collated batch draws it from each process's numpy
                # generator: every rank takes the lead rank's
                tiv = torch.tensor([target_is_video], device=bundle.device)
                target_is_video = float(comm.broadcast_(tiv, 0, dist.group.WORLD)[0])
            metrics = bundle.train_step(state, batch, target_is_video,
                                        None if draws is None else next(draws))
            if log_fn is not None:
                pending.append(metrics)
            step = state.step
            if log_fn is not None and step % log_every == 0:
                keys = list(pending[0])
                vals = torch.stack([torch.stack([m[k].float() for k in keys])
                                    for m in pending]).mean(dim=0).tolist()
                now = time.perf_counter()
                dt = (now - t_last) / len(pending)
                agg = dict(zip(keys, vals), steps_per_sec=1.0 / dt, clips_per_sec=B / dt,
                           denoiser_mfu=denoiser_flops / dt / peak)
                if calib:
                    agg["denoiser_mfu_vs_calib"] = denoiser_flops / dt / 1e12 / calib
                t_last = now
                log_fn(step, agg)
                pending = []
            if checkpoint_fn is not None and step % ckpt_every == 0:
                checkpoint_fn(step, state)
            if val_fn is not None and val_every and step % val_every == 0:
                val_fn(step, state)
            if should_stop is not None and should_stop():
                print(f"[preempt] stop requested; exiting at step {step}")
                break
    finally:
        stream.close()
    return state
