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

``parallel.model > 1`` and ``parallel.remat_core`` raise
``NotImplementedError`` until their slices. The JAX loop's MFU logging waits
for a profiling module calibrated on the H100.
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

from ..datasets.loader import copy_to_device, device_prefetch
from ..models.diffusion import AVDiffusionConfig, AVDiffusionModel, init_weights
from ..models.mmdit import set_dropout_generator
from ..ops import schedule as S
from ..utils.io import compute_dtype_from_config, latent_shapes_from_config, resolve_device
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


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the device."""
    return torch.linalg.vector_norm(torch.stack(
        [n.float() for n in torch._foreach_norm(list(tensors))]))


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
      every k-th call; the other calls change no parameter.
    """

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]],
                 lr_schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.05, clip_norm: float = 1.0,
                 mv_dtype: torch.dtype = torch.float32, accum_steps: int = 1):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
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

    def _apply(self, grads: List[torch.Tensor]) -> None:
        norm = global_norm(grads)
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
        def named(ts):
            return None if ts is None else {n: t.detach().cpu().clone()
                                            for n, t in zip(self.names, ts)}
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": named(self.mu), "nu": named(self.nu), "acc": named(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for key in ("mu", "nu", "acc"):
            dst = getattr(self, key)
            if dst is None:
                continue
            for n, t in zip(self.names, dst):
                t.copy_(state[key][n])


def _mv_dtype(cfg: Dict) -> torch.dtype:
    mv = str(cfg["training"]["optimizer"].get("mv_dtype", "fp32")).lower()
    if mv in ("fp32", "float32", ""):
        return torch.float32
    if mv in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"training.optimizer.mv_dtype must be fp32|bf16, got {mv!r}")


def make_optimizer(cfg: Dict, named_params: Sequence[Tuple[str, torch.Tensor]]) -> AdamW:
    """The optimizer of ``training.optimizer`` (AdamW), ``training.scheduler``,
    ``training.grad_clip_norm`` and ``data.grad_accum_steps``."""
    t = cfg["training"]
    opt = t["optimizer"]
    betas = opt.get("betas", (0.9, 0.95))
    return AdamW(named_params, make_lr_schedule(cfg), b1=float(betas[0]), b2=float(betas[1]),
                 eps=float(opt.get("eps", 1e-8)),
                 weight_decay=float(opt.get("weight_decay", 0.05)),
                 clip_norm=float(t.get("grad_clip_norm", 1.0)), mv_dtype=_mv_dtype(cfg),
                 accum_steps=int(cfg["data"].get("grad_accum_steps", 1)))


# ---------------------------------------------------------------------------
# state and step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """Everything a step reads and writes. The parameters live in `model`."""

    step: int
    model: AVDiffusionModel
    optimizer: AdamW
    ema: Dict[str, torch.Tensor]  # shadow of the core's parameters (scope core) or of all
    generator: torch.Generator


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
    use_kernel: Optional[bool] = None


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
               draws: Dict[str, torch.Tensor], with_recon: Optional[bool] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The train loss of one batch (on the device, video already [B, 3, T, H,
    W] float) under the given draws; returns (loss, its parts).
    ``with_recon`` says whether this step decodes and takes the
    reconstruction loss (None: whenever sc.recon_weight > 0)."""
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
                abar_v, abar_a, keep_v, keep_a, keep_m=keep_m, with_recon=with_recon,
                use_kernel=sc.use_kernel)
    loss_main = mse_targets_only(out["eps_v"], out["eps_a"], out["eps_true_v"],
                                 out["eps_true_a"], target_is_video,
                                 batch.get("has_video"), batch.get("has_audio"))
    loss_align = alignment_loss(out["h_v"], out["h_a"], weight=sc.align_weight)
    if sc.sync_source == "mouth":
        # the mouth tokens' rate; a dropped or target-side stream carries no timing
        loss_sync = sync_contrastive_loss(out["h_m"], out["h_a"], sc.mouth_time_chunks,
                                          weight=sc.sync_weight, tau=sc.sync_tau,
                                          sample_weight=keep_m)
    else:
        loss_sync = sync_contrastive_loss(out["h_v"], out["h_a"], sc.video_time_chunks,
                                          weight=sc.sync_weight, tau=sc.sync_tau)
    if with_recon:
        loss_recon = reconstruction_loss(out["recon_v"], batch["video"], out["recon_a"],
                                         batch["audio"], weight=sc.recon_weight,
                                         has_video=batch.get("has_video"),
                                         has_audio=batch.get("has_audio"))
    else:
        loss_recon = torch.zeros((), device=loss_main.device)
    loss = loss_main + loss_align + loss_recon + loss_sync
    return loss, {"loss": loss, "loss_main": loss_main, "loss_align": loss_align,
                  "loss_recon": loss_recon, "loss_sync": loss_sync}


def build_train_step(sc: StepConfig, abar_v: torch.Tensor, abar_a: torch.Tensor):
    """Returns train_step(state, batch, target_is_video, draws=None) ->
    metrics (0-d tensors on the device: loss, loss_main, loss_align,
    loss_recon, loss_sync, grad_norm before the clip). `draws` default to a
    fresh draw from state.generator. With sc.recon_weight > 0 the step that
    brings state.step to a multiple of sc.recon_every decodes and takes the
    reconstruction loss; the others skip the decode (loss_recon 0), and a
    parameter that such a step gives no gradient still takes the optimizer's
    zero-gradient update (moment decay and weight decay)."""

    def train_step(state: TrainState, batch: Dict[str, Any], target_is_video: float,
                   draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        model = state.model.train()
        device = abar_v.device
        if draws is None:
            draws = draw_step_randomness(state.generator, sc)
        params = state.optimizer.params
        for p in params:
            p.grad = None
        with_recon = sc.recon_weight > 0.0 and (state.step + 1) % sc.recon_every == 0
        loss, metrics = train_loss(model, sc, abar_v, abar_a, batch_to_device(batch, device),
                                   target_is_video, draws, with_recon)
        loss.backward()
        grads = [p.grad for p in params]
        with torch.no_grad():
            metrics["grad_norm"] = global_norm([g for g in grads if g is not None])
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


def build_eval_step(sc: StepConfig, abar_v: torch.Tensor, abar_a: torch.Tensor):
    """Returns eval_step(model, batch, generator) -> {val_loss_video,
    val_loss_audio, val_loss}: per-modality target MSE with no CFG drop, no
    dropout, timesteps and noise from `generator`. With the mouth-crop stream
    enabled the audio loss comes from a second forward with the stream on
    (the v2a sampling configuration); the first keeps it zeroed, so the video
    loss never sees clean target pixels."""

    @torch.no_grad()
    def eval_step(model: AVDiffusionModel, batch: Dict[str, Any],
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            b = batch_to_device(batch, abar_v.device)
            d = draw_step_randomness(generator, sc)
            def losses_of(keep_m, target_is_video):
                out = model(b["video"], b["audio"], d["t_v"], d["t_a"], d["noise_v"],
                            d["noise_a"], abar_v, abar_a, keep_m=keep_m,
                            use_kernel=sc.use_kernel)
                return [mse_targets_only(out["eps_v"], out["eps_a"], out["eps_true_v"],
                                         out["eps_true_a"], w, b.get("has_video"),
                                         b.get("has_audio")) for w in target_is_video]

            if model.cfg.mouth_enabled:
                (loss_v,) = losses_of(None, (1.0,))
                (loss_a,) = losses_of(torch.ones(b["video"].shape[0], device=abar_v.device),
                                      (0.0,))
            else:
                loss_v, loss_a = losses_of(None, (1.0, 0.0))
        finally:
            model.train(was_training)
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
                   seed: Optional[int] = None, use_kernel: Optional[bool] = None
                   ) -> TrainerBundle:
    """The model (seeded random init), optimizer, EMA shadow and generator on
    one device (CUDA unless `device="cpu"`; raises when CUDA is asked for and
    absent), and the step functions. `use_kernel` picks the attention
    backend (None: the kernels on CUDA, dense attention on the CPU).

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
    if int(par.get("model", 1) or 1) > 1:
        raise NotImplementedError("parallel.model > 1 (tensor parallelism) is not ported yet")
    if bool(par.get("remat_core", False)):
        raise NotImplementedError("parallel.remat_core (recomputing the core's blocks in "
                                  "the backward pass) is not ported yet")
    ema_cfg = t_cfg.get("ema", {"use_ema": True, "decay": 0.999}) or {}
    ema_scope = str(ema_cfg.get("scope", "core"))
    if ema_scope not in ("core", "all"):
        raise ValueError(f"training.ema.scope must be core|all, got {ema_scope!r}")

    model = AVDiffusionModel(AVDiffusionConfig.from_config(
        cfg, dtype=compute_dtype_from_config(cfg)))
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
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    set_dropout_generator(model, generator)

    batch_size = int(cfg["data"]["batch_size"]) if batch_size is None else int(batch_size)
    shapes = latent_shapes_from_config(cfg, batch_size)
    abar_v = _abar(cfg["diffusion"]["video"], dev)
    abar_a = _abar(cfg["diffusion"]["audio"], dev)
    optimizer = make_optimizer(cfg, list(model.named_parameters()))
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
        ema_decay=float(ema_cfg.get("decay", 0.999)), use_ema=use_ema, use_kernel=use_kernel)
    state = TrainState(step=0, model=model, optimizer=optimizer, ema=ema, generator=generator)
    return TrainerBundle(model=model, state=state, train_step=build_train_step(sc, abar_v, abar_a),
                         eval_step=build_eval_step(sc, abar_v, abar_a), step_config=sc,
                         latent_shapes=shapes, abar_v=abar_v, abar_a=abar_a, device=dev)


# ---------------------------------------------------------------------------
# training loop driver (host side)
# ---------------------------------------------------------------------------


def run_training(cfg: Dict, bundle: TrainerBundle, batches: Iterator[Dict[str, Any]], *,
                 max_steps: Optional[int] = None, log_fn=None, checkpoint_fn=None,
                 val_fn=None, should_stop=None) -> TrainState:
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
    the logged loss, is 1/K of a reconstruction step's); checkpoint_fn(step, state) every `ckpt_every`;
    val_fn(step, state) every `val_every`; `should_stop()` is polled after
    every step."""
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

    pending: List[Dict[str, torch.Tensor]] = []
    t_last = time.perf_counter()
    depth = int(data_cfg.get("prefetch_factor", 2) or 2)
    stream = device_prefetch(islice(batches, max(0, max_steps - state.step)), prep_and_put,
                             depth=depth, device=bundle.device)
    try:
        for batch, target_is_video in stream:
            metrics = bundle.train_step(state, batch, target_is_video)
            if log_fn is not None:
                pending.append(metrics)
            step = state.step
            if log_fn is not None and step % log_every == 0:
                keys = list(pending[0])
                vals = torch.stack([torch.stack([m[k].float() for k in keys])
                                    for m in pending]).mean(dim=0).tolist()
                now = time.perf_counter()
                dt = (now - t_last) / len(pending)
                agg = dict(zip(keys, vals), steps_per_sec=1.0 / dt, clips_per_sec=B / dt)
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
