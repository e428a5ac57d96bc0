"""Closed-loop training of the flagship on one card: the program's training
loop (``train/trainer.py::run_training``) over batches of clips resident on
the device, step after step, as a researcher's run with device-resident
data does.

Traffic parameters (``traffic/<mix>.json``):
  batch           clips a step
  resident_clips  clips made on the device in set-up (uint8 video and float
                  waveforms, uniform random), drawn from for every step
  warm_steps      steps taken in set-up, the steps the check compares
  planned_steps   window steps whose clip indices and draws set-up makes
                  (more than a window takes; later steps are made as taken)
  profile_steps   steps profiled after the window of a --trace 1 run

Set-up draws the weights on the card from --seed (``weights.py``, float32:
the trainer keeps float32 parameters and computes in the configuration's
precision), builds the trainer (``create_trainer``: AdamW, EMA and the
dropout generator as configured), loads the weights into it, makes the
resident clips and takes the warm steps, recorded for the check. The
window runs ``run_training`` until the first step that ends ``seconds`` or
more after it started, then waits for the device; ``clips_per_s`` is the
clips of every step over that time. Step i takes its clips, its target
modality and its random draws (timesteps, noise, CFG and clean-conditioning
uniforms, handed to the loop through ``draws``) from --seed and i; dropout
draws from the trainer's own generator.

The check holds the warm steps of the timed trainer to the plain reference
(``reference/av_training.py``): set-up records each step's loss and the
uniforms of each dropout site as the program draws them, and after the last
warm step copies the parameters, Adam's first moments and the EMA shadow to
the host, so that the window holds only what a run holds. After the window
the reference takes the same steps from the same weights with the same
clips, draws and uniforms (``numbers`` says what is compared). The warm-up
schedule's first update is zero (lr 0 at count 0), so three warm steps make
two updates; the moments hold all three steps' gradients.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from benchmark.harness import Cell, Outcome
from benchmark.reference import av_sampling as avs
from benchmark.reference import av_training as ref
from benchmark.seeds import part_seed
from benchmark.weights import make_weights


def build_program(cfg: Dict, weights: Dict[str, torch.Tensor], batch: int, device):
    """The trainer bundle as the training entry point makes it
    (``create_trainer``), its parameters the benchmark's and its EMA shadow
    started at zero: started at the weights, the shadow would move by
    1 - decay of the warm-up's updates of ~1e-7, under float32's resolution,
    and the check could not read it. Its work is the same either way."""
    from multimodal_diffusion_torch.train.trainer import create_trainer

    bundle = create_trainer(cfg, device=device, batch_size=batch, seed=int(cfg.get("seed", 0)))
    bundle.model.load_state_dict(weights, strict=True)
    with torch.no_grad():
        for shadow in bundle.state.ema.values():
            shadow.zero_()
    return bundle


class Data:
    """The resident clips and the steps of one run, all from --seed. The
    window's steps (0 to ``planned`` - 1) are made in set-up (``plan``):
    their clip indices and draws already on the device, so the window holds
    only the program's work and no host-to-device copy that would wait for
    the device; a step outside the plan is made when it is taken, the same
    way."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        s = avs.sizes(cfg)
        n, self.B, self.seed, self.device = (int(traffic["resident_clips"]),
                                             int(traffic["batch"]), seed, device)
        gen = torch.Generator(device=device).manual_seed(part_seed(seed, "prompts"))
        self.video = torch.randint(0, 256, (n, s["T"], s["H"], s["W"], 3), generator=gen,
                                   device=device, dtype=torch.uint8)
        self.audio = torch.rand((n, 1, s["L"]), generator=gen, device=device).mul_(2).sub_(1)
        targets = cfg["training"].get("any2any_targets", {"video": 0.5, "audio": 0.5})
        self.p_video = float(targets.get("video", 0.0)) / sum(float(v) for v in targets.values())
        self.ones = torch.ones(self.B, device=device)
        self.planned: Dict[int, Tuple] = {}

    def _pick(self, i: int):
        rng = np.random.default_rng(part_seed(self.seed, "batches", i % (1 << 32)))
        idx = rng.choice(len(self.video), size=self.B, replace=False)
        return idx, "video" if rng.random() < self.p_video else "audio"

    def _draws(self, i: int, sc) -> Dict[str, torch.Tensor]:
        from multimodal_diffusion_torch.train.trainer import draw_step_randomness

        gen = torch.Generator(device=self.device).manual_seed(
            part_seed(self.seed, "batches", (1 << 32) + i % (1 << 32)))
        return draw_step_randomness(gen, sc)

    def plan(self, n: int, sc) -> None:
        """Make steps 0 .. n - 1 now: their indices in one copy, their draws."""
        picks = [self._pick(i) for i in range(n)]
        idx = torch.as_tensor(np.stack([p[0] for p in picks]), device=self.device)
        self.planned = {i: (idx[i], picks[i][1], self._draws(i, sc)) for i in range(n)}

    def batch(self, i: int) -> Dict:
        """Step i's clips (gathered on the device) and target."""
        if i in self.planned:
            idx, target, _ = self.planned[i]
        else:
            idx, target = self._pick(i)
            idx = torch.as_tensor(idx, device=self.device)
        return {"video": self.video[idx], "audio": self.audio[idx], "has_video": self.ones,
                "has_audio": self.ones, "target": target}

    def draws(self, i: int, sc) -> Dict[str, torch.Tensor]:
        """Step i's random values, drawn as the trainer draws a step's."""
        return self.planned[i][2] if i in self.planned else self._draws(i, sc)

    def steps(self, first: int, sc) -> Tuple[Iterator[Dict], Iterator[Dict]]:
        """(batches, draws) from step `first` on, without end."""
        def batches():
            i = first
            while True:
                yield self.batch(i)
                i += 1

        def draws():
            i = first
            while True:
                yield self.draws(i, sc)
                i += 1

        return batches(), draws()


def train(cfg: Dict, bundle, data: Data, first: int, n: int = None, seconds: float = None):
    """run_training over steps first.. until n steps or `seconds` have
    passed (polled after each step)."""
    from multimodal_diffusion_torch.train.trainer import run_training

    batches, draws = data.steps(first, bundle.step_config)
    state = bundle.state
    start = time.perf_counter()
    stop = None if seconds is None else (lambda: time.perf_counter() - start >= seconds)
    run_training(cfg, bundle, batches, max_steps=None if n is None else state.step + n,
                 should_stop=stop, draws=draws)


class Masks:
    """Records, in order and on the host, the uniforms each dropout site of
    the program draws (``Dropout._uniform`` on each instance), until
    ``release``."""

    def __init__(self, model):
        from multimodal_diffusion_torch.models.mmdit import Dropout

        self.seen: Dict[str, List[torch.Tensor]] = {}
        self.mods = [(name, mod) for name, mod in model.named_modules()
                     if isinstance(mod, Dropout)]
        for name, mod in self.mods:
            mod._uniform = self._recorder(name, mod._uniform)

    def _recorder(self, name, draw):
        def uniform(shape, device):
            u = draw(shape, device)
            self.seen.setdefault(name, []).append(u.detach().to("cpu", copy=True))
            return u
        return uniform

    def release(self) -> None:
        for _, mod in self.mods:
            del mod._uniform


def warm(cfg: Dict, bundle, data: Data, n: int):
    """The set-up's n steps (data steps -n .. -1) through ``run_training``,
    recorded: (the program's ``ref.Run`` of them, on the host; the dropout
    uniforms; the steps as the reference takes them)."""
    masks = Masks(bundle.model)
    losses: List[torch.Tensor] = []
    step = bundle.train_step

    def recorded(state, batch, target_is_video, draws=None):
        metrics = step(state, batch, target_is_video, draws)
        losses.append(metrics["loss"])
        return metrics

    bundle.train_step = recorded
    try:
        train(cfg, bundle, data, -n, n=n)
    finally:
        bundle.train_step = step
        masks.release()
    rows = []
    for i in range(-n, 0):
        b = data.batch(i)
        rows.append((b["video"], b["audio"], 1.0 if b["target"] == "video" else 0.0,
                     data.draws(i, bundle.step_config)))
    opt = bundle.state.optimizer

    def host(t):  # a copy even on the CPU, where .cpu() is the trained tensor itself
        return t.detach().to("cpu", torch.float32, copy=True)

    run = ref.Run([float(v) for v in losses],
                  {k: host(p) for k, p in bundle.model.named_parameters()},
                  {k: host(mu) for k, mu in zip(opt.names, opt.mu)},
                  {k: host(e) for k, e in bundle.state.ema.items()})
    return run, masks.seen, rows


def _rel(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    return float(torch.sum((got - want) ** 2)), float(torch.sum(want ** 2))


def _ratio(num: float, den: float) -> float:
    if den > 0:
        return math.sqrt(num / den)
    return 0.0 if num == 0 else math.inf


def numbers(weights, got: "ref.Run", want: "ref.Run") -> Dict[str, float]:
    """The check's numbers for the program's (or a control's) steps against
    the reference's, from the same weights, clips, draws and dropout
    uniforms; dW is the change the steps made to a parameter from the
    handed weights (the gradients through the flash backward kernels, the
    clip and AdamW), and a state left unchanged reads 1 in each but the
    loss:

      loss_rel_err         the widest |l - l_ref| / |l_ref| over the steps;
      param_rel_err        ||dW - dW_ref|| / ||dW_ref|| over every parameter;
      param_leaf_rel_err   the same of the worst parameter alone;
      moment_leaf_rel_err  ||m - m_ref|| / ||m_ref|| of Adam's first moment,
                           the worst parameter (every step's clipped
                           gradient, the first's too, whose update the
                           warm-up makes zero);
      ema_rel_err          ||e - e_ref|| / ||e_ref|| over the EMA shadow.

    A parameter whose reference value is zero reads 0 where the program's
    is zero too, else inf."""
    if len(got.losses) != len(want.losses):
        return {k: math.inf for k in ("loss_rel_err", "param_rel_err", "param_leaf_rel_err",
                                      "moment_leaf_rel_err", "ema_rel_err")}
    out = {"loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(got.losses, want.losses))}
    num = den = leaf = moment = 0.0
    for name, w0 in weights.items():
        w0 = w0.float()
        dev = want.params[name].device
        n, d = _rel(got.params[name].to(dev) - w0, want.params[name] - w0)
        num, den, leaf = num + n, den + d, max(leaf, _ratio(n, d))
        moment = max(moment, _ratio(*_rel(got.moments[name].to(dev), want.moments[name])))
    out.update(param_rel_err=_ratio(num, den), param_leaf_rel_err=leaf,
               moment_leaf_rel_err=moment)
    num = den = 0.0
    for name, e in want.ema.items():
        n, d = _rel(got.ema[name].to(e.device), e) if name in got.ema else (math.inf, 0.0)
        num, den = num + n, den + d
    if set(got.ema) != set(want.ema):
        num = math.inf
    out["ema_rel_err"] = _ratio(num, den)
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t0: float = None) -> Outcome:
    t0 = time.perf_counter() if t0 is None else t0
    tr, cfg = cell.traffic, cell.config
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    weights = make_weights(avs.param_shapes(cfg), part_seed(seed, "weights"), device,
                           torch.float32)
    bundle = build_program(cfg, weights, int(tr["batch"]), device)
    data = Data(cfg, tr, seed, device)
    data.plan(int(tr["planned_steps"]), bundle.step_config)
    recorded = warm(cfg, bundle, data, int(tr["warm_steps"]))
    sync()
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    start = time.perf_counter()
    first = bundle.state.step
    train(cfg, bundle, data, 0, seconds=seconds)
    sync()
    wall = time.perf_counter() - start
    n = bundle.state.step - first
    ctx = {"cfg": cfg, "traffic": tr, "steps": n, "wall_s": wall}

    if trace:
        from torch.profiler import ProfilerActivity, profile

        from benchmark.devicetrace import DeviceTrace

        k = int(tr["profile_steps"])
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            p0 = time.perf_counter()
            with torch.profiler.record_function("bench.run_training"):
                train(cfg, bundle, data, n, n=k)
            sync()
            window_s = time.perf_counter() - p0
        ctx["trace"] = DeviceTrace.of(prof, window_s)
        ctx["traced_steps"] = k

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del bundle
    if cuda:
        torch.cuda.empty_cache()
    read = against_reference(cfg, weights, *recorded)
    checks = [(k, read[k] if math.isfinite(read[k]) else math.inf, float(limit))
              for k, limit in cell.limits.items()]
    B = int(tr["batch"])
    return Outcome(values={"clips_per_s": n * B / wall, "setup_s": setup_s}, context=ctx,
                   attempted=n * B, failed=0, memory_peak_bytes=int(peak), checks=checks)


def against_reference(cfg: Dict, weights, got: "ref.Run", masks, rows) -> Dict[str, float]:
    return numbers(weights, got, ref.train(weights, cfg, rows, masks))


def plant(bundle, fault: str) -> None:
    """A fault planted in the program: "no_dropout" draws each dropout
    site's uniforms as a sound step does but applies none of them; "target"
    trains the other modality than the step's target; "half_batch" trains
    the first half of the batch's clips, each twice; "no_ema" leaves the EMA
    shadow as it was before each step."""
    step = bundle.train_step
    if fault == "no_dropout":
        from multimodal_diffusion_torch.models.mmdit import Dropout

        def drawn_not_applied(mod):
            def forward(x):
                if mod.training and mod.rate > 0.0:
                    mod._uniform(x.shape, x.device)
                return x
            return forward

        for mod in bundle.model.modules():
            if isinstance(mod, Dropout):
                mod.forward = drawn_not_applied(mod)
        return
    if fault == "target":
        def flipped(state, batch, target_is_video, draws=None):
            return step(state, batch, 1.0 - target_is_video, draws)

        bundle.train_step = flipped
        return
    if fault == "half_batch":
        def half(state, batch, target_is_video, draws=None):
            h = batch["video"].shape[0] // 2
            twice = {k: torch.cat([batch[k][:h], batch[k][:h]]) for k in ("video", "audio")}
            return step(state, dict(batch, **twice), target_is_video, draws)

        bundle.train_step = half
        return
    if fault == "no_ema":
        def unshadowed(state, batch, target_is_video, draws=None):
            before = [e.clone() for e in state.ema.values()]
            metrics = step(state, batch, target_is_video, draws)
            torch._foreach_copy_(list(state.ema.values()), before)
            return metrics

        bundle.train_step = unshadowed
        return
    raise ValueError(f"no fault {fault!r}")


def readings(cell: Cell, seed: int, batches: int, control: str = "none",
             device="cuda") -> Dict[str, float]:
    """The check's numbers for a run with `seed`, without a window: the
    warm steps of the program as the cell runs it (``control`` "none");
    "fp8", the reference computed in float8 in the program's place (the
    precision below the bf16 the configuration states); or a fault planted
    in the program (``plant``: "no_dropout", "target", "half_batch",
    "no_ema"). `batches` is not used: the check takes the traffic's
    ``warm_steps``."""
    cfg, tr, device = cell.config, cell.traffic, torch.device(device)
    weights = make_weights(avs.param_shapes(cfg), part_seed(seed, "weights"), device,
                           torch.float32)
    data = Data(cfg, tr, seed, device)
    bundle = build_program(cfg, weights, data.B, device)
    if control not in ("none", "fp8"):
        plant(bundle, control)
    got, masks, rows = warm(cfg, bundle, data, int(tr["warm_steps"]))
    del bundle
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if control == "fp8":
        got = ref.train(avs.Fp8Weights(weights), cfg, rows, masks)
    return against_reference(cfg, weights, got, masks, rows)
