"""Closed-loop CogVideoX text-to-video: one caller sends prompts to the
program's sampling entry point (``infer/sample_cogvideox.py::
sample_cogvideox``, the function its CLI calls) back to back and reads each
video back to the host before it sends the next, as a text-to-video service
or batch job does.

Traffic parameters (``traffic/<mix>.json``):
  batch           videos per call
  pool            prompts made in set-up (their T5-XXL token states,
                  standard normal, and one negative prompt's: the tower is
                  not run), drawn from for every call
  warm_calls      calls made in set-up
  warm_steps      the sampler steps of a warm call: every step runs the
                  shapes of every other, so a short call warms them all
  profile_calls   calls profiled after the window of a --trace 1 run
  check_batches   calls of the window compared, the first ones

Set-up draws the weights on the card from --seed tensor by tensor
(``chunked_weights.py``: 5.6 G parameters, bf16 as served), builds the
program's model around them and makes the warm calls. The window runs until
the first call that ends ``seconds`` or more after it started;
``clips_per_s`` counts one video as one clip. Call i takes its prompts and
its noise seed from --seed and i. After the window the first calls are
compared with the plain reference (``reference/cogvideox_sampling.py``), by
those numbers of ``compare`` that the cell's limits file names. The
whole-run latent is not compared: its float32 reference takes 50 passes of
0.66 PFLOP, about ten minutes on the card.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.chunked_weights import make_weights_by_tensor
from benchmark.drivers.flux import device_ranges, rel_error, rotate_half
from benchmark.harness import Cell, Outcome
from benchmark.reference import cogvideox_sampling as ref
from benchmark.seeds import part_seed

# the program's spans whose device-side ranges the readers take
DEVICE_RANGES = ("cogvideox.decode",)


def build_program(cfg: Dict, weights: Dict[str, torch.Tensor], device: torch.device):
    """(transformer, VAE decoder) as the entry point builds them
    (``build_cogvideox``), the benchmark's weights their parameters."""
    from multimodal_diffusion_torch.infer.sample_cogvideox import build_cogvideox

    return build_cogvideox(cfg, device, weights)


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_weights_by_tensor(ref.param_shapes(cfg), part_seed(seed, "weights"), device,
                                  ref.is_norm_scale)


class Tap:
    """Stands in for the transformer's ``forward`` and the decoder's
    ``decode`` on their instances and keeps what a call hands through them:
    for each watched pass (counted at each forward of the call) the latent
    it read (the first half of its [uncond; cond] batch) and its raw
    [uncond; cond] prediction, and the latent the sampler decodes. The
    latent after pass k is pass k + 1's input, or the decoded latent after
    the last. A program that stops calling these through the instances once
    a pass leaves the passes unseen, and the check reads them as failed."""

    def __init__(self, model, vae, passes, steps: int):
        self.watch = frozenset(passes) | {k + 1 for k in passes if k < steps}
        self.forward, self.decode = model.forward, vae.decode
        model.forward, vae.decode = self.model_forward, self.vae_decode
        self.n, self.seen, self.kept = 0, {}, None

    def model_forward(self, x, *args, **kwargs):
        self.n += 1
        v = self.forward(x, *args, **kwargs)
        if self.n in self.watch:
            self.seen[self.n] = (x[:x.shape[0] // 2].detach().clone(), v.detach().clone())
        return v

    def vae_decode(self, z, *args, **kwargs):
        self.kept = (self.seen, z.detach().permute(0, 2, 1, 3, 4).clone())
        self.n, self.seen = 0, {}
        return self.decode(z, *args, **kwargs)

    def take(self):
        """({pass: (latent read, raw prediction)}, the decoded latent [B, F,
        C, h, w]) of the last call, or None."""
        kept, self.kept = self.kept, None
        return kept


def checked_passes(cfg: Dict, seed: int) -> Tuple[int, ...]:
    """The first pass, one drawn from the seed between it and the last, and
    the last."""
    steps = int(cfg["sampling"]["steps"])
    if steps < 3:
        return tuple(range(1, steps + 1))
    return (1, 2 + part_seed(seed, "pass") % (steps - 2), steps)


class Inputs:
    """The prompt pool, the negative prompt and the calls of one run, all
    from --seed."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int):
        from multimodal_diffusion_torch.infer.sample_cogvideox import latent_shape

        self.cfg, self.seed, self.B = cfg, seed, int(traffic["batch"])
        gen = torch.Generator().manual_seed(part_seed(seed, "prompts"))
        L = int(cfg["text"]["max_sequence_length"])
        D = int(cfg["model"]["core"]["text_embed_dim"])
        self.text = torch.randn((int(traffic["pool"]), L, D), generator=gen)
        self.negative = torch.randn((1, L, D), generator=gen).expand(self.B, L, D)
        self.z_shape = latent_shape(cfg, self.B)

    def batch(self, i: int):
        """Call i (negative: a warm-up call): its prompt indices and the seed
        of its noise."""
        rng = np.random.default_rng(part_seed(self.seed, "batches", i % (1 << 32)))
        idx = rng.choice(len(self.text), size=self.B, replace=len(self.text) < self.B)
        return torch.as_tensor(idx), part_seed(self.seed, "batches", (1 << 32) + i % (1 << 32))

    def noise(self, noise_seed: int) -> torch.Tensor:
        """The noise the entry point draws from a generator seeded so."""
        return torch.randn(self.z_shape, generator=torch.Generator().manual_seed(noise_seed))


def call(model, vae, inputs: Inputs, i: int, device, tap: Tap, **kw) -> Tuple:
    """One call of the entry point on call i's prompts (``kw``: its steps
    or guidance in place of the configuration's): the videos on the host,
    and what the tap kept of it."""
    from multimodal_diffusion_torch.infer.sample_cogvideox import sample_cogvideox

    idx, noise_seed = inputs.batch(i)
    with torch.profiler.record_function("bench.sample_cogvideox"):
        out = sample_cogvideox(inputs.cfg, model, vae, inputs.text[idx], inputs.negative, device,
                               torch.Generator().manual_seed(noise_seed), **kw)
    return out["video"], tap.take()


def compare(weights, inputs: Inputs, outputs: Dict[int, Tuple], device,
            passes: Tuple[int, ...]) -> Dict[str, float]:
    """The check's numbers over `outputs`' calls ((videos, what the tap
    kept) by call; the program's, or a control's in its place):

      v_rel_err        the widest ||v - v_ref|| / ||v_ref|| of a video, v the
                       first pass's guided prediction v_u + g (v_c - v_u) made
                       from the program's raw [uncond; cond] output, v_ref the
                       reference's at the call's own noise: the embedders, the
                       RoPE, every block and its kernels;
      v_later_rel_err  the same at the later checked passes (one drawn from the
                       seed, and the last), the reference's at the latent the
                       program's pass read: the time embedding at the steps the
                       sampler feeds;
      step_rel_err     the widest, over the checked passes, of the latent the
                       program's sampler made from the pass against the
                       reference's DDIM update of the latent the pass read by
                       the reference's v: the guidance and the update;
      video_rel_err    the widest of a video of the program's uint8 frames
                       against the reference decoder on the program's own
                       latent (255 clamp(x / 2 + 0.5), before rounding): the
                       decode.

    A pass the program did not show, or an output it did not give, reads
    as infinite."""
    cfg = inputs.cfg
    abar, ts = ref.schedule(cfg)
    g, B = float(cfg["sampling"]["guidance"]), inputs.B
    errs = {"v": [], "v_later": [], "step": [], "video": []}
    for i, (video, kept) in sorted(outputs.items()):
        idx, noise_seed = inputs.batch(i)
        text, neg = inputs.text[idx].to(device), inputs.negative.to(device)
        seen, z = kept if kept is not None else ({}, None)
        for k in passes:
            key = "v" if k == passes[0] else "v_later"
            x_k, raw = seen.get(k, (None, None))
            after = seen.get(k + 1, (None,))[0] if k < len(ts) - 1 else z
            if raw is None:
                errs[key].append(math.inf)
                errs["step"].append(math.inf)
                continue
            x = inputs.noise(noise_seed).to(device) if k == 1 else x_k.float()
            want = ref.guided(weights, cfg, x, text, neg, ts[k - 1], g)
            raw = raw.float()
            errs[key] += rel_error(raw[:B] + g * (raw[B:] - raw[:B]), want).tolist()
            if after is None:
                errs["step"].append(math.inf)
                continue
            step = ref.ddim_update(x_k.float(), want, *ref.step_alphas(abar, ts, k))
            errs["step"] += rel_error(after, step).tolist()
        if z is None:
            errs["video"].append(math.inf)
            continue
        want = ref.video_values(ref.decode(weights, cfg, z))
        errs["video"] += rel_error(torch.as_tensor(video, device=device), want).tolist()
    return {f"{k}_rel_err": max(v, default=math.inf) for k, v in errs.items()}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t0: float = None) -> Outcome:
    t0 = time.perf_counter() if t0 is None else t0
    tr, cfg = cell.traffic, cell.config
    device = torch.device(device)
    cuda = device.type == "cuda"
    steps = int(cfg["sampling"]["steps"])

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    weights = make_weights(cfg, seed, device)
    model, vae = build_program(cfg, weights, device)
    passes = checked_passes(cfg, seed)
    tap = Tap(model, vae, passes, steps)
    inputs = Inputs(cfg, tr, seed)
    for k in range(int(tr["warm_calls"])):
        call(model, vae, inputs, -1 - k, device, tap, steps=int(tr["warm_steps"]))
    sync()
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    outputs: Dict[int, Tuple] = {}
    start = time.perf_counter()
    i = 0
    while True:
        outputs[i] = call(model, vae, inputs, i, device, tap)
        i += 1
        wall = time.perf_counter() - start
        if wall >= seconds:
            break
    # sample passes: the [uncond; cond] batch is 2 B samples a step
    ctx = {"cfg": cfg, "traffic": tr, "batches": i, "wall_s": wall,
           "forwards": i * 2 * inputs.B * steps}

    if trace:
        from torch.profiler import ProfilerActivity, profile

        from benchmark.devicetrace import DeviceTrace

        n = int(tr["profile_calls"])
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        sync()
        with profile(activities=acts) as prof:
            p0 = time.perf_counter()
            for k in range(n):
                call(model, vae, inputs, i + k, device, tap)
            sync()
            window_s = time.perf_counter() - p0
        ctx["trace"] = DeviceTrace.of(prof, window_s)
        ctx["device_ranges"] = device_ranges(prof, DEVICE_RANGES)
        ctx["traced_calls"] = n
        ctx["traced_steps"] = n * steps
        del prof

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del model, vae, tap
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    chosen = range(min(i, int(tr["check_batches"])))
    numbers = compare(weights, inputs, {j: outputs[j] for j in chosen}, device, passes)
    checks = [(k, numbers[k] if math.isfinite(numbers[k]) else math.inf, float(limit))
              for k, limit in cell.limits.items()]
    return Outcome(values={"clips_per_s": i * inputs.B / wall, "setup_s": setup_s},
                   context=ctx, attempted=i * inputs.B, failed=0, memory_peak_bytes=int(peak),
                   checks=checks)


def plant(model, vae, cfg: Dict, control: str, weights, passes) -> Dict:
    """A control planted in the program, and the keywords its calls take.
    "fp8": the reference computed in float8 (``Fp8Weights``) stands in for
    the transformer at the checked passes and for the decoder (the
    precision below the bf16 the configuration states). Faults: "stale"
    returns the first pass's prediction at every later pass of a call;
    "guidance" samples at guidance 1.0; "rope" rotates q and k in the
    rotate-half layout ("rope" and "update" are module-wide swaps, for the
    process); "update" steps with epsilon in place of v in the DDIM update;
    "mod" swaps the text and video modulation chunks of every block."""
    from multimodal_diffusion_torch.infer import sample_cogvideox as sampler
    from multimodal_diffusion_torch.models import cogvideox

    steps = int(cfg["sampling"]["steps"])
    forward, state = model.forward, {"n": 0, "first": None}
    if control == "fp8":
        low = ref.Fp8Weights(weights)

        def stand_in(x, ctx, t):
            state["n"] = state["n"] % steps + 1
            if state["n"] not in passes:
                return forward(x, ctx, t)
            return ref.velocity(low, cfg, x, ctx, int(t[0]))

        model.forward = stand_in
        vae.decode = lambda z: ref.decode(low, cfg, z.permute(0, 2, 1, 3, 4))
    elif control == "stale":
        def faulty(x, ctx, t):
            state["n"] = state["n"] % steps + 1
            out = forward(x, ctx, t)
            if state["n"] == 1:
                state["first"] = out
            return state["first"]

        model.forward = faulty
    elif control == "guidance":
        return {"guidance": 1.0}
    elif control == "rope":
        cogvideox.apply_rope = rotate_half
    elif control == "update":
        ddim_step = sampler.ddim_step
        sampler.ddim_step = lambda *a, **kw: ddim_step(*a, **dict(kw, param="eps"))
    elif control == "mod":
        for block in model.transformer_blocks:
            for norm in (block.norm1, block.norm2):
                linear = norm.linear.forward
                norm.linear.forward = lambda e, f=linear: torch.cat(f(e).chunk(2, -1)[::-1], -1)
    elif control != "none":
        raise ValueError(f"no control {control!r}")
    return {}


def readings(cell: Cell, seed: int, batches: int, control: str = "none",
             device="cuda") -> Dict[str, float]:
    """The check's numbers for the first `batches` calls of a run with
    `seed`, without a window: for the program as the cell runs it
    (``control`` "none"), or with a control planted (``plant``: "fp8",
    "stale", "guidance", "rope", "update", "mod")."""
    cfg, device = cell.config, torch.device(device)
    # the taps and plants tie a model to its instance's methods: a cycle that
    # holds an earlier seed's weights until the collector runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    weights = make_weights(cfg, seed, device)
    inputs = Inputs(cfg, cell.traffic, seed)
    passes = checked_passes(cfg, seed)
    model, vae = build_program(cfg, weights, device)
    kw = plant(model, vae, cfg, control, weights, passes)
    tap = Tap(model, vae, passes, int(cfg["sampling"]["steps"]))
    outputs = {i: call(model, vae, inputs, i, device, tap, **kw) for i in range(batches)}
    del model, vae, tap
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return compare(weights, inputs, outputs, device, passes)
