"""Open-loop serving: single-clip requests arrive at a fixed Poisson rate at
the program's serving runner (``serve/runner.py::InferenceRunner``), as
independent users' requests reach a served model. The runner's scheduler
thread batches them by direction (v2a or a2v) up to ``max_batch``, pads each
batch to it, and runs ``sample_one_direction``; admission blocks for room
once ``max_queue`` items wait, with no timeout, so nothing is dropped.

Traffic parameters (``traffic/<mix>.json``):
  rate            requests a second, offered open loop (exponential gaps)
  v2a_share       the share of requests that are v2a, drawn per request; the
                  rest are a2v
  pool            prompts of each kind made in set-up (uint8 frames and
                  float32 waveforms, handed to the runner as arrays)
  max_batch, max_queue   the runner's
  profile_seconds the traffic profiled after the window of a --trace 1 run
  check_batches   batches of each direction compared, the first ones of the
                  window

Set-up draws the weights on the card from --seed, builds the runner (bf16,
as served) and loads them, makes the prompt pools, and runs one full batch
of each direction (each one's captured graph). Request n takes its
direction and prompt from --seed and n. The window is ``seconds`` long;
``clips_per_s`` counts the clips of the batches that end inside it over its
length. Arrivals stop at its end and the queue drains. The runner draws
each batch's initial noise itself: the check takes the noise, the latents
the sampler's checked passes read, their guided predictions and the sampled
latent through the sample driver's ``Tap`` (and ``VideoTap`` for a2v), and
compares v2a batches with ``reference/av_sampling.py`` and a2v batches with
``reference/av_a2v.py``, by the numbers of ``compare`` that the cell's
limits file names.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.drivers.sample import Tap, rel_error
from benchmark.harness import Cell, Outcome
from benchmark.reference import av_a2v as ref_a2v
from benchmark.reference import av_sampling as ref
from benchmark.seeds import part_seed
from benchmark.weights import make_weights

DIRECTIONS = {"v2a": "audio", "a2v": "video"}  # a direction's target modality


class VideoTap(Tap):
    """The sample driver's ``Tap`` on the video methods (``tokenize_video``,
    ``untokenize_video``, ``decode_video``): the passes of an a2v call."""

    def __init__(self, model, passes):  # noqa: the parent's __init__ taps audio
        self.passes = frozenset(passes)
        self.tokenize, self.untokenize = model.tokenize_video, model.untokenize_video
        self.decode = model.decode_video
        self.n, self.seen, self.kept = 0, {}, None
        model.tokenize_video, model.untokenize_video = self.tokenize_audio, self.untokenize_audio
        model.decode_video = self.decode_audio


class ServeTap:
    """Both directions' taps on one model. A call tokenizes its prompt once
    through the other modality's method, which that modality's tap counts
    as a pass: each call's decode clears the other tap."""

    def __init__(self, model, cfg: Dict, seed: int):
        self.taps = {"v2a": Tap(model, checked_passes(cfg, "v2a", seed)),
                     "a2v": VideoTap(model, checked_passes(cfg, "a2v", seed))}
        decode_audio, decode_video = model.decode_audio, model.decode_video

        def audio_end(z):
            self.clear("a2v")
            return decode_audio(z)

        def video_end(z, *args, **kwargs):
            self.clear("v2a")
            return decode_video(z, *args, **kwargs)

        model.decode_audio, model.decode_video = audio_end, video_end

    def clear(self, direction: str) -> None:
        tap = self.taps[direction]
        tap.n, tap.seen = 0, {}

    def take(self, direction: str):
        return self.taps[direction].take()


def checked_passes(cfg: Dict, direction: str, seed: int) -> Tuple[int, ...]:
    """The first pass, one drawn from the seed between it and the last, and
    the last, of the direction's sampler."""
    steps = int(cfg["diffusion"][DIRECTIONS[direction]]["sampler_steps"])
    if steps < 3:
        return tuple(range(1, steps + 1))
    return (1, 2 + part_seed(seed, "pass") % (steps - 2), steps)


class Inputs:
    """The prompt pools and the requests of one run, all from --seed."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int):
        s = ref.sizes(cfg)
        self.cfg, self.seed, self.traffic = cfg, seed, traffic
        rng = np.random.default_rng(part_seed(seed, "prompts"))
        n = int(traffic["pool"])
        self.pools = {"v2a": rng.integers(0, 256, (n, s["T"], s["H"], s["W"], 3), dtype=np.uint8),
                      "a2v": (0.5 * rng.standard_normal((n, s["L"]))).clip(-1, 1)
                      .astype(np.float32)}

    def request(self, n: int):
        """Request n (negative: set-up's): its direction and prompt."""
        from multimodal_diffusion_torch.serve.runner import Request

        rng = np.random.default_rng(part_seed(self.seed, "batches", n % (1 << 32)))
        direction = "v2a" if rng.random() < float(self.traffic["v2a_share"]) else "a2v"
        pool = self.pools[direction]
        return Request(id=str(n), direction=direction, prompt=pool[rng.integers(len(pool))])

    def warm(self, direction: str, n: int):
        from multimodal_diffusion_torch.serve.runner import Request

        pool = self.pools[direction]
        return Request(id=f"warm-{direction}-{n}", direction=direction, prompt=pool[n % len(pool)])


class Recorder:
    """Stands in for the scheduler's executor: runs each batch under a
    ``bench.serve_batch`` range, notes when it ended and how many clips it
    held, and keeps, for the first ``keep`` batches of each direction that
    start at or after ``since``, the padded prompt batch, what the tap kept
    and the outputs of its clips."""

    def __init__(self, runner, tap: ServeTap, keep: int):
        from multimodal_diffusion_torch.serve.runner import pad_batch

        self.run, self.tap, self.keep, self.pad = runner.scheduler._run, tap, keep, pad_batch
        self.max_batch = runner.scheduler.max_batch
        self.since, self.ended, self.kept = math.inf, [], {"v2a": [], "a2v": []}
        runner.scheduler._run = self.run_batch

    def run_batch(self, items) -> None:
        t0 = time.monotonic()
        with torch.profiler.record_function("bench.serve_batch"):
            self.run(items)
        direction = items[0].direction
        kept = self.tap.take(direction)
        self.ended.append((time.monotonic(), len(items)))
        if t0 >= self.since and len(self.kept[direction]) < self.keep:
            self.kept[direction].append((self.pad([it.prompt for it in items], self.max_batch),
                                         kept, [np.asarray(it.out) for it in items]))

    def clips_between(self, lo: float, hi: float) -> int:
        return sum(n for t, n in self.ended if lo <= t <= hi)


def build_runner(cfg: Dict, traffic: Dict, weights: Dict[str, torch.Tensor], device):
    """The program's runner as it serves (bf16 weights), the benchmark's
    weights loaded by name."""
    from multimodal_diffusion_torch.serve.runner import InferenceRunner

    runner = InferenceRunner(cfg, bf16_params=True, max_batch=int(traffic["max_batch"]),
                             max_queue=int(traffic["max_queue"]), device=device)
    runner.model.load_state_dict(weights, strict=True)
    return runner


def offer(runner, inputs: Inputs, first: int, seconds: float) -> List:
    """Poisson arrivals for `seconds` from now, requests `first` on; each
    admitted as it arrives (blocking while the queue is full)."""
    rate = float(inputs.traffic["rate"])
    rng = np.random.default_rng(part_seed(inputs.seed, "batches", (1 << 32) + first))
    start = time.monotonic()
    due, reqs = start + rng.exponential(1.0 / rate), []
    while due < start + seconds:
        time.sleep(max(0.0, due - time.monotonic()))
        reqs.append(runner.submit(inputs.request(first + len(reqs)), timeout=None))
        due += rng.exponential(1.0 / rate)
    return reqs


def wait(reqs, limit_s: float = 600.0) -> None:
    deadline = time.monotonic() + limit_s
    for r in reqs:
        if not r.done.wait(max(0.0, deadline - time.monotonic())):
            raise TimeoutError(f"request {r.id} not done after {limit_s} s")


def compare(weights, cfg: Dict, kept: Dict[str, list], device, seed: int) -> Dict[str, float]:
    """The check's numbers over the kept batches ((padded prompts, what the
    tap kept, the clips' outputs); the program's, or a control's in its
    place), each batch's noise the latent its first pass read:

      eps_rel_err, eps_later_rel_err, latent_rel_err, wav_rel_err   v2a, as the
          sample driver's ``compare`` reads them;
      a2v_eps_rel_err, a2v_eps_later_rel_err   the widest of a clip of the
          guided prediction at the first pass, and at the later checked ones
          (the reference's at the latent the program's pass read);
      a2v_latent_rel_err   the sampled video latent against the reference's
          whole run from the same noise, pooled over the rows;
      a2v_frames_rel_err   the widest of a clip of the program's uint8 frames
          against the reference decoder on the program's latent (255 x).

    A pass or output the program did not show reads as infinite."""
    errs = {k: [] for k in ("eps", "eps_later", "wav", "a2v_eps", "a2v_eps_later",
                            "a2v_frames")}
    latent = {"v2a": [0.0, 0.0], "a2v": [0.0, 0.0]}
    for direction, batches in kept.items():
        pre = "" if direction == "v2a" else "a2v_"
        passes = checked_passes(cfg, direction, seed)
        for prompts, tapped, outs in batches:
            seen, z = tapped if tapped is not None else ({}, None)
            if 1 not in seen or z is None:
                for k in ("eps", "eps_later"):
                    errs[pre + k].append(math.inf)
                latent[direction][0] = math.inf
                continue
            prompt = torch.as_tensor(prompts, device=device)
            if direction == "v2a":
                P = ref.Prompt(weights, cfg, prompt)
                _, z_ref, _ = ref.sample_v2a(weights, P, seen[1][0])
                guided = lambda z_k, k: ref.guided(weights, P, z_k, k)  # noqa: E731
            else:
                P = ref_a2v.AudioPrompt(weights, cfg, prompt)
                _, z_ref, _ = ref_a2v.sample_a2v(weights, P, seen[1][0])
                guided = lambda z_k, k: ref_a2v.guided(weights, P, z_k, k)  # noqa: E731
            for k in passes:
                z_k, e_k = seen.get(k, (None, None))
                key = pre + ("eps" if k == passes[0] else "eps_later")
                errs[key] += ([math.inf] if e_k is None
                              else rel_error(e_k, guided(z_k.float(), k)).tolist())
            latent[direction][0] += float(torch.sum((z.float() - z_ref) ** 2))
            latent[direction][1] += float(torch.sum(z_ref ** 2))
            n = len(outs)
            got = torch.as_tensor(np.stack(outs), device=device)
            if direction == "v2a":
                want = ref.decode_audio(weights, P.s, z[:n].float())
                errs["wav"] += rel_error(got, want).tolist()
            else:
                want = 255.0 * ref_a2v.decode_video(weights, P.s, z[:n].float(), P.activation)
                errs["a2v_frames"] += rel_error(got, want.permute(0, 2, 3, 4, 1)).tolist()
    out = {f"{k}_rel_err": max(v, default=math.inf) for k, v in errs.items()}
    for direction, (num, den) in latent.items():
        pre = "" if direction == "v2a" else "a2v_"
        out[f"{pre}latent_rel_err"] = math.sqrt(num / den) if den else math.inf
    return out


def start(cell: Cell, seed: int, device, control: str = "none"):
    """Weights, inputs, the runner with the control planted, its tap and
    recorder, and one warm batch of each direction."""
    cfg, tr = cell.config, cell.traffic
    if "prompt" not in _request_fields():
        raise SystemExit("this program's serving Request takes no in-memory prompt")
    weights = make_weights(ref.param_shapes(cfg), part_seed(seed, "weights"), device)
    runner = build_runner(cfg, tr, weights, device)
    plant(runner.model, cfg, control)
    tap = ServeTap(runner.model, cfg, seed)
    rec = Recorder(runner, tap, int(tr["check_batches"]))
    inputs = Inputs(cfg, tr, seed)
    for direction in DIRECTIONS:
        wait([runner.submit(inputs.warm(direction, j), timeout=None)
              for j in range(int(tr["max_batch"]))])
    return weights, runner, rec, inputs


def _request_fields():
    import dataclasses

    from multimodal_diffusion_torch.serve.runner import Request

    return {f.name for f in dataclasses.fields(Request)}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t0: float = None) -> Outcome:
    t0 = time.perf_counter() if t0 is None else t0
    tr, cfg = cell.traffic, cell.config
    device = torch.device(device)
    cuda = device.type == "cuda"
    weights, runner, rec, inputs = start(cell, seed, device)
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    try:
        rec.since = w0 = time.monotonic()
        reqs = offer(runner, inputs, 0, seconds)
        time.sleep(max(0.0, w0 + seconds - time.monotonic()))
        done = rec.clips_between(w0, w0 + seconds)
        wait(reqs)
        ctx = {"cfg": cfg, "traffic": tr}
        if trace:
            from torch.profiler import ProfilerActivity, profile

            from benchmark.devicetrace import DeviceTrace

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                p0 = time.perf_counter()
                wait(offer(runner, inputs, len(reqs), float(tr["profile_seconds"])))
                if cuda:
                    torch.cuda.synchronize(device)
                window_s = time.perf_counter() - p0
            ctx["trace"] = DeviceTrace.of(prof, window_s)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    finally:
        runner.close()
    failed = sum(r.error is not None for r in reqs)
    del runner
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare(weights, cfg, rec.kept, device, seed)
    checks = [(k, numbers[k] if math.isfinite(numbers[k]) else math.inf, float(limit))
              for k, limit in cell.limits.items()]
    return Outcome(values={"clips_per_s": done / seconds, "setup_s": setup_s}, context=ctx,
                   attempted=len(reqs), failed=failed, memory_peak_bytes=int(peak),
                   checks=checks)


def plant(model, cfg: Dict, control: str) -> None:
    """A fault of the sampler's later passes, planted in the program, in
    either direction: from the second pass of each call on, "guidance" makes
    the guided prediction with guidance scale 1 in place of the
    configuration's; "stale" returns the first pass's prediction again."""
    if control == "none":
        return
    if control not in ("guidance", "stale"):
        raise ValueError(f"no control {control!r}")
    denoise, state = model.denoise_tokens, {"v2a": 0, "a2v": 0, "first": None}
    steps = {k: int(cfg["diffusion"][t]["sampler_steps"]) for k, t in DIRECTIONS.items()}
    gs = cfg["sampling"]["guidance_scale"]

    def faulty(tok_v, tok_a, t_v, t_a, grid, keep_v, keep_a, **kwargs):
        # the target's keep mask is all ones: it says which direction samples
        direction = "v2a" if bool(keep_a.min() > 0) else "a2v"
        k = state[direction] = state[direction] % steps[direction] + 1
        out = denoise(tok_v, tok_a, t_v, t_a, grid, keep_v, keep_a, **kwargs)
        if k == 1:
            state["first"] = out
            return out
        if control == "stale":
            return state["first"]
        key, g = (("eps_a", float(gs["audio"])) if direction == "v2a"
                  else ("eps_v", float(gs["video"])))
        cond, null = out[key].chunk(2)
        return dict(out, **{key: torch.cat([null + (cond - null) / g, null])})

    model.denoise_tokens = faulty


def reference_outputs(weights, cfg: Dict, kept: Dict[str, list], device,
                      seed: int) -> Dict[str, list]:
    """The reference computed in float8 (``Fp8Weights``), standing in for the
    program on the kept batches' prompts and noise."""
    low = ref.Fp8Weights(weights)
    out = {}
    for direction, batches in kept.items():
        passes = checked_passes(cfg, direction, seed)
        out[direction] = []
        for prompts, tapped, outs in batches:
            noise = tapped[0][1][0]
            prompt = torch.as_tensor(prompts, device=device)
            if direction == "v2a":
                wav, z, seen = ref.sample_v2a(low, ref.Prompt(low, cfg, prompt), noise, passes)
                got = [w.cpu().numpy() for w in wav[:len(outs)]]
            else:
                frames, z, seen = ref_a2v.sample_a2v(low, ref_a2v.AudioPrompt(low, cfg, prompt),
                                                     noise, passes)
                got = [(255.0 * f.permute(1, 2, 3, 0)).cpu().numpy()
                       for f in frames[:len(outs)]]
            out[direction].append((prompts, (seen, z), got))
    return out


def readings(cell: Cell, seed: int, batches: int, control: str = "none",
             device="cuda") -> Dict[str, float]:
    """The check's numbers for `batches` batches of each direction of a run
    with `seed`, sent without a window (each batch's requests at once): for
    the program as the cell runs it (``control`` "none"), "fp8" (the
    reference computed in float8 in the program's place, on the program's
    prompts and noise), or the program with a fault planted (``plant``:
    "guidance", "stale")."""
    cfg, device = cell.config, torch.device(device)
    cell = Cell(**{**cell.__dict__, "traffic": dict(cell.traffic, check_batches=batches)})
    weights, runner, rec, inputs = start(cell, seed, device,
                                         "none" if control == "fp8" else control)
    try:
        rec.since = time.monotonic()
        for direction in DIRECTIONS:
            for b in range(batches):
                wait([runner.submit(inputs.warm(direction, b * 8 + j + 1), timeout=None)
                      for j in range(int(cell.traffic["max_batch"]))])
    finally:
        runner.close()
    kept = rec.kept
    if control == "fp8":
        kept = reference_outputs(weights, cfg, kept, device, seed)
    return compare(weights, cfg, kept, device, seed)
