"""Closed-loop FLUX.1 text-to-image: one caller sends prompts to the
program's sampling entry point (``infer/sample_flux.py::sample_flux``, the
function ``infer/sample_t2i.py`` calls for a flux config) back to back and
reads each image back to the host before it sends the next, as a
text-to-image service or batch job does.

Traffic parameters (``traffic/<mix>.json``):
  batch           images per call
  pool            prompts made in set-up (their T5-XXL token embeddings and
                  pooled CLIP-L vectors, standard normal: the towers are not
                  run), drawn from for every call
  warm_calls      calls made in set-up
  profile_calls   calls profiled after the window of a --trace 1 run
  check_batches   calls of the window whose passes and image are compared
  latent_batches  of those, the calls whose whole sampled latent is compared

Set-up draws the weights on the card from --seed tensor by tensor
(``chunked_weights.py``: 11.9 G parameters, bf16 as served), builds the
program's model around them (the weights become its parameters), makes the
prompt pool and makes the warm calls. The window runs until the first call
that ends ``seconds`` or more after it started; ``clips_per_s`` counts one
image as one clip. Call i takes its prompts and its noise seed from --seed
and i. After the window the calls chosen from --seed are compared with the
plain reference (``reference/flux_sampling.py``), by those numbers of
``compare`` that the cell's limits file names.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.chunked_weights import make_weights_by_tensor
from benchmark.harness import Cell, Outcome
from benchmark.reference import flux_sampling as ref
from benchmark.seeds import part_seed

# the program's spans whose device-side ranges the readers take
DEVICE_RANGES = ("flux.decode",)


def build_program(cfg: Dict, weights: Dict[str, torch.Tensor], device: torch.device):
    """(transformer, AE decoder) as the entry point builds them
    (``build_flux``), the benchmark's weights their parameters."""
    from multimodal_diffusion_torch.infer.sample_flux import build_flux

    return build_flux(cfg, device, weights)


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_weights_by_tensor(ref.param_shapes(cfg), part_seed(seed, "weights"), device,
                                  ref.is_norm_scale)


class Tap:
    """Stands in for the transformer's ``forward`` and the decoder's
    ``decode`` on their instances and keeps what a call hands through them:
    for each checked pass (counted at each forward of the call) the packed
    latent it read and the velocity it gave, and the latent the sampler
    decodes. A program that stops calling these through the instances once
    a pass leaves the passes unseen, and the check reads them as failed."""

    def __init__(self, model, ae, passes):
        self.passes = frozenset(passes)
        self.forward, self.decode = model.forward, ae.decode
        model.forward, ae.decode = self.model_forward, self.ae_decode
        self.n, self.seen, self.kept = 0, {}, None

    def model_forward(self, img, *args, **kwargs):
        self.n += 1
        v = self.forward(img, *args, **kwargs)
        if self.n in self.passes:
            self.seen[self.n] = (img.detach().clone(), v.detach().clone())
        return v

    def ae_decode(self, z):
        self.kept = (self.seen, z.detach().clone())
        self.n, self.seen = 0, {}
        return self.decode(z)

    def take(self):
        """({pass: (latent read, velocity)}, the decoded latent) of the last
        call, or None."""
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
    """The prompt pool and the calls of one run, all from --seed."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int):
        core, sp = cfg["model"]["core"], cfg["sampling"]
        self.cfg, self.seed, self.B = cfg, seed, int(traffic["batch"])
        gen = torch.Generator().manual_seed(part_seed(seed, "prompts"))
        n, L = int(traffic["pool"]), int(cfg["text"]["max_sequence_length"])
        self.t5 = torch.randn((n, L, int(core["context_in_dim"])), generator=gen)
        self.pooled = torch.randn((n, int(core["vec_in_dim"])), generator=gen)
        self.z_shape = (self.B, int(cfg["model"]["ae"]["z_channels"]),
                        int(sp["height"]) // 8, int(sp["width"]) // 8)

    def batch(self, i: int):
        """Call i (negative: a warm-up call): its prompt indices and the seed
        of its noise."""
        rng = np.random.default_rng(part_seed(self.seed, "batches", i % (1 << 32)))
        idx = rng.choice(len(self.t5), size=self.B, replace=len(self.t5) < self.B)
        return torch.as_tensor(idx), part_seed(self.seed, "batches", (1 << 32) + i % (1 << 32))

    def noise(self, noise_seed: int) -> torch.Tensor:
        """The noise the entry point draws from a generator seeded so."""
        return torch.randn(self.z_shape, generator=torch.Generator().manual_seed(noise_seed))


def call(model, ae, inputs: Inputs, i: int, device, tap: Tap) -> Tuple:
    """One call of the entry point on call i's prompts: the images on the
    host, and what the tap kept of it."""
    from multimodal_diffusion_torch.infer.sample_flux import sample_flux

    idx, noise_seed = inputs.batch(i)
    with torch.profiler.record_function("bench.sample_flux"):
        out = sample_flux(inputs.cfg, model, ae, inputs.t5[idx], inputs.pooled[idx], device,
                          torch.Generator().manual_seed(noise_seed))
    return out["image"], tap.take()


def rel_error(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """||got - want|| / ||want|| of each row (batch item)."""
    got, want = got.float().flatten(1), want.float().flatten(1)
    return torch.linalg.vector_norm(got - want, dim=1) / torch.linalg.vector_norm(want, dim=1)


def compare(weights, inputs: Inputs, outputs: Dict[int, Tuple], device,
            passes: Tuple[int, ...], latent_batches: int) -> Dict[str, float]:
    """The check's numbers over `outputs`' calls ((images, what the tap
    kept) by call; the program's, or a control's in its place):

      v_rel_err        the widest ||v - v_ref|| / ||v_ref|| of an image, v the
                       first pass's velocity, v_ref the reference's at the
                       call's own noise: the embedders, the RoPE, every block
                       and its kernels, before the sampler feeds anything back;
      v_later_rel_err  the same at the later checked passes (one drawn from the
                       seed, and the last), the reference's at the latent the
                       program's pass read: the time and guidance embeddings
                       at the steps the sampler feeds;
      latent_rel_err   ||z - z_ref|| / ||z_ref|| over the rows of the first
                       `latent_batches` calls, z the decoded latent, z_ref the
                       reference's whole Euler run from the same noise;
      img_rel_err      the widest of an image of the program's uint8 image
                       against the reference decoder on the program's own
                       latent (127.5 (x + 1), before truncation): the decode.

    A pass the program did not show, or an output it did not give, reads
    as infinite."""
    cfg = inputs.cfg
    ts, g, hw = ref.schedule(cfg), float(cfg["sampling"]["guidance"]), ref.grid(cfg)
    errs = {"v": [], "v_later": [], "img": []}
    latent = [0.0, 0.0]
    for j, (i, (image, kept)) in enumerate(sorted(outputs.items())):
        idx, noise_seed = inputs.batch(i)
        txt, y = inputs.t5[idx].to(device), inputs.pooled[idx].to(device)
        noise = inputs.noise(noise_seed).to(device)
        seen, z = kept if kept is not None else ({}, None)
        for k in passes:
            x_k, v_k = seen.get(k, (None, None))
            key = "v" if k == passes[0] else "v_later"
            if v_k is None:
                errs[key].append(math.inf)
                continue
            x = ref.patchify(noise) if k == 1 else x_k.float()
            errs[key] += rel_error(v_k, ref.velocity(weights, cfg, x, txt, y, ts[k - 1], g,
                                                     hw)).tolist()
        if z is None:
            latent[0] = math.inf
            errs["img"].append(math.inf)
            continue
        if j < latent_batches:
            z_ref, _ = ref.sample(weights, cfg, noise, txt, y)
            latent[0] += float(torch.sum((z.float() - z_ref) ** 2))
            latent[1] += float(torch.sum(z_ref ** 2))
        want = ref.image_values(ref.decode(weights, cfg, z))
        errs["img"] += rel_error(torch.as_tensor(image, device=device), want).tolist()
    out = {f"{k}_rel_err": max(v, default=math.inf) for k, v in errs.items()}
    out["latent_rel_err"] = math.sqrt(latent[0] / latent[1]) if latent[1] else math.inf
    return out


def device_ranges(prof, names=DEVICE_RANGES) -> Dict[str, list]:
    """The device-side intervals of the program's named ranges: the
    profiler shows a record_function range on the device too, from the first
    to the last device operation launched inside it."""
    out: Dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.name() in names:
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
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

    weights = make_weights(cfg, seed, device)
    model, ae = build_program(cfg, weights, device)
    passes = checked_passes(cfg, seed)
    tap = Tap(model, ae, passes)
    inputs = Inputs(cfg, tr, seed)
    for k in range(int(tr["warm_calls"])):
        call(model, ae, inputs, -1 - k, device, tap)
    sync()
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    outputs: Dict[int, Tuple] = {}
    start = time.perf_counter()
    i = 0
    while True:
        outputs[i] = call(model, ae, inputs, i, device, tap)
        i += 1
        wall = time.perf_counter() - start
        if wall >= seconds:
            break
    steps = int(cfg["sampling"]["steps"])
    ctx = {"cfg": cfg, "traffic": tr, "batches": i, "wall_s": wall,
           "forwards": i * inputs.B * steps}

    if trace:
        from torch.profiler import ProfilerActivity, profile

        from benchmark.devicetrace import DeviceTrace

        n = int(tr["profile_calls"])
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        sync()
        with profile(activities=acts) as prof:
            p0 = time.perf_counter()
            for k in range(n):
                call(model, ae, inputs, i + k, device, tap)
            sync()
            window_s = time.perf_counter() - p0
        ctx["trace"] = DeviceTrace.of(prof, window_s)
        ctx["device_ranges"] = device_ranges(prof)
        ctx["traced_calls"] = n
        ctx["traced_steps"] = n * steps

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del model, ae, tap
    if cuda:
        torch.cuda.empty_cache()
    rng = np.random.default_rng(part_seed(seed, "check"))
    chosen = sorted(rng.choice(i, size=min(i, int(tr["check_batches"])), replace=False))
    numbers = compare(weights, inputs, {int(j): outputs[int(j)] for j in chosen}, device,
                      passes, int(tr["latent_batches"]))
    checks = [(k, numbers[k] if math.isfinite(numbers[k]) else math.inf, float(limit))
              for k, limit in cell.limits.items()]
    return Outcome(values={"clips_per_s": i * inputs.B / wall, "setup_s": setup_s},
                   context=ctx, attempted=i * inputs.B, failed=0, memory_peak_bytes=int(peak),
                   checks=checks)


def reference_outputs(weights, inputs: Inputs, batches: int, device,
                      passes: Tuple[int, ...]) -> Dict[int, Tuple]:
    """The reference computed in float8 (``Fp8Weights``), standing in for the
    program on the first `batches` calls."""
    low = ref.Fp8Weights(weights)
    out = {}
    for i in range(batches):
        idx, noise_seed = inputs.batch(i)
        image, z, seen = ref.sample_image(low, inputs.cfg, inputs.noise(noise_seed).to(device),
                                          inputs.t5[idx].to(device),
                                          inputs.pooled[idx].to(device), passes)
        out[i] = (image.cpu().numpy(), (seen, z))
    return out


def rotate_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE in the rotate-half layout (the first half of a head against its
    second half): the layout the port's AV core uses, not FLUX.1's pairs."""
    x0, x1 = x.chunk(2, dim=-1)
    return torch.cat([cos * x0 - sin * x1, sin * x0 + cos * x1], dim=-1)


def plant(model, cfg: Dict, fault: str) -> None:
    """A fault planted in the program: "stale" returns the first pass's
    velocity at every later pass of a call (a replayed graph with stale
    inputs); "guidance" feeds 1.0 to the guidance embedder in place of the
    configuration's; "rope" rotates q and k in the rotate-half layout in
    place of adjacent pairs (a module-wide swap, for the process)."""
    if fault == "rope":
        from multimodal_diffusion_torch.models import flux

        flux.apply_rope = rotate_half
        return
    steps = int(cfg["sampling"]["steps"])
    forward, state = model.forward, {"n": 0, "first": None}

    def faulty(img, img_ids, txt, txt_ids, timesteps, y, guidance=None):
        k, state["n"] = state["n"] % steps + 1, state["n"] + 1
        if fault == "guidance":
            return forward(img, img_ids, txt, txt_ids, timesteps, y, torch.ones_like(guidance))
        out = forward(img, img_ids, txt, txt_ids, timesteps, y, guidance)
        if k == 1:
            state["first"] = out
        return state["first"] if fault == "stale" else out

    if fault not in ("stale", "guidance"):
        raise ValueError(f"no fault {fault!r}")
    model.forward = faulty


def readings(cell: Cell, seed: int, batches: int, control: str = "none",
             device="cuda") -> Dict[str, float]:
    """The check's numbers for the first `batches` calls of a run with
    `seed`, without a window: for the program as the cell runs it
    (``control`` "none"); for "fp8", the reference computed in float8 in the
    program's place (the precision below the bf16 the configuration
    states); or for the program with a fault planted (``plant``: "stale",
    "guidance", "rope")."""
    cfg, device = cell.config, torch.device(device)
    # the taps and faults tie a model to its instance's methods: a cycle that
    # holds an earlier seed's 23.8 GB of weights until the collector runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    weights = make_weights(cfg, seed, device)
    inputs = Inputs(cfg, cell.traffic, seed)
    passes = checked_passes(cfg, seed)
    latent_batches = int(cell.traffic["latent_batches"])
    if control == "fp8":
        return compare(weights, inputs, reference_outputs(weights, inputs, batches, device,
                                                          passes), device, passes,
                       latent_batches)
    model, ae = build_program(cfg, weights, device)
    if control != "none":
        plant(model, cfg, control)
    tap = Tap(model, ae, passes)
    outputs = {i: call(model, ae, inputs, i, device, tap) for i in range(batches)}
    del model, ae, tap
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return compare(weights, inputs, outputs, device, passes, latent_batches)
