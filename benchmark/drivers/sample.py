"""Closed-loop sampling: one caller sends batches of prompts to the
program's sampling entry point (``infer/sample_clip.py::
sample_one_direction``) back to back and reads each batch's output back to
the host before it sends the next, as the sampling CLI and batch jobs do.

Traffic parameters (``traffic/<mix>.json``):
  direction      "v2a": video prompts, audio generated
  batch          clips per call
  pool           prompts made in set-up, drawn from for every batch
  warm_calls     calls made in set-up (every shape the window uses)
  profile_calls  calls profiled after the window of a --trace 1 run
  check_batches  batches of the window compared with the reference

Set-up builds the model on the card from weights drawn from --seed (bf16,
as served), makes the prompt pool and makes the warm calls. The window runs
until the first batch that ends ``seconds`` or more after it started;
``clips_per_s`` is the clips of every batch it ran over its whole time.
Batch i takes its prompts and its initial noise from seeds derived from
--seed and i, so the reference can make batch i again from the same
inputs. After the window (and, with --trace 1, the profiled calls) the
program's model is freed and ``check_batches`` batches drawn from --seed
are compared with the plain reference (``reference/av_sampling.py``), by
those numbers of ``compare`` that the cell's limits file names.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.harness import Cell, Outcome
from benchmark.reference import av_sampling as ref
from benchmark.seeds import part_seed
from benchmark.weights import make_weights


def build_program(cfg: Dict, weights: Dict[str, torch.Tensor], device: torch.device):
    """The program's model on `device`, as its entry point builds it for
    serving (``build_components`` with ``bf16_params``), with the benchmark's
    weights loaded by name."""
    from multimodal_diffusion_torch.models.diffusion import AVDiffusionConfig, AVDiffusionModel
    from multimodal_diffusion_torch.train.checkpoint import cast_params_bf16
    from multimodal_diffusion_torch.utils.io import compute_dtype_from_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = compute_dtype_from_config(cfg)
    with torch.device(device):
        model = AVDiffusionModel(AVDiffusionConfig.from_config(cfg, dtype=dtype))
    if dtype == torch.bfloat16:
        cast_params_bf16(model)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def int8_config(cfg: Dict) -> Dict:
    """`cfg` with the program's own int8 path switched on: W8A8 on the core's
    four projections (model.core.quant)."""
    return dict(cfg, model=dict(cfg["model"], core=dict(cfg["model"]["core"], quant="int8")))


class Tap:
    """Stands in for three of the model's methods and keeps what the entry
    point hands through them in a call: the latent each checked pass of the
    sampler reads (``tokenize_audio``), the guided prediction it makes of it
    (``untokenize_audio``), and the latent the sampler returns
    (``decode_audio``). A pass is counted at each ``tokenize_audio`` of the
    call; ``passes`` are the ones kept (1 for the first).

    The check leans on this call structure: a program that stops calling
    these methods through the model once a pass (a captured graph of the
    sampler, a fused loop) leaves the passes unseen, and the check reads
    them as failed. Such a change needs the tap moved first."""

    def __init__(self, model, passes):
        self.passes = frozenset(passes)
        self.tokenize, self.untokenize = model.tokenize_audio, model.untokenize_audio
        self.decode = model.decode_audio
        self.n, self.seen, self.kept = 0, {}, None
        model.tokenize_audio, model.untokenize_audio = self.tokenize_audio, self.untokenize_audio
        model.decode_audio = self.decode_audio

    def tokenize_audio(self, z: torch.Tensor) -> torch.Tensor:
        self.n += 1
        if self.n in self.passes:
            self.seen[self.n] = [z.detach().clone(), None]
        return self.tokenize(z)

    def untokenize_audio(self, tok: torch.Tensor, latent_shape) -> torch.Tensor:
        if self.n in self.seen:
            self.seen[self.n][1] = tok.detach().clone()
        return self.untokenize(tok, latent_shape)

    def decode_audio(self, z: torch.Tensor) -> torch.Tensor:
        self.kept = ({k: tuple(v) for k, v in self.seen.items()}, z.detach().clone())
        self.n, self.seen = 0, {}
        return self.decode(z)

    def take(self):
        """What the last call kept: ({pass: (latent, guided prediction)},
        the sampled latent), or None when the call kept nothing."""
        kept, self.kept = self.kept, None
        return kept


def checked_passes(cfg: Dict, seed: int) -> Tuple[int, ...]:
    """The sampler's passes the check compares: the first, one drawn from
    the seed between the first and the last, and the last."""
    steps = int(cfg["diffusion"]["audio"]["sampler_steps"])
    if steps < 3:
        return tuple(range(1, steps + 1))
    return (1, 2 + part_seed(seed, "pass") % (steps - 2), steps)


class Inputs:
    """The prompt pool and the batches of one run, all from --seed."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int):
        s = ref.sizes(cfg)
        self.cfg, self.seed, self.B = cfg, seed, int(traffic["batch"])
        rng = np.random.default_rng(part_seed(seed, "prompts"))
        self.pool = rng.integers(0, 256, (int(traffic["pool"]), s["T"], s["H"], s["W"], 3),
                                 dtype=np.uint8)
        self.z_shape = (self.B, s["Ca"], s["Fa"])

    def batch(self, i: int):
        """Batch i (negative: a warm-up call): its prompt indices and the
        seed of its initial noise."""
        rng = np.random.default_rng(part_seed(self.seed, "batches", i % (1 << 32)))
        idx = rng.choice(len(self.pool), size=self.B, replace=len(self.pool) < self.B)
        return idx, part_seed(self.seed, "batches", (1 << 32) + i % (1 << 32))

    def z_init(self, noise_seed: int) -> torch.Tensor:
        return torch.randn(self.z_shape, generator=torch.Generator().manual_seed(noise_seed))


def call(model, inputs: Inputs, i: int, device, tap: Tap) -> Tuple:
    """One call of the entry point on batch i: the waveforms on the host,
    and what the tap kept of it."""
    from multimodal_diffusion_torch.infer.sample_clip import sample_one_direction

    idx, noise_seed = inputs.batch(i)
    with torch.profiler.record_function("bench.sample_one_direction"):
        out = sample_one_direction(cfg=inputs.cfg, model=model, prompt_modality="video",
                                   prompt_video=inputs.pool[idx], device=device,
                                   generator=torch.Generator().manual_seed(noise_seed))
    return out["audio"], tap.take()


def rel_error(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """||got - want|| / ||want|| of each row (batch item)."""
    got, want = got.float().flatten(1), want.float().flatten(1)
    return torch.linalg.vector_norm(got - want, dim=1) / torch.linalg.vector_norm(want, dim=1)


def compare(weights, inputs: Inputs, outputs: Dict[int, Tuple], device,
            passes: Tuple[int, ...]) -> Dict[str, float]:
    """The check's numbers over `outputs`' batches ((waveforms, what the tap
    kept) by batch; the program's, or a control's in its place):

      eps_rel_err        the widest ||e - e_ref|| / ||e_ref|| of a clip, e the
                         first pass's guided prediction: the video VAE, mouth
                         tokens, tokens, the denoiser and its kernels, and CFG,
                         before the sampler has fed anything back;
      eps_later_rel_err  the same of the later checked passes (one drawn from
                         the seed, and the last), the reference's made at the
                         latent the program's pass read: the denoiser and CFG
                         at the steps the sampler feeds;
      latent_rel_err     ||z - z_ref|| / ||z_ref|| over all the rows, z the
                         sampled latent, z_ref the reference's whole sampling
                         run from the same prompts and noise (every DDIM + CFG
                         step);
      wav_rel_err        the widest of a clip of the program's waveform against
                         the reference codec decoding the program's own latent
                         (the decode stage).

    A pass the program did not show, or an output it did not give, reads
    as infinite."""
    s = ref.sizes(inputs.cfg)
    errs = {"eps": [], "eps_later": [], "wav": []}
    latent = [0.0, 0.0]
    for i, (wav, kept) in outputs.items():
        idx, noise_seed = inputs.batch(i)
        frames = torch.as_tensor(inputs.pool[idx], device=device)
        P = ref.Prompt(weights, inputs.cfg, frames)
        _, z_ref, _ = ref.sample_v2a(weights, P, inputs.z_init(noise_seed).to(device))
        seen, z = kept if kept is not None else ({}, None)
        for k in passes:
            z_k, e_k = seen.get(k, (None, None))
            key = "eps" if k == passes[0] else "eps_later"
            if e_k is None:
                errs[key].append(math.inf)
                continue
            errs[key] += rel_error(e_k, ref.guided(weights, P, z_k, k)).tolist()
        if z is None:
            latent[0] = math.inf
            errs["wav"].append(math.inf)
            continue
        latent[0] += float(torch.sum((z.float() - z_ref) ** 2))
        latent[1] += float(torch.sum(z_ref ** 2))
        want = ref.decode_audio(weights, s, z.float())
        errs["wav"] += rel_error(torch.as_tensor(wav, device=device), want).tolist()
    out = {f"{k}_rel_err": max(v, default=math.inf) for k, v in errs.items()}
    out["latent_rel_err"] = math.sqrt(latent[0] / latent[1]) if latent[1] else math.inf
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t0: float = None) -> Outcome:
    t0 = time.perf_counter() if t0 is None else t0
    tr, cfg = cell.traffic, cell.config
    if tr["direction"] != "v2a":
        raise ValueError(f"the sample driver runs v2a traffic, not {tr['direction']!r}")
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    weights = make_weights(ref.param_shapes(cfg), part_seed(seed, "weights"), device)
    model = build_program(cfg, weights, device)
    passes = checked_passes(cfg, seed)
    tap = Tap(model, passes)
    inputs = Inputs(cfg, tr, seed)
    for k in range(int(tr["warm_calls"])):
        call(model, inputs, -1 - k, device, tap)
    sync()
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    outputs: Dict[int, Tuple] = {}
    start = time.perf_counter()
    i = 0
    while True:
        outputs[i] = call(model, inputs, i, device, tap)
        i += 1
        wall = time.perf_counter() - start
        if wall >= seconds:
            break
    steps = int(cfg["diffusion"]["audio"]["sampler_steps"])
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
                call(model, inputs, i + k, device, tap)
            sync()
            window_s = time.perf_counter() - p0
        ctx["trace"] = DeviceTrace.of(prof, window_s)
        ctx["traced_steps"] = n * steps

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del model, tap
    if cuda:
        torch.cuda.empty_cache()
    rng = np.random.default_rng(part_seed(seed, "check"))
    chosen = sorted(rng.choice(i, size=min(i, int(tr["check_batches"])), replace=False))
    numbers = compare(weights, inputs, {int(j): outputs[int(j)] for j in chosen}, device, passes)
    checks = [(k, numbers[k] if math.isfinite(numbers[k]) else math.inf, float(limit))
              for k, limit in cell.limits.items()]
    return Outcome(values={"clips_per_s": i * inputs.B / wall, "setup_s": setup_s},
                   context=ctx, attempted=i * inputs.B, failed=0, memory_peak_bytes=int(peak),
                   checks=checks)


def reference_outputs(weights, inputs: Inputs, batches: int, device,
                      passes: Tuple[int, ...]) -> Dict[int, Tuple]:
    """The reference computed in float8 (``Fp8Weights``), standing in for the
    program on the first `batches` batches."""
    low = ref.Fp8Weights(weights)
    out = {}
    for i in range(batches):
        idx, noise_seed = inputs.batch(i)
        P = ref.Prompt(low, inputs.cfg, torch.as_tensor(inputs.pool[idx], device=device))
        wav, z, seen = ref.sample_v2a(low, P, inputs.z_init(noise_seed).to(device), passes)
        out[i] = (wav.cpu().numpy(), (seen, z))
    return out


def plant(model, cfg: Dict, fault: str) -> None:
    """A fault of the sampler's later passes, planted in the program: from
    the second pass of each call on, "guidance" makes the guided prediction
    with guidance scale 1 in place of the configuration's; "stale" returns
    the first pass's prediction again, as a replayed graph with stale inputs
    would."""
    steps = int(cfg["diffusion"]["audio"]["sampler_steps"])
    g = float(cfg["sampling"]["guidance_scale"].get("audio", 3.0))
    denoise, state = model.denoise_tokens, {"n": 0, "first": None}

    def faulty(*args, **kwargs):
        k, state["n"] = state["n"] % steps + 1, state["n"] + 1
        out = denoise(*args, **kwargs)
        if k == 1:
            state["first"] = out
            return out
        if fault == "stale":
            return state["first"]
        eps = out["eps_a"]
        cond, null = eps.chunk(2)
        return dict(out, eps_a=torch.cat([null + (cond - null) / g, null]))

    model.denoise_tokens = faulty


def readings(cell: Cell, seed: int, batches: int, control: str = "none",
             device="cuda") -> Dict[str, float]:
    """The check's numbers for the first `batches` batches of a run with
    `seed`, without a window: for the program as the cell runs it
    (``control`` "none"); for a control: "int8", the program with its own
    int8 path switched on (model.core.quant: the core's four projections
    W8A8), "fp8", the reference computed in float8 in the program's place
    (both the precision below the bf16 the configuration states); or for the
    program with a fault of its later passes planted (``plant``: "guidance",
    "stale")."""
    cfg = int8_config(cell.config) if control == "int8" else cell.config
    device = torch.device(device)
    weights = make_weights(ref.param_shapes(cfg), part_seed(seed, "weights"), device)
    inputs = Inputs(cfg, cell.traffic, seed)
    passes = checked_passes(cfg, seed)
    if control == "fp8":
        return compare(weights, inputs, reference_outputs(weights, inputs, batches, device,
                                                          passes), device, passes)
    model = build_program(cfg, weights, device)
    if control in ("guidance", "stale"):
        plant(model, cfg, control)
    elif control not in ("none", "int8"):
        raise ValueError(f"no control {control!r}")
    tap = Tap(model, passes)
    outputs = {i: call(model, inputs, i, device, tap) for i in range(batches)}
    del model, tap
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return compare(weights, inputs, outputs, device, passes)
