"""Serving runner: a batched inference daemon with bounded admission
(counterpart of the JAX package's ``serve/runner.py``).

A resident process loads the model once and drives request streams through
the sampler's batch axis (continuous batching):

  * work is admitted as ``WorkItem``s, one loaded prompt each (a whole clip,
    or one window of a streaming request), queued per (direction, prompt
    shape) so every device batch stacks;
  * admission is bounded (``max_queue`` items in all): ``submit_items``
    blocks for room up to a timeout, then fails the rest with "queue full";
  * one scheduler thread, woken by a condition variable, takes the fullest
    queue, or the oldest head once it has waited ``fairness_age_s``, and
    runs the batch; prompt loading happens on the submitting side and output
    writing on a finalizer thread per request, so the scheduler thread only
    stacks prompts and calls the sampler;
  * streaming requests ride the same scheduler: their windows are ordinary
    work items, and the finalizer crossfade-stitches them
    (``infer/stream_infer.py``).

Two frontends over the scheduler: a manifest (``--manifest requests.json``:
a list of {"id", "direction": "v2a" | "a2v" | "stream_v2a" | "stream_a2v",
"input", "output"}, processed, then exit) and an inbox (``--watch DIR``:
request JSON files polled until a ``STOP`` file appears, a
``<name>.result.json`` written as each request completes).

    python -m multimodal_diffusion_torch.serve.runner \\
        --config configs/mvp.yaml configs/specificity8.yaml --manifest requests.json \\
        [--max-batch 8] [--max-queue 64] [--ema] [--device cpu]

The scheduler thread launches the CUDA work, so it enters the runner's
device itself (the current device is per thread); ``sample_one_direction``
runs under inference mode there. Runs on CUDA unless ``--device cpu``, with
the weights cast to bf16 once for a bf16 compute config (``bf16_params``).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

# how many of the latest batches a scheduler keeps as BatchRecords
MAX_RECORDS = 4096
# how long close() waits for the finalizer threads, in all
CLOSE_TIMEOUT_S = 30.0


@dataclass
class WorkItem:
    """One device-batchable unit: a loaded prompt headed for the sampler's
    batch axis (a whole clip, or one streaming window)."""

    direction: str  # "v2a" | "a2v"
    prompt: np.ndarray
    out: Optional[np.ndarray] = None
    error: Optional[str] = None
    done: threading.Event = field(default_factory=threading.Event)
    enq_t: float = 0.0  # monotonic admission time (set by submit_items)
    seq: int = -1  # admission order (set by submit_items)

    @property
    def key(self) -> Tuple:
        return (self.direction, self.prompt.shape)

    def fail(self, msg: str):
        self.error = self.error or msg
        self.done.set()


@dataclass
class Request:
    """A request: its prompt read from ``input_path`` (a frames directory or a
    wav), or handed in as ``prompt`` (uint8 frames [T, H, W, 3] or a float32
    waveform [L], already at the config's size and rate); its output written
    to ``output_path``, or, without one, kept in ``items``' ``out``."""

    id: str
    direction: str  # "v2a" | "a2v" | "stream_v2a" | "stream_a2v"
    input_path: Optional[str] = None
    output_path: Optional[str] = None
    prompt: Optional[np.ndarray] = None
    error: Optional[str] = None
    done: threading.Event = field(default_factory=threading.Event)
    items: List[WorkItem] = field(default_factory=list)  # set by submit


@dataclass
class BatchRecord:
    """What one device batch was: its key, its items' admission numbers,
    when it started (monotonic), how long the executor took, each item's
    wait in the queue, and whether it succeeded."""

    key: Tuple
    seqs: List[int]
    started: float
    seconds: float
    queue_wait_s: List[float]
    ok: bool


class BatchScheduler:
    """Continuous batching with bounded admission over shape-keyed queues.

    ``run_batch(items)`` is the injected executor (the runner binds it to the
    batched sampler); every call receives items sharing one (direction,
    shape) key. The fullest queue is served first, unless some queue's head
    has waited longer than ``fairness_age_s``: then the oldest head wins, so
    a sustained stream on one key cannot starve a minority shape. The last
    MAX_RECORDS batches are kept as ``BatchRecord``s in ``records``."""

    def __init__(self, run_batch: Callable[[List[WorkItem]], None],
                 max_batch: int = 8, max_queue: int = 64,
                 fairness_age_s: float = 10.0):
        self._run = run_batch
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.fairness_age_s = float(fairness_age_s)
        self._cv = threading.Condition()
        self._queues: Dict[Tuple, Deque[WorkItem]] = {}
        self._n_queued = 0
        self._seq = itertools.count()
        self._stop = threading.Event()
        self.batches_run = 0
        self.records: Deque[BatchRecord] = deque(maxlen=MAX_RECORDS)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-scheduler")
        self._thread.start()

    # ---------------- admission ----------------

    def submit_items(self, items: List[WorkItem],
                     timeout: Optional[float] = None) -> bool:
        """Admit items one at a time, blocking while the total queue is at
        ``max_queue``. On timeout (or shutdown) the items not yet admitted
        fail with a backpressure error and False is returned."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for idx, it in enumerate(items):
            with self._cv:
                while self._n_queued >= self.max_queue and not self._stop.is_set():
                    rem = None if deadline is None else deadline - time.monotonic()
                    if rem is not None and rem <= 0:
                        break
                    self._cv.wait(rem)
                if self._stop.is_set():
                    for rest in items[idx:]:
                        rest.fail("scheduler is shut down")
                    return False
                if self._n_queued >= self.max_queue:
                    for rest in items[idx:]:
                        rest.fail(f"queue full ({self.max_queue} items) — backpressure timeout")
                    return False
                it.enq_t = time.monotonic()
                it.seq = next(self._seq)
                self._queues.setdefault(it.key, deque()).append(it)
                self._n_queued += 1
                self._cv.notify_all()
        return True

    # ---------------- device loop ----------------

    def _next_batch(self) -> Optional[List[WorkItem]]:
        with self._cv:
            while self._n_queued == 0 and not self._stop.is_set():
                self._cv.wait()
            if self._stop.is_set():
                return None
            oldest = min(self._queues, key=lambda k: self._queues[k][0].enq_t)
            if time.monotonic() - self._queues[oldest][0].enq_t > self.fairness_age_s:
                key = oldest  # anti-starvation: serve the longest waiter
            else:
                key = max(self._queues, key=lambda k: len(self._queues[k]))
            dq = self._queues[key]
            batch = [dq.popleft() for _ in range(min(self.max_batch, len(dq)))]
            if not dq:
                del self._queues[key]
            self._n_queued -= len(batch)
            self._cv.notify_all()  # wake blocked submitters: room freed
            return batch

    def _loop(self):
        try:
            while True:
                batch = self._next_batch()
                if batch is None:
                    return
                t0 = time.monotonic()
                ok = False
                try:
                    self._run(batch)
                    ok = True
                    self.batches_run += 1
                except BaseException as e:  # a batch's failure fails its items
                    for it in batch:
                        it.fail(f"{type(e).__name__}: {e}")
                    if isinstance(e, (KeyboardInterrupt, SystemExit)):
                        # end the loop (the finally drains the rest) rather
                        # than swallow an interpreter-shutdown signal
                        raise
                else:
                    for it in batch:
                        it.done.set()
                finally:
                    self.records.append(BatchRecord(
                        batch[0].key, [it.seq for it in batch], t0, time.monotonic() - t0,
                        [t0 - it.enq_t for it in batch], ok))
        finally:
            # the loop exits for any reason: fail whatever is still queued so
            # waiters wake instead of hanging
            with self._cv:
                self._stop.set()
                leftovers = [it for dq in self._queues.values() for it in dq]
                self._queues.clear()
                self._n_queued = 0
                self._cv.notify_all()
            for it in leftovers:
                it.fail("scheduler loop exited")

    def shutdown(self):
        with self._cv:
            self._stop.set()
            self._cv.notify_all()
        self._thread.join(timeout=10)


def pad_batch(prompts: List[np.ndarray], size: int) -> np.ndarray:
    """Stack `prompts` and pad to `size` by repeating the last one: every
    device batch of a key has one shape."""
    batch = np.stack(prompts)
    pad = size - batch.shape[0]
    if pad > 0:
        batch = np.concatenate([batch, np.repeat(batch[-1:], pad, 0)])
    return batch


class InferenceRunner:
    """Model + sampler + IO; binds BatchScheduler to the device."""

    DIRECTIONS = ("v2a", "a2v", "stream_v2a", "stream_a2v")

    def __init__(self, cfg: Dict, use_ema: bool = False, bf16_params: bool = True,
                 max_batch: int = 8, max_queue: int = 64,
                 submit_timeout: Optional[float] = None, device="cuda"):
        from ..infer.sample_clip import build_components
        from ..utils.io import resolve_device

        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_components(cfg, device=self.device, use_ema=use_ema,
                                      bf16_params=bf16_params)
        self.sr = int(cfg["audio"]["sr"])
        self.fps = int(cfg["video"]["fps"])
        self.size_hw = tuple(int(x) for x in cfg["video"]["size"])
        stream = cfg.get("streaming", {}) or {}
        self.win_s = float(stream.get("window_seconds", 3.0))
        self.hop_s = float(stream.get("hop_seconds", 1.0))
        self.xfade_s = float(stream.get("crossfade_seconds", 0.25))
        self.submit_timeout = submit_timeout
        self._finalizers: List[threading.Thread] = []
        self.scheduler = BatchScheduler(self._run_batch, max_batch=max_batch,
                                        max_queue=max_queue)

    # ---------------- per-batch device call ----------------

    def _run_batch(self, items: List[WorkItem]):
        """On the scheduler thread: stack and pad the prompts, enter the
        runner's device, and sample the other modality."""
        import torch

        from ..infer.sample_clip import sample_one_direction

        batch = pad_batch([it.prompt for it in items], self.scheduler.max_batch)
        on_card = (torch.cuda.device(self.device) if self.device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card, torch.inference_mode():
            if items[0].direction == "v2a":
                out = sample_one_direction(cfg=self.cfg, model=self.model,
                                           prompt_modality="video", prompt_video=batch,
                                           device=self.device)["audio"]
            else:
                out = sample_one_direction(cfg=self.cfg, model=self.model,
                                           prompt_modality="audio", prompt_audio=batch,
                                           device=self.device)["video"]
        for i, it in enumerate(items):
            it.out = np.asarray(out[i])

    # ---------------- request preparation / finalization ----------------

    def _load_video_prompt(self, req: Request, n_frames: int) -> np.ndarray:
        from ..media.video_io import load_frames_dir

        fr = (np.asarray(req.prompt, np.uint8) if req.prompt is not None
              else load_frames_dir(Path(req.input_path), size_hw=self.size_hw))
        if fr.shape[0] < n_frames:
            fr = np.concatenate([fr, np.repeat(fr[-1:], n_frames - fr.shape[0], 0)])
        return fr

    def _load_audio_prompt(self, req: Request, n_samples: int) -> np.ndarray:
        from ..media.audio_io import read_wav

        y = (np.asarray(req.prompt, np.float32) if req.prompt is not None
             else read_wav(Path(req.input_path), sr=self.sr)[0])
        if y.shape[0] < n_samples:
            y = np.concatenate([y, np.zeros(n_samples - len(y), np.float32)])
        return y

    def _prepare(self, req: Request) -> List[WorkItem]:
        """Load the request's prompt (or take the one handed in) and cut it
        into work items (one for a clip request, one per window for a
        stream)."""
        from ..infer.stream_infer import split_audio_into_windows, split_frames_into_windows

        clip_s = float(self.cfg["data"]["clip_seconds"])
        if req.direction == "v2a":
            T = int(round(self.fps * clip_s))
            return [WorkItem("v2a", self._load_video_prompt(req, T)[:T])]
        if req.direction == "a2v":
            L = int(round(self.sr * clip_s))
            return [WorkItem("a2v", self._load_audio_prompt(req, L)[:L])]
        if req.direction == "stream_v2a":
            frames = self._load_video_prompt(req, int(round(self.fps * self.win_s)))
            chunks, _, _ = split_frames_into_windows(frames, self.fps, self.win_s, self.hop_s)
            return [WorkItem("v2a", c) for c in chunks]
        wav = self._load_audio_prompt(req, int(round(self.sr * self.win_s)))
        chunks, _, _ = split_audio_into_windows(wav, self.sr, self.win_s, self.hop_s)
        return [WorkItem("a2v", c) for c in chunks]

    def _finalize(self, req: Request, items: List[WorkItem]):
        """Wait for the request's items, stitch a stream, write the output
        (none without an ``output_path``). Runs on a thread of its own per
        request, so IO never occupies the scheduler thread."""
        from ..infer.stream_infer import crossfade_audio, crossfade_video
        from ..media.audio_io import write_wav
        from ..media.video_io import write_frames

        for it in items:
            it.done.wait()
        errs = [it.error for it in items if it.error]
        if errs:
            req.error = errs[0]
            req.done.set()
            return
        if req.output_path is None:  # the outputs stay in the items
            req.done.set()
            return
        try:
            if req.direction == "v2a":
                write_wav(Path(req.output_path), items[0].out, self.sr)
            elif req.direction == "a2v":
                write_frames(items[0].out, Path(req.output_path), fps=self.fps)
            elif req.direction == "stream_v2a":
                wav = crossfade_audio(np.stack([it.out for it in items]), sr=self.sr,
                                      hop=int(round(self.sr * self.hop_s)),
                                      win=int(round(self.sr * self.win_s)),
                                      fade_s=self.xfade_s)
                write_wav(Path(req.output_path), wav, self.sr)
            else:
                frames = crossfade_video(np.stack([it.out for it in items]),
                                         hop=int(round(self.fps * self.hop_s)),
                                         win=int(round(self.fps * self.win_s)),
                                         fade_f=int(round(self.xfade_s * self.fps)))
                write_frames(frames, Path(req.output_path), fps=self.fps)
        except Exception as e:  # the request's answer, not the daemon's end
            req.error = f"write: {e}"
        req.done.set()

    _DEFAULT_TIMEOUT = object()

    def submit(self, req: Request, timeout=_DEFAULT_TIMEOUT) -> Request:
        """Admit one request: load its prompt, queue its work items (with
        backpressure), and hand completion to a finalizer thread. Returns
        the request; wait on ``req.done``."""
        if req.direction not in self.DIRECTIONS:
            req.error = f"unknown direction {req.direction!r}"
            req.done.set()
            return req
        try:
            req.items = self._prepare(req)
        except Exception as e:  # a bad prompt fails its request only
            req.error = f"load: {e}"
            req.done.set()
            return req
        if timeout is self._DEFAULT_TIMEOUT:
            timeout = self.submit_timeout
        self._finalizers = [t for t in self._finalizers if t.is_alive()]
        fin = threading.Thread(target=self._finalize, args=(req, req.items), daemon=True,
                               name=f"serve-finalize-{req.id}")
        self._finalizers.append(fin)
        fin.start()
        self.scheduler.submit_items(req.items, timeout=timeout)
        return req

    # ---------------- frontends ----------------

    def process_manifest(self, manifest_path) -> List[Request]:
        items = json.loads(Path(manifest_path).read_text())
        if isinstance(items, dict):
            items = items.get("requests", [])
        reqs = [Request(id=str(it.get("id", i)), direction=it["direction"],
                        input_path=it["input"], output_path=it["output"])
                for i, it in enumerate(items)]
        for r in reqs:
            self.submit(r)
        for r in reqs:
            r.done.wait()
        return reqs

    def watch(self, inbox, poll_s: float = 0.5, stop_event: Optional[threading.Event] = None,
              drain_timeout: float = 600.0, submit_timeout: float = 120.0):
        """Poll `inbox` for ``*.json`` request files until `stop_event` is
        set or a file named ``STOP`` appears, writing ``<name>.result.json``
        as each request completes. ``seen`` is pruned to files still on disk
        (a deleted and re-created request file runs again). A request whose
        admission blocks longer than `submit_timeout` fails with the
        backpressure error and gets its result file, so the loop returns to
        checking for STOP. On the way out, in-flight requests get
        `drain_timeout` seconds in all to finish."""
        inbox = Path(inbox)
        seen: set = set()
        inflight: Dict[Path, Request] = {}

        def flush():
            for p, r in list(inflight.items()):
                if r.done.is_set():
                    p.with_suffix(".result.json").write_text(json.dumps({
                        "ok": r.error is None, "error": r.error, "output": r.output_path}))
                    del inflight[p]

        while stop_event is None or not stop_event.is_set():
            if (inbox / "STOP").exists():
                break
            existing = {p for p in inbox.glob("*.json") if not p.name.endswith(".result.json")}
            seen &= existing | set(inflight)
            for p in sorted(existing):
                if p in seen:
                    continue
                seen.add(p)
                try:
                    it = json.loads(p.read_text())
                    inflight[p] = self.submit(Request(
                        id=str(it.get("id", p.stem)), direction=it["direction"],
                        input_path=it["input"], output_path=it["output"]),
                        timeout=submit_timeout)
                except Exception as e:  # a malformed request file gets its answer
                    p.with_suffix(".result.json").write_text(
                        json.dumps({"ok": False, "error": str(e)}))
            flush()
            time.sleep(poll_s)
        deadline = time.monotonic() + drain_timeout
        for r in list(inflight.values()):
            r.done.wait(timeout=max(0.0, deadline - time.monotonic()))
        flush()

    def close(self):
        """Stop the scheduler (queued items fail, so their finalizers wake)
        and join every finalizer thread."""
        self.scheduler.shutdown()
        deadline = time.monotonic() + CLOSE_TIMEOUT_S
        for t in self._finalizers:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._finalizers = [t for t in self._finalizers if t.is_alive()]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Batched inference runner")
    ap.add_argument("--config", type=str, nargs="+", required=True)
    ap.add_argument("--manifest", type=Path, default=None)
    ap.add_argument("--watch", type=Path, default=None)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=64,
                    help="Admission bound (total queued work items)")
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; cuda raises when absent")
    args = ap.parse_args(argv)
    if not args.manifest and not args.watch:
        ap.error("supply --manifest or --watch")

    from ..utils.io import load_config

    cfg = load_config(*args.config)
    runner = InferenceRunner(cfg, use_ema=args.ema, max_batch=args.max_batch,
                             max_queue=args.max_queue, device=args.device)
    try:
        if args.manifest:
            reqs = runner.process_manifest(args.manifest)
            n_ok = sum(1 for r in reqs if r.error is None)
            print(f"[serve] {n_ok}/{len(reqs)} ok in {runner.scheduler.batches_run} "
                  f"device batches")
            for r in reqs:
                if r.error:
                    print(f"[serve] {r.id}: ERROR {r.error}")
        else:
            print(f"[serve] watching {args.watch} (create STOP file to exit)")
            runner.watch(args.watch)
    finally:
        runner.close()


if __name__ == "__main__":
    main()
