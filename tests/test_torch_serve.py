"""The port's serving runner on the CPU: its BatchScheduler against the JAX
package's under the same scripted submissions (a recording executor holds
the first batch until the script has submitted, so the batches are
deterministic), the JAX package's tests/test_serve.py cases on the port's
InferenceRunner (tiny config, device="cpu", max_batch=2, closed by the
fixture), the work items its _prepare cuts against the JAX runner's on the
same files, a served output against sample_one_direction on the same padded
batch, and no thread left running after close."""

import json
import threading
import time

import numpy as np
import pytest

from multimodal_diffusion_torch.media.audio_io import read_wav, write_wav
from multimodal_diffusion_torch.media.video_io import write_frames
from multimodal_diffusion_torch.serve import runner as TR
from multimodal_diffusion_tpu.serve import runner as JR
from tests._tiny import tiny_cfg

WAIT = 30


# ---------------------------------------------------------------------------
# the scheduler, scripted, against the JAX package's
# ---------------------------------------------------------------------------


class Recorder:
    """An executor that records (key, batch size, item tags) and holds its
    first call until `release` is set."""

    def __init__(self):
        self.release = threading.Event()
        self.started = threading.Event()
        self.batches = []

    def __call__(self, items):
        self.batches.append((items[0].key, len(items), [int(it.prompt.flat[0]) for it in items]))
        self.started.set()
        if not self.release.wait(timeout=WAIT):
            raise TimeoutError("the script never released the executor")
        for it in items:
            it.out = it.prompt


def _items(mod, direction, shape, tags):
    return [mod.WorkItem(direction, np.full(shape, t, np.float32)) for t in tags]


def _script(mod, case):
    """Run one scripted case on module `mod`'s BatchScheduler; return what
    can be observed from outside: the batches, each item's outcome and
    error, and submit_items' return values."""
    rec = Recorder()
    kw = {"batches": dict(max_batch=3, max_queue=64),
          "backpressure": dict(max_batch=1, max_queue=2),
          "fairness": dict(max_batch=4, max_queue=64, fairness_age_s=0.05),
          "drain": dict(max_batch=2, max_queue=64)}[case]
    sched = mod.BatchScheduler(rec, **kw)
    returns, items = [], []
    try:
        gate = _items(mod, "v2a", (4,), [0])
        returns.append(sched.submit_items(gate))
        assert rec.started.wait(WAIT)
        items = gate
        if case == "batches":
            for direction, shape, tags in (("v2a", (4,), range(1, 6)), ("v2a", (6,), range(10, 17)),
                                           ("v2a", (8,), (20, 21)), ("a2v", (4,), (30, 31))):
                new = _items(mod, direction, shape, tags)
                returns.append(sched.submit_items(new))
                items += new
        elif case == "backpressure":
            new = _items(mod, "v2a", (4,), range(1, 7))
            returns.append(sched.submit_items(new, timeout=0.2))
            items += new
        elif case == "fairness":
            for shape, tags in (((4,), (1,)), ((6,), range(10, 15))):
                new = _items(mod, "v2a", shape, tags)
                returns.append(sched.submit_items(new))
                items += new
            time.sleep(0.2)  # every head is now older than fairness_age_s
        else:  # drain: shut down with items queued behind the held batch
            new = _items(mod, "v2a", (4,), range(1, 6))
            returns.append(sched.submit_items(new))
            items += new
            stopper = threading.Thread(target=sched.shutdown)
            stopper.start()
            time.sleep(0.1)
        rec.release.set()
        if case == "drain":
            stopper.join(WAIT)
            assert not stopper.is_alive()
            late = _items(mod, "v2a", (4,), [99])
            returns.append(sched.submit_items(late))
            items += late
        for it in items:
            assert it.done.wait(WAIT)
    finally:
        rec.release.set()
        sched.shutdown()
    assert not sched._thread.is_alive()
    return {"batches": rec.batches, "returns": returns,
            "outcomes": [(int(it.prompt.flat[0]), it.error) for it in items],
            "batches_run": sched.batches_run}


@pytest.mark.parametrize("case", ["batches", "backpressure", "fairness", "drain"])
def test_scheduler_matches_jax_under_a_script(case):
    """The same batches (key, size, items), the same failures and messages
    (backpressure, shutdown), the same fairness aging and drain."""
    want = _script(JR, case)
    got = _script(TR, case)
    assert got == want
    if case == "batches":  # the gate, then always the fullest queue
        assert [(k[1], n) for k, n, _ in got["batches"]] == [
            ((4,), 1), ((6,), 3), ((4,), 3), ((6,), 3), ((4,), 2), ((8,), 2), ((4,), 2),
            ((6,), 1)]
    elif case == "backpressure":
        assert got["returns"] == [True, False]
        assert sum("queue full (2 items)" in (e or "") for _, e in got["outcomes"]) == 4
    elif case == "fairness":  # the older single item first, though B is fuller
        assert [tags for _, _, tags in got["batches"]] == [[0], [1], [10, 11, 12, 13], [14]]
    else:
        assert [e for _, e in got["outcomes"]] == (
            [None] + ["scheduler loop exited"] * 5 + ["scheduler is shut down"])


def test_scheduler_records_each_batch():
    rec = Recorder()
    rec.release.set()
    sched = TR.BatchScheduler(rec, max_batch=2)
    try:
        items = _items(TR, "v2a", (4,), range(3))
        sched.submit_items(items)
        for it in items:
            assert it.done.wait(WAIT)
    finally:
        sched.shutdown()
    seqs = [s for r in sched.records for s in r.seqs]
    assert sorted(seqs) == [it.seq for it in items] == [0, 1, 2]
    assert all(r.ok and r.seconds >= 0 and min(r.queue_wait_s) >= 0 for r in sched.records)


# the JAX package's scheduler tests, on the port's scheduler


def test_scheduler_backpressure_queue_cap():
    gate = threading.Event()
    sched = TR.BatchScheduler(lambda items: gate.wait(timeout=WAIT), max_batch=1, max_queue=2)
    try:
        items = [TR.WorkItem("v2a", np.zeros((4,), np.float32)) for _ in range(6)]
        assert not sched.submit_items(items, timeout=0.2)
        failed = [it for it in items if it.error and "queue full" in it.error]
        assert len(failed) >= 2, [it.error for it in items]
        gate.set()
        for it in items:
            assert it.done.wait(timeout=WAIT)
        assert len([it for it in items if it.error is None]) == len(items) - len(failed)
    finally:
        gate.set()
        sched.shutdown()


def test_scheduler_blocking_backpressure_completes_all():
    ran = []

    def run(items):
        time.sleep(0.02)
        for it in items:
            it.out = it.prompt + 1
        ran.append(len(items))

    sched = TR.BatchScheduler(run, max_batch=2, max_queue=2)
    try:
        items = [TR.WorkItem("v2a", np.full((3,), i, np.float32)) for i in range(12)]
        assert sched.submit_items(items, timeout=None)
        for it in items:
            assert it.done.wait(timeout=WAIT) and it.error is None
        assert sum(ran) == 12
    finally:
        sched.shutdown()


def test_scheduler_shape_keyed_batches():
    shapes_seen = []

    def run(items):
        shapes_seen.append({it.prompt.shape for it in items})

    sched = TR.BatchScheduler(run, max_batch=8, max_queue=64)
    try:
        items = ([TR.WorkItem("v2a", np.zeros((4,), np.float32)) for _ in range(5)]
                 + [TR.WorkItem("v2a", np.zeros((6,), np.float32)) for _ in range(5)])
        sched.submit_items(items)
        for it in items:
            assert it.done.wait(timeout=WAIT) and it.error is None
        assert all(len(s) == 1 for s in shapes_seen), shapes_seen
    finally:
        sched.shutdown()


def test_a_failing_batch_fails_its_items_and_the_loop_goes_on():
    calls = []

    def run(items):
        calls.append(len(items))
        if len(calls) == 1:
            raise RuntimeError("device fault")

    sched = TR.BatchScheduler(run, max_batch=1)
    try:
        a, b = _items(TR, "v2a", (4,), (1, 2))
        sched.submit_items([a])
        assert a.done.wait(WAIT)
        sched.submit_items([b])
        assert b.done.wait(WAIT)
    finally:
        sched.shutdown()
    assert a.error == "RuntimeError: device fault" and b.error is None
    assert sched.batches_run == 1 and [r.ok for r in sched.records] == [False, True]


# ---------------------------------------------------------------------------
# the runner (the JAX package's tests/test_serve.py cases)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runner():
    cfg = tiny_cfg()
    cfg["paths"] = {}
    r = TR.InferenceRunner(cfg, max_batch=2, bf16_params=False, device="cpu")
    yield r
    r.close()
    assert not r.scheduler._thread.is_alive() and not r._finalizers


def _write_prompts(tmp_path, n):
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n):
        if i % 2 == 0:
            fdir = tmp_path / f"frames_{i}"
            write_frames(rng.integers(0, 255, (8, 32, 32, 3), dtype=np.uint8), fdir)
            reqs.append({"id": f"r{i}", "direction": "v2a", "input": str(fdir),
                         "output": str(tmp_path / f"out_{i}.wav")})
        else:
            wav = tmp_path / f"in_{i}.wav"
            write_wav(wav, rng.uniform(-0.5, 0.5, 8000).astype(np.float32), 8000)
            reqs.append({"id": f"r{i}", "direction": "a2v", "input": str(wav),
                         "output": str(tmp_path / f"out_{i}_frames")})
    return reqs


def test_manifest_mode_batches_both_directions(runner, tmp_path):
    reqs = _write_prompts(tmp_path, 5)  # 3 v2a + 2 a2v
    man = tmp_path / "requests.json"
    man.write_text(json.dumps({"requests": reqs}))
    before = runner.scheduler.batches_run
    done = runner.process_manifest(man)
    assert all(r.error is None for r in done), [r.error for r in done]
    assert runner.scheduler.batches_run - before >= 3
    wav, sr = read_wav(tmp_path / "out_0.wav")
    assert sr == 8000 and wav.shape == (8000,) and np.isfinite(wav).all()
    assert len(sorted((tmp_path / "out_1_frames").glob("frame_*.jpg"))) == 8


def test_bad_request_reports_error(runner, tmp_path):
    r = runner.submit(TR.Request(id="bad", direction="v2a", input_path=str(tmp_path / "nope"),
                                 output_path=str(tmp_path / "x.wav")))
    assert r.done.wait(timeout=60)
    assert r.error is not None and r.error.startswith("load:")
    r2 = runner.submit(TR.Request(id="baddir", direction="sideways", input_path="x",
                                  output_path="y"))
    assert r2.done.wait(timeout=5) and "unknown direction" in r2.error


def test_streaming_request_through_daemon(runner, tmp_path):
    """A stream_v2a request rides the scheduler: 3 windows (1 s every 0.5 s
    of 2 s of frames) as work items, crossfade-stitched into one wav."""
    runner.win_s, runner.hop_s, runner.xfade_s = 1.0, 0.5, 0.25
    fdir = tmp_path / "stream_frames"
    write_frames(np.random.default_rng(1).integers(0, 255, (16, 32, 32, 3), dtype=np.uint8),
                 fdir)
    out_wav = tmp_path / "stream_out.wav"
    r = runner.submit(TR.Request(id="s0", direction="stream_v2a", input_path=str(fdir),
                                 output_path=str(out_wav)))
    assert r.done.wait(timeout=300)
    assert r.error is None, r.error
    assert len(r.items) == 3 and all(it.key == ("v2a", (8, 32, 32, 3)) for it in r.items)
    wav, sr = read_wav(out_wav)
    assert sr == 8000 and np.isfinite(wav).all()
    assert wav.shape[0] == 2 * 8000


def test_watch_mode(runner, tmp_path):
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    for i, it in enumerate(_write_prompts(tmp_path, 2)):
        (inbox / f"req_{i}.json").write_text(json.dumps(it))
    (inbox / "broken.json").write_text("{not json")
    stop = threading.Event()
    t = threading.Thread(target=runner.watch, args=(inbox,),
                         kwargs={"poll_s": 0.05, "stop_event": stop}, daemon=True)
    t.start()
    t0 = time.time()
    while time.time() - t0 < 120 and len(list(inbox.glob("*.result.json"))) < 3:
        time.sleep(0.1)
    (inbox / "STOP").touch()
    t.join(timeout=WAIT)
    assert not t.is_alive()
    results = {p.name: json.loads(p.read_text()) for p in inbox.glob("*.result.json")}
    assert len(results) == 3, results
    assert results["req_0.result.json"]["ok"] and results["req_1.result.json"]["ok"]
    assert not results["broken.result.json"]["ok"]


@pytest.mark.parametrize("direction", ["v2a", "a2v", "stream_v2a", "stream_a2v"])
def test_prepare_cuts_the_jax_runners_work_items(runner, tmp_path, direction):
    """_prepare of both runners on the same files, the JAX one without its
    model (its attributes set by hand): the same work items, bit for bit."""
    rng = np.random.default_rng(2)
    if direction.endswith("v2a"):
        path = tmp_path / "frames"
        write_frames(rng.integers(0, 255, (13 if direction == "v2a" else 19, 32, 32, 3),
                                  dtype=np.uint8), path)
    else:
        path = tmp_path / "in.wav"
        write_wav(path, rng.uniform(-0.5, 0.5, 6000 if direction == "a2v" else 15000)
                  .astype(np.float32), 8000)
    jr = object.__new__(JR.InferenceRunner)
    for name in ("cfg", "sr", "fps", "size_hw", "win_s", "hop_s", "xfade_s"):
        setattr(jr, name, getattr(runner, name))
    req = dict(id="p", direction=direction, input_path=str(path), output_path="unused")
    want = jr._prepare(JR.Request(**req))
    got = runner._prepare(TR.Request(**req))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.key == w.key
        np.testing.assert_array_equal(g.prompt, w.prompt)


def test_served_output_equals_sample_one_direction_on_the_padded_batch(runner, tmp_path):
    """Three v2a requests: whatever batches they landed in, each served
    output equals sample_one_direction on that batch, padded to max_batch
    by repeating its last prompt, bit for bit."""
    from multimodal_diffusion_torch.infer.sample_clip import sample_one_direction

    reqs = [TR.Request(id=f"q{i}", direction="v2a", input_path=p["input"],
                       output_path=str(tmp_path / f"q{i}.wav"))
            for i, p in enumerate(_write_prompts(tmp_path, 5)[::2])]
    for r in reqs:
        runner.submit(r)
    for r in reqs:
        assert r.done.wait(timeout=120) and r.error is None, r.error
    by_seq = {it.seq: it for r in reqs for it in r.items}
    records = [rec for rec in runner.scheduler.records if set(rec.seqs) <= set(by_seq)]
    assert sorted(s for rec in records for s in rec.seqs) == sorted(by_seq)
    for rec in records:
        items = [by_seq[s] for s in rec.seqs]
        batch = TR.pad_batch([it.prompt for it in items], runner.scheduler.max_batch)
        assert batch.shape[0] == 2
        want = sample_one_direction(cfg=runner.cfg, model=runner.model, prompt_modality="video",
                                    prompt_video=batch, device="cpu")["audio"]
        for i, it in enumerate(items):
            np.testing.assert_array_equal(it.out, want[i])
    wav, _ = read_wav(tmp_path / "q0.wav")
    assert wav.shape == (8000,)


def test_close_stops_every_thread(tmp_path):
    """A runner of its own: after close no scheduler or finalizer thread is
    alive, and a request submitted afterwards fails with the shutdown
    message."""
    cfg = tiny_cfg()
    cfg["paths"] = {}
    r = TR.InferenceRunner(cfg, max_batch=2, bf16_params=False, device="cpu")
    try:
        req = _write_prompts(tmp_path, 1)[0]
        done = r.submit(TR.Request(id="c", direction="v2a", input_path=req["input"],
                                   output_path=req["output"]))
        assert done.done.wait(timeout=120) and done.error is None
    finally:
        r.close()
    assert not r.scheduler._thread.is_alive() and not r._finalizers
    late = r.submit(TR.Request(id="late", direction="v2a", input_path=req["input"],
                               output_path=req["output"]))
    assert late.done.wait(timeout=WAIT) and late.error == "scheduler is shut down"
    r.close()
    assert not [t for t in threading.enumerate() if t.name == "serve-finalize-late"]


def test_main_serves_a_manifest_on_the_cpu(tmp_path, capsys):
    """The CLI: --config (a tiny YAML), --manifest, --max-batch, --device
    cpu; a bad request is reported, the others written."""
    import yaml

    cfg = tiny_cfg()
    cfg["paths"] = {}
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    reqs = _write_prompts(tmp_path, 2) + [{"id": "bad", "direction": "a2v",
                                          "input": str(tmp_path / "none.wav"),
                                          "output": str(tmp_path / "bad")}]
    (tmp_path / "requests.json").write_text(json.dumps(reqs))
    TR.main(["--config", str(tmp_path / "cfg.yaml"), "--manifest",
             str(tmp_path / "requests.json"), "--max-batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] 2/3 ok" in out and "bad: ERROR load:" in out
    assert read_wav(tmp_path / "out_0.wav")[0].shape == (8000,)
    assert len(list((tmp_path / "out_1_frames").glob("frame_*.jpg"))) == 8
