"""The port's train_joint CLI on the CPU (``--device cpu``) at the shrunk mvp
config, on record shards and a manifest written here from a numpy seed:
resident and streamed records and a manifest with validation write their
metrics and checkpoints at the expected steps; the CLI's logged losses are
bit-equal to create_trainer + run_training driven directly by the same
loader; --resume continues from bit-equal restored state; SIGTERM
checkpoints and exits, as tests/test_preemption.py does for the JAX CLI."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from _torch_parity import shrunk_cfg
from multimodal_diffusion_torch.datasets.collate import collate_batch
from multimodal_diffusion_torch.datasets.loader import DataLoader
from multimodal_diffusion_torch.datasets.records import (RecordDataset, device_resident_batches,
                                                         write_record_shards)
from multimodal_diffusion_torch.media.audio_io import write_wav
from multimodal_diffusion_torch.train import checkpoint as TC
from multimodal_diffusion_torch.train import train_joint
from multimodal_diffusion_torch.train import trainer as TT

REPO = Path(__file__).resolve().parents[1]
N_CLIPS = 8


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """8 clips of 8 frames of 32x32 and 1 s of 8 kHz audio (the shrunk
    config's clip), in shards of 3; clip 3 has no audio, clip 6 no video."""
    d = tmp_path_factory.mktemp("records")
    rng = np.random.default_rng(1)

    def items():
        for i in range(N_CLIPS):
            v = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
            a = rng.uniform(-1, 1, (8000,)).astype(np.float32)
            yield {"video": None if i == 6 else v, "audio": None if i == 3 else a}

    write_record_shards(items(), d, video_shape=(8, 32, 32, 3), audio_shape=(8000,),
                        clips_per_shard=3, fps=8, sr=8000)
    return d


def _config(tmp_path, records=None, manifest=None, **training):
    cfg = shrunk_cfg()
    cfg["model"]["core"]["dropout"] = 0.1  # the generator's state matters on resume
    cfg["paths"] = {"out_root": str(tmp_path / "run"), "ckpt_dir": str(tmp_path / "run/ckpt"),
                    "log_dir": str(tmp_path / "run/logs"),
                    "samples_dir": str(tmp_path / "run/samples")}
    cfg["data"].update(num_workers=2, device_preprocess=True)
    cfg["data"].pop("val_split_glob", None)
    if records is not None:
        cfg["data"]["records_dir"] = str(records)
    if manifest is not None:
        cfg["data"]["train_split_glob"] = str(manifest)
    cfg["training"].update(log_every=1, ckpt_every=2, val_every=0, max_steps=4)
    cfg["training"].update(training)
    return cfg


def _write(tmp_path, cfg, name="cfg.yaml"):
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _metrics(tmp_path):
    lines = (tmp_path / "run/logs/metrics.jsonl").read_text().splitlines()
    return [json.loads(x) for x in lines]


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "streamed"])
def test_cli_trains_on_records(records, tmp_path, capsys, resident):
    """4 steps, a log line each, checkpoints at 2 and 4 (the final save
    finds step 4 written by the periodic one and keeps it), ckpt_async
    accepted."""
    cfg = _config(tmp_path, records, ckpt_async=True)
    cfg["data"].update(device_resident=resident, resident_max_clips=6)
    state = train_joint.main(["--config", _write(tmp_path, cfg), "--device", "cpu"])
    out = capsys.readouterr().out
    mode = "device-resident" if resident else "streamed"
    assert f"[data] {N_CLIPS} clips; global batch 2; device cpu; {mode} input" in out
    assert ("capping corpus 8 -> 6 clips" in out) == resident
    assert state.step == 4
    recs = _metrics(tmp_path)
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in recs)
    mgr = TC.CheckpointManager(tmp_path / "run/ckpt")
    assert mgr.all_steps() == [2, 4] and mgr.meta(4) == {"experiment": cfg["experiment"]}


def _losses(log):
    return [(step, m["loss"], m["grad_norm"]) for step, m in log]


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "streamed"])
def test_cli_losses_equal_the_library_path(records, tmp_path, resident):
    """The CLI's logged loss and grad norm of each step are the ones that
    create_trainer + run_training give on the same loader, bit for bit."""
    cfg = _config(tmp_path, records, ckpt_every=100)
    cfg["data"]["device_resident"] = resident
    np.random.seed(11)  # collate's target draw when a batch has both modalities
    train_joint.main(["--config", _write(tmp_path, cfg), "--device", "cpu",
                      "--max-steps", "5"])
    cli = [(r["step"], r["loss"], r["grad_norm"]) for r in _metrics(tmp_path)]

    bundle = TT.create_trainer(cfg, device="cpu")
    ds = RecordDataset(records)
    if resident:
        loader = device_resident_batches(ds, "cpu", 2, seed=cfg["seed"])
    else:
        loader = DataLoader(ds, 2, lambda items: collate_batch(items, ds.T, ds.L),
                            num_workers=2, seed=cfg["seed"])
    log = []
    np.random.seed(11)
    TT.run_training(cfg, bundle, iter(loader), max_steps=5,
                    log_fn=lambda step, m: log.append((step, m)))
    assert len(cli) == 5
    assert cli == _losses(log)


def test_cli_on_a_manifest_validates(tmp_path, capsys):
    """No records_dir: the clips.json manifest, decoded by PIL (the frames
    are PNG), streamed; validation on val_split_glob every 2 steps."""
    rng = np.random.default_rng(2)
    clips = []
    for i in range(4):
        fdir = tmp_path / f"clip_{i}"
        fdir.mkdir()
        for t in range(8):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                fdir / f"frame_{t:06d}.png")
        write_wav(tmp_path / f"clip_{i}.wav", rng.uniform(-0.5, 0.5, 8000).astype(np.float32),
                  8000)
        clips.append({"video_frames_dir": str(fdir),
                      "audio_wav_path": str(tmp_path / f"clip_{i}.wav")})
    manifest = tmp_path / "clips.json"
    manifest.write_text(json.dumps({"clips": clips}))
    cfg = _config(tmp_path, manifest=manifest, val_every=2)
    cfg["data"]["val_split_glob"] = str(manifest)
    state = train_joint.main(["--config", _write(tmp_path, cfg), "--device", "cpu"])
    assert state.step == 4
    assert "[data] 4 clips; global batch 2; device cpu; streamed input" in capsys.readouterr().out
    recs = _metrics(tmp_path)
    val = [r for r in recs if "val_loss" in r]
    assert [r["step"] for r in val] == [2, 4]
    assert all(np.isfinite([r["val_loss_video"], r["val_loss_audio"]]).all() for r in val)
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4]
    assert TC.CheckpointManager(tmp_path / "run/ckpt").all_steps() == [2, 4]


def _assert_trees_equal(a, b):
    assert a["step"] == b["step"]
    assert torch.equal(a["rng"], b["rng"])
    for part in ("params", "ema_core"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    oa, ob = a["opt_state"], b["opt_state"]
    assert (oa["count"], oa["mini_step"]) == (ob["count"], ob["mini_step"])
    for part in ("mu", "nu"):
        for k in oa[part]:
            assert torch.equal(oa[part][k], ob[part][k]), (part, k)


def test_cli_resume_continues_from_bit_equal_state(records, tmp_path, monkeypatch):
    """Run 4 steps; --resume --max-steps 6 restores step 4's params, moments,
    EMA and generator bit for bit, then logs steps 5 and 6 and saves 6."""
    cfg = _config(tmp_path, records, ckpt_every=4)
    cfg["data"]["device_resident"] = True
    cfg["training"]["optimizer"]["mv_dtype"] = "bf16"
    path = _write(tmp_path, cfg)
    first = train_joint.main(["--config", path, "--device", "cpu"])
    at_4 = TC.state_to_tree(first)

    restored = []

    def spy(state, tree):
        TC.restore_state(state, tree)
        restored.append(TC.state_to_tree(state))

    monkeypatch.setattr(train_joint, "restore_state", spy)
    second = train_joint.main(["--config", path, "--device", "cpu", "--resume",
                               "--max-steps", "6"])
    assert len(restored) == 1
    _assert_trees_equal(restored[0], at_4)
    assert second.step == 6
    assert [r["step"] for r in _metrics(tmp_path)] == [1, 2, 3, 4, 5, 6]
    mgr = TC.CheckpointManager(tmp_path / "run/ckpt")
    assert mgr.all_steps() == [4, 6]
    assert any(not torch.equal(v, at_4["ema_core"][k]) for k, v in second.ema.items())


def test_sigterm_checkpoints_and_exits(records, tmp_path):
    """A real `python -m ... train_joint` process: SIGTERM after step 2 has
    logged ends the run after the step in flight with a checkpoint and exit
    code 0; --resume then continues from that checkpoint."""
    cfg = _config(tmp_path, records, max_steps=100_000, ckpt_every=100_000)
    path = _write(tmp_path, cfg)
    metrics = tmp_path / "run/logs/metrics.jsonl"
    cmd = [sys.executable, "-m", "multimodal_diffusion_torch.train.train_joint",
           "--config", path, "--device", "cpu"]
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    log = tmp_path / "train_out.log"
    with open(log, "w") as out_f:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out_f, stderr=subprocess.STDOUT)
        deadline = time.time() + 600  # a hang guard, not a timing assumption
        while not (metrics.exists() and len(metrics.read_text().splitlines()) >= 2):
            if proc.poll() is not None or time.time() > deadline:
                proc.kill()
                raise AssertionError(f"no step 2 (rc {proc.returncode}):\n"
                                     f"{log.read_text()[-3000:]}")
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=600)
    out = log.read_text()
    assert proc.returncode == 0, out[-3000:]
    assert "[preempt] signal" in out and "[preempt] stop requested" in out
    saved = TC.CheckpointManager(tmp_path / "run/ckpt").latest_step()
    assert saved is not None and saved >= 2
    assert TC.CheckpointManager(tmp_path / "run/ckpt").meta(saved)["final"] is True
    state = train_joint.main(["--config", path, "--device", "cpu", "--resume",
                              "--max-steps", str(saved + 1)])
    assert state.step == saved + 1
