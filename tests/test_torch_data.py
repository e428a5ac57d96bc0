"""The port's input pipeline against the JAX package's, on shards and a
manifest written here from a numpy seed. Every comparison is exact
(``assert_array_equal``): shard bytes, dataset items in both layouts, the
device-resident batch sequence over several epochs (shuffled and in order,
capped and not), collate, DataLoader epochs, manifest items; plus
``device_prefetch``'s order and errors, the native decoder, the records
path's imports and ``tools/build_records.py``."""

import json
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

from multimodal_diffusion_torch.datasets import av_manifest as TAV
from multimodal_diffusion_torch.datasets import collate as TC
from multimodal_diffusion_torch.datasets import loader as TLd
from multimodal_diffusion_torch.datasets import native_loader as TN
from multimodal_diffusion_torch.datasets import records as TR
from multimodal_diffusion_tpu.datasets import av_manifest as JAV
from multimodal_diffusion_tpu.datasets import collate as JC
from multimodal_diffusion_tpu.datasets import loader as JLd
from multimodal_diffusion_tpu.datasets import native_loader as JN
from multimodal_diffusion_tpu.datasets import records as JR
from multimodal_diffusion_tpu.media.audio_io import write_wav
from multimodal_diffusion_tpu.parallel.mesh import make_mesh

REPO = Path(__file__).resolve().parents[1]
N_CLIPS, V_SHAPE, A_LEN = 10, (4, 8, 8, 3), 400
NO_VIDEO, NO_AUDIO = (2, 7), (5,)


def _items(seed=0):
    rng = np.random.default_rng(seed)
    for i in range(N_CLIPS):
        v = rng.integers(0, 256, V_SHAPE, dtype=np.uint8)
        a = rng.uniform(-1, 1, (A_LEN,)).astype(np.float32)
        yield {"video": None if i in NO_VIDEO else v, "audio": None if i in NO_AUDIO else a}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """10 clips in shards of 4 + 4 + 2 (written by the JAX package), clips 2
    and 7 without video, clip 5 without audio."""
    d = tmp_path_factory.mktemp("records")
    JR.write_record_shards(_items(), d, video_shape=V_SHAPE, audio_shape=(A_LEN,),
                           clips_per_shard=4, fps=8, sr=8000)
    return d


def _equal_items(a, b):
    assert set(a) == set(b)
    for key in a:
        if a[key] is None or b[key] is None:
            assert a[key] is None and b[key] is None, key
        elif isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


def test_shards_are_byte_identical(tmp_path):
    kw = dict(video_shape=V_SHAPE, audio_shape=(A_LEN,), clips_per_shard=4, fps=8, sr=8000)
    jp = JR.write_record_shards(_items(), tmp_path / "jax", **kw)
    tp = TR.write_record_shards(_items(), tmp_path / "torch", **kw)
    assert [p.name for p in jp] == [p.name for p in tp] == [f"shard_0000{i}.avrec"
                                                          for i in range(3)]
    for a, b in zip(jp, tp):
        assert a.read_bytes() == b.read_bytes()
    assert not list((tmp_path / "torch").glob("*.tmp"))


@pytest.mark.parametrize("device_preprocess", [True, False])
def test_record_dataset_items_match(shards, device_preprocess):
    jd = JR.RecordDataset(shards, device_preprocess=device_preprocess)
    td = TR.RecordDataset(shards, device_preprocess=device_preprocess)
    assert (len(td), td.T, td.L, td.fps, td.sr) == (len(jd), jd.T, jd.L, jd.fps, jd.sr)
    assert len(td) == N_CLIPS and len(td.shards) == 3
    for i in range(N_CLIPS):
        _equal_items(jd[i], td[i])
    assert td[NO_VIDEO[0]]["video"] is None and td[NO_AUDIO[0]]["audio"] is None
    glob = TR.RecordDataset(shards / "shard_0000[01].avrec")  # a glob, too
    assert len(glob) == 8


def _jax_resident(ds, batch, **kw):
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    return JR.device_resident_batches(ds, mesh, batch, **kw)


def _assert_batches_equal(jax_gen, torch_gen, n):
    for k in range(n):
        jb, tb = next(jax_gen), next(torch_gen)
        assert set(jb) == set(tb)
        for key in jb:
            want, got = np.asarray(jb[key]), tb[key].numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, (k, key)
            np.testing.assert_array_equal(got, want, err_msg=f"batch {k} {key}")


@pytest.mark.parametrize("device_preprocess", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_resident_batches_match_jax(shards, shuffle, device_preprocess):
    """Four epochs of 3 batches of 3 (the tenth clip dropped each epoch):
    the same clips in the same order as the JAX generator, each epoch
    shuffling the previous epoch's order."""
    jd = JR.RecordDataset(shards, device_preprocess=device_preprocess)
    td = TR.RecordDataset(shards, device_preprocess=device_preprocess)
    tgen = TR.device_resident_batches(td, "cpu", 3, seed=5, shuffle=shuffle)
    up = TR.device_resident_batches.last_upload
    assert up["clips"] == N_CLIPS
    per_clip = int(np.prod(V_SHAPE)) * (1 if device_preprocess else 4) + A_LEN * 4
    assert up["bytes"] == N_CLIPS * per_clip
    _assert_batches_equal(_jax_resident(jd, 3, seed=5, shuffle=shuffle), tgen, 12)


def test_resident_max_clips_and_errors_match_jax(shards):
    """5 of 10 clips, evenly strided across the shard boundaries ({0, 2, 4,
    7, 9}: numpy rounds 4.5 to even), in order and shuffled; the two
    ValueErrors."""
    ds = JR.RecordDataset(shards)
    td = TR.RecordDataset(shards)
    for shuffle in (False, True):
        _assert_batches_equal(_jax_resident(ds, 2, shuffle=shuffle, seed=1, max_clips=5),
                              TR.device_resident_batches(td, "cpu", 2, shuffle=shuffle,
                                                         seed=1, max_clips=5), 6)
    b = next(TR.device_resident_batches(td, "cpu", 5, shuffle=False, max_clips=5))
    jd = JR.RecordDataset(shards, device_preprocess=True)
    want = np.stack([jd[i]["video"] if jd[i]["video"] is not None else np.zeros(V_SHAPE, np.uint8)
                     for i in (0, 2, 4, 7, 9)])
    np.testing.assert_array_equal(b["video"].numpy(), want)
    np.testing.assert_array_equal(b["has_video"].numpy(), [1, 0, 1, 0, 1])
    with pytest.raises(ValueError, match="exceeds record count 10"):
        next(_jax_resident(ds, 11))
    with pytest.raises(ValueError, match="exceeds record count 10"):
        TR.device_resident_batches(td, "cpu", 11)
    with pytest.raises(ValueError, match="resident_max_clips"):
        next(_jax_resident(ds, 6, max_clips=5))
    with pytest.raises(ValueError, match="resident_max_clips"):
        TR.device_resident_batches(td, "cpu", 6, max_clips=5)


@pytest.mark.parametrize("device_preprocess", [True, False])
@pytest.mark.parametrize("T_target,L_target", [(4, 400), (6, 300), (3, 500)])
def test_collate_matches_jax(shards, device_preprocess, T_target, L_target):
    """Padding and cropping of time and audio, zero-filled missing
    modalities, masks and the target (drawn from numpy's global generator
    when both modalities are there)."""
    ds = JR.RecordDataset(shards, device_preprocess=device_preprocess)
    for idx in ([0, 1, 2], [2, 7], [5], [3, 4, 5, 6]):
        items = [ds[i] for i in idx]
        for pick in (None, "video", {"audio"}):
            np.random.seed(3)
            want = JC.collate_batch(items, T_target, L_target, pick_target=pick)
            np.random.seed(3)
            got = TC.collate_batch(items, T_target, L_target, pick_target=pick)
            assert got["target"] == want["target"] and got["meta"] == want["meta"]
            for key in ("video", "audio", "has_video", "has_audio"):
                _equal_items({key: want[key]}, {key: got[key]})
    items = [{"video": None, "audio": None}]
    assert TC.collate_batch(items, 4, 8)["target"] == JC.collate_batch(items, 4, 8)["target"]


@pytest.mark.parametrize("shard_id,num_shards", [(0, 1), (1, 2)])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_dataloader_epochs_match_jax(shards, shard_id, num_shards, shuffle, drop_last):
    ds = JR.RecordDataset(shards)
    kw = dict(batch_size=2, collate_fn=lambda it: JC.collate_batch(it, ds.T, ds.L),
              shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=7,
              shard_id=shard_id, num_shards=num_shards)
    jl, tl = JLd.DataLoader(ds, **kw), TLd.DataLoader(ds, **kw)
    for epoch in (0, 1):
        assert np.array_equal(jl._epoch_indices(epoch), tl._epoch_indices(epoch))
        np.random.seed(epoch)
        want = list(jl.epoch(epoch))
        np.random.seed(epoch)
        got = list(tl.epoch(epoch))
        assert len(got) == len(want) > 0
        for a, b in zip(want, got):
            assert a["target"] == b["target"]
            for key in ("video", "audio", "has_video", "has_audio"):
                _equal_items({key: a[key]}, {key: b[key]})
    stream = iter(tl)  # the endless stream runs into the next epoch
    n = len(list(tl.epoch(0)))
    assert len([next(stream) for _ in range(n + 1)]) == n + 1


def test_dataloader_raises_a_read_error():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError("unreadable shard")

    loader = TLd.DataLoader(Broken(), batch_size=2, collate_fn=lambda it: it)
    with pytest.raises(OSError, match="unreadable shard"):
        next(iter(loader))


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Two clips: 6 JPEG frames of 16x16 at fps 8 and 1 s of 8 kHz audio each
    (the JAX package's tests/test_data.py corpus), with frames_dir relative
    to a video root for the second clip."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    clips = []
    for i in range(2):
        fdir = root / f"clip_{i}"
        fdir.mkdir()
        for t in range(6):
            Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
                fdir / f"frame_{t:06d}.jpg")
        write_wav(root / f"clip_{i}.wav", rng.uniform(-0.5, 0.5, 8000).astype(np.float32), 8000)
        clips.append({"video_frames_dir": str(fdir) if i == 0 else fdir.name,
                      "audio_wav_path": str(root / f"clip_{i}.wav"),
                      "fps": 8, "sr": 8000, "clip_seconds": 1.0})
    path = root / "clips.json"
    path.write_text(json.dumps({"clips": clips}))
    return path


@pytest.mark.parametrize("device_preprocess", [True, False])
@pytest.mark.parametrize("size_hw,sr", [((16, 16), 8000), ((12, 20), 16000)])
def test_manifest_items_match_jax(manifest, capsys, device_preprocess, size_hw, sr):
    """PIL on both sides: 8 frames from 6 (the last repeated), resized
    when the size differs, audio resampled when the rate does."""
    kw = dict(clip_seconds=1.0, fps=8, sr=sr, size_hw=size_hw, use_native=False,
              video_root=str(manifest.parent), device_preprocess=device_preprocess)
    jd, td = JAV.AVClipsDataset(manifest, **kw), TAV.AVClipsDataset(manifest, **kw)
    assert "frames decoded by PIL" in capsys.readouterr().out
    assert (len(td), td.T, td.L) == (len(jd), jd.T, jd.L) == (2, 8, sr)
    for i in range(2):
        _equal_items(jd[i], td[i])


def test_native_decoder_builds_in_the_port_and_matches_pil(manifest, capsys):
    """The repo's native loader, built by the repo's Makefile rule into the
    port's _build/, decodes frames at their stored size to the same uint8
    values and reads the WAV to the same samples as the JAX package's PIL +
    scipy path."""
    assert TN.available() and TN._SO_PATH.parent.name == "_build"
    assert TN._SO_PATH.parent.parent.name == "multimodal_diffusion_torch"
    kw = dict(clip_seconds=1.0, fps=8, sr=8000, size_hw=(16, 16),
              video_root=str(manifest.parent), device_preprocess=True)
    td = TAV.AVClipsDataset(manifest, **kw)
    assert td._native is TN and "frames decoded by native" in capsys.readouterr().out
    jd = JAV.AVClipsDataset(manifest, use_native=False, **kw)
    for i in range(2):
        _equal_items(jd[i], td[i])


def test_device_prefetch_order_and_errors():
    out = list(TLd.device_prefetch(range(10), lambda x: x * 2, depth=3))
    assert out == [x * 2 for x in range(10)]

    def boom(x):
        if x == 3:
            raise RuntimeError("decode failed")
        return x

    got = []
    with pytest.raises(RuntimeError, match="decode failed"):
        for x in TLd.device_prefetch(range(10), boom, depth=2):
            got.append(x)
    assert got == [0, 1, 2]
    # an abandoned consumer releases the producer
    consumed = []
    gen = TLd.device_prefetch(iter(range(1000)), lambda x: consumed.append(x) or x, depth=2)
    assert next(gen) == 0
    gen.close()
    n = len(consumed)
    assert n <= 4


def test_copy_to_device_leaves_a_cpu_batch_alone():
    batch = {"video": np.zeros((2, 4, 8, 8, 3), np.uint8), "target": {"audio"}}
    assert TLd.copy_to_device(batch, "cpu") is batch


def test_records_path_imports_neither_pil_nor_native_nor_jax(shards):
    """A fresh interpreter that opens the shards, uploads them and takes a
    resident and a streamed batch through the CLI's modules has imported no
    PIL, no native loader and no JAX."""
    code = f"""
import sys
import numpy as np
from multimodal_diffusion_torch.train import train_joint
from multimodal_diffusion_torch.datasets.records import RecordDataset, device_resident_batches
from multimodal_diffusion_torch.datasets.loader import DataLoader
from multimodal_diffusion_torch.datasets.collate import collate_batch
ds = RecordDataset({str(shards)!r})
next(device_resident_batches(ds, "cpu", 2))
next(iter(DataLoader(ds, 2, lambda it: collate_batch(it, ds.T, ds.L))))
bad = [m for m in sys.modules if m.split(".")[0] in ("PIL", "jax", "multimodal_diffusion_tpu")
       or m.endswith("native_loader")]
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout


def test_build_records_tool_matches_the_repo_tool(manifest, tmp_path, monkeypatch):
    """manifest -> shards through the port's tool and through the repo's
    tools/build_records.py (the JAX package's modules), PIL on both: the same
    bytes."""
    import yaml

    from multimodal_diffusion_torch.tools import build_records

    from _torch_parity import shrunk_cfg

    cfg = shrunk_cfg()
    cfg["data"]["train_split_glob"] = str(manifest)
    cfg["paths"] = {"video_root": str(manifest.parent), "audio_root": str(manifest.parent)}
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setattr(TN, "available", lambda: False)
    monkeypatch.setattr(JN, "available", lambda: False)
    paths = build_records.main(["--config", str(cfg_path), "--out", str(tmp_path / "torch"),
                                "--clips-per-shard", "1"])
    repo_tool = runpy.run_path(str(REPO / "tools" / "build_records.py"))
    repo_tool["main"](["--config", str(cfg_path), "--out", str(tmp_path / "jax"),
                       "--clips-per-shard", "1"])
    assert len(paths) == 2
    for p in paths:
        assert p.read_bytes() == (tmp_path / "jax" / p.name).read_bytes()
    ds = TR.RecordDataset(tmp_path / "torch")
    assert (len(ds), ds.T, ds.L, ds[0]["video"].shape) == (2, 8, 8000, (8, 32, 32, 3))
