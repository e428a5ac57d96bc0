"""Pre-decoded clip record shards (`.avrec`) and the device-resident corpus
(counterpart of the JAX package's ``datasets/records.py``).

Clips are decoded once, offline (``tools/build_records.py``), into
fixed-shape binary shards that training reads through ``np.memmap``: no codec
work in the input loop, and every record has the same static shape.

Shard layout (`.avrec`), byte for byte the JAX package's:

    [0:8)      magic b"AVREC\\x01\\0\\0"
    [8:4096)   JSON header, zero-padded: {"n", "video_shape", "video_dtype",
               "audio_shape", "audio_dtype", "fps", "sr"}
    [4096:...) flags:  n bytes   (bit0 = has_video, bit1 = has_audio)
    [...]      records: n x (video_bytes + audio_bytes), fixed sizes

``device_resident_batches`` puts the whole corpus (or an evenly strided cap
of it) on the device once and gathers each batch there by index: no host to
device copy of a batch per step.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

MAGIC = b"AVREC\x01\x00\x00"
HEADER_BYTES = 4096
UPLOAD_CHUNK_BYTES = 64 << 20


class RecordShardWriter:
    """Streaming writer for one `.avrec` shard."""

    def __init__(self, path, video_shape: Sequence[int],
                 audio_shape: Sequence[int], video_dtype="uint8",
                 audio_dtype="float32", fps: int = 16, sr: int = 16000):
        self.path = Path(path)
        self.video_shape = tuple(int(x) for x in video_shape)
        self.audio_shape = tuple(int(x) for x in audio_shape)
        self.video_dtype = np.dtype(video_dtype)
        self.audio_dtype = np.dtype(audio_dtype)
        self.fps, self.sr = int(fps), int(sr)
        self._flags: List[int] = []
        self._payload = self.path.with_suffix(".avrec.tmp")
        self._f = open(self._payload, "wb")

    def add(self, video: Optional[np.ndarray], audio: Optional[np.ndarray]):
        flag = 0
        if video is not None:
            v = np.ascontiguousarray(video, dtype=self.video_dtype)
            assert v.shape == self.video_shape, (v.shape, self.video_shape)
            flag |= 1
        else:
            v = np.zeros(self.video_shape, self.video_dtype)
        if audio is not None:
            a = np.ascontiguousarray(audio, dtype=self.audio_dtype)
            assert a.shape == self.audio_shape, (a.shape, self.audio_shape)
            flag |= 2
        else:
            a = np.zeros(self.audio_shape, self.audio_dtype)
        self._f.write(v.tobytes())
        self._f.write(a.tobytes())
        self._flags.append(flag)

    def close(self):
        self._f.close()
        n = len(self._flags)
        header = {
            "n": n,
            "video_shape": list(self.video_shape),
            "video_dtype": self.video_dtype.name,
            "audio_shape": list(self.audio_shape),
            "audio_dtype": self.audio_dtype.name,
            "fps": self.fps,
            "sr": self.sr,
        }
        hb = json.dumps(header).encode()
        assert len(hb) < HEADER_BYTES - len(MAGIC), "header too large"
        with open(self.path, "wb") as out:
            out.write(MAGIC)
            out.write(hb)
            out.write(b"\x00" * (HEADER_BYTES - len(MAGIC) - len(hb)))
            out.write(bytes(self._flags))
            with open(self._payload, "rb") as src:
                while True:
                    chunk = src.read(1 << 22)
                    if not chunk:
                        break
                    out.write(chunk)
        self._payload.unlink()
        return n


def write_record_shards(
    items: Iterable[Dict[str, np.ndarray]],
    out_dir,
    video_shape: Sequence[int],
    audio_shape: Sequence[int],
    clips_per_shard: int = 256,
    **meta,
) -> List[Path]:
    """items yield {"video": arr|None, "audio": arr|None}; returns shard
    paths `shard_00000.avrec`, ..."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths: List[Path] = []
    writer = None
    count = 0
    for it in items:
        if writer is None:
            p = out_dir / f"shard_{len(paths):05d}.avrec"
            writer = RecordShardWriter(p, video_shape, audio_shape, **meta)
            paths.append(p)
        writer.add(it.get("video"), it.get("audio"))
        count += 1
        if count >= clips_per_shard:
            writer.close()
            writer, count = None, 0
    if writer is not None:
        writer.close()
    return paths


class _Shard:
    def __init__(self, path: Path):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(HEADER_BYTES)
        if head[: len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: not an AVREC shard")
        self.meta = json.loads(head[len(MAGIC):].split(b"\x00", 1)[0].decode())
        self.n = int(self.meta["n"])
        self.video_shape = tuple(self.meta["video_shape"])
        self.audio_shape = tuple(self.meta["audio_shape"])
        self.video_dtype = np.dtype(self.meta["video_dtype"])
        self.audio_dtype = np.dtype(self.meta["audio_dtype"])
        self.v_bytes = int(np.prod(self.video_shape)) * self.video_dtype.itemsize
        self.a_bytes = int(np.prod(self.audio_shape)) * self.audio_dtype.itemsize
        self.rec_bytes = self.v_bytes + self.a_bytes
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        self.flags = np.asarray(self._mm[HEADER_BYTES: HEADER_BYTES + self.n])
        self.data_off = HEADER_BYTES + self.n

    def record(self, i: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """Read-only views into the memmap: (video, audio, flags byte)."""
        off = self.data_off + i * self.rec_bytes
        vbuf = self._mm[off: off + self.v_bytes]
        abuf = self._mm[off + self.v_bytes: off + self.rec_bytes]
        video = np.frombuffer(vbuf, self.video_dtype).reshape(self.video_shape)
        audio = np.frombuffer(abuf, self.audio_dtype).reshape(self.audio_shape)
        return video, audio, int(self.flags[i])


class RecordDataset:
    """mmap-backed dataset over a directory (or glob) of `.avrec` shards.

    Yields the same item dict as AVManifestDataset so collate_batch works
    unchanged; `device_preprocess` keeps frames uint8 [T, H, W, 3] (read-only
    views of the memmap) for the on-device normalisation, else converts to
    float32 [3, T, H, W]."""

    def __init__(self, records, device_preprocess: bool = True):
        records = Path(records)
        if records.is_dir():
            shard_paths = sorted(records.glob("*.avrec"))
        else:
            import glob as _glob

            shard_paths = [Path(p) for p in sorted(_glob.glob(str(records)))]
        if not shard_paths:
            raise FileNotFoundError(f"no .avrec shards under {records}")
        self.shards = [_Shard(p) for p in shard_paths]
        m0 = self.shards[0].meta
        for s in self.shards[1:]:
            if (s.video_shape != self.shards[0].video_shape
                    or s.audio_shape != self.shards[0].audio_shape):
                raise ValueError("inconsistent record shapes across shards")
        self.device_preprocess = bool(device_preprocess)
        self.fps = int(m0.get("fps", 16))
        self.sr = int(m0.get("sr", 16000))
        self._offsets = np.cumsum([0] + [s.n for s in self.shards])
        # [T, H, W, 3] stored layout
        self.T = self.shards[0].video_shape[0]
        self.L = int(np.prod(self.shards[0].audio_shape))

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int) -> Dict:
        si = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        video, audio, flag = self.shards[si].record(idx - self._offsets[si])
        if self.device_preprocess:
            v = video  # uint8 [T, H, W, 3], zero-copy view
        else:
            v = _video_f32(video)
        return {
            "video": v if (flag & 1) else None,
            "audio": audio.reshape(1, -1) if (flag & 2) else None,
            "fps": self.fps,
            "sr": self.sr,
        }


def _video_f32(video: np.ndarray) -> np.ndarray:
    """uint8 [T, H, W, 3] -> float32 [3, T, H, W] in [0, 1] (host side)."""
    return np.transpose(video.astype(np.float32) / 255.0, (3, 0, 1, 2))


def _process_count() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _upload(items: Iterator[np.ndarray], n: int, item_shape: Tuple[int, ...],
            dtype: np.dtype, device: torch.device, label: str) -> torch.Tensor:
    """Stack n host arrays into one preallocated tensor on `device`.

    On CUDA the rows go through two pinned staging buffers of at most
    UPLOAD_CHUNK_BYTES each, copied without blocking the host; a buffer is
    refilled only after the event recorded behind its last copy has passed,
    so the host fills one chunk while the other crosses PCIe and the device
    never holds more than the corpus itself."""
    tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
    out = torch.empty((n,) + tuple(item_shape), dtype=tdtype, device=device)
    if device.type != "cuda":
        rows = out.numpy()
        for j in range(n):
            rows[j] = next(items)
        return out
    per_item = int(np.prod(item_shape)) * np.dtype(dtype).itemsize
    step = max(1, min(n, UPLOAD_CHUNK_BYTES // max(1, per_item)))
    stages = [torch.empty((step,) + tuple(item_shape), dtype=tdtype, pin_memory=True)
              for _ in range(min(2, -(-n // step)))]
    copied: List[Optional[torch.cuda.Event]] = [None] * len(stages)
    total_mb = n * per_item / 1e6
    t0, sent, last_log = time.perf_counter(), 0.0, 0.0
    for c, lo in enumerate(range(0, n, step)):
        m = min(step, n - lo)
        k = c % len(stages)
        if copied[k] is not None:
            copied[k].synchronize()
        rows = stages[k].numpy()
        for j in range(m):
            rows[j] = next(items)
        out[lo: lo + m].copy_(stages[k][:m], non_blocking=True)
        copied[k] = torch.cuda.Event()
        copied[k].record()
        sent += m * per_item / 1e6
        if sent - last_log >= 1000.0 or lo + m >= n:
            if lo + m >= n:
                copied[k].synchronize()
            dt = time.perf_counter() - t0
            print(f"[resident] {label}: {sent:.0f}/{total_mb:.0f} MB "
                  f"({sent / max(dt, 1e-9):.0f} MB/s)", flush=True)
            last_log = sent
    return out


def device_resident_batches(dataset: RecordDataset, device, batch_size: int,
                            seed: int = 0, shuffle: bool = True,
                            max_clips: Optional[int] = None):
    """Put every record on `device` once, then gather each batch there by
    index.

    `max_clips` caps how many records go resident (evenly strided over the
    record order, across shard boundaries, which keeps a speaker-grouped
    corpus balanced): the corpus and the optimizer state must fit the card
    together. Raises ValueError when the batch exceeds the record count or
    the capped count. Video stays uint8 on the device (float32 [3, T, H, W]
    when the dataset was opened without `device_preprocess`).

    The order is a numpy ``default_rng(seed)`` permutation, shuffled again
    in place at each epoch's end (so epoch k shuffles epoch k-1's order);
    without `shuffle` the records go in order. Either way a partial batch at
    an epoch's end is dropped. The order goes to the device once an epoch;
    each batch is an ``index_select`` of the resident tensors with a slice
    of it, so a step copies nothing from the host.

    One process only: the corpus is this process's and the index stream is
    global, so a multi-process job must use the DataLoader path.

    Yields {"video": [B, T, H, W, 3] uint8 | [B, 3, T, H, W] float32,
    "audio": [B, 1, L], "has_video"/"has_audio": [B] float32}, all on
    `device`. ``device_resident_batches.last_upload`` holds the last
    upload's clips, bytes and seconds."""
    device = torch.device(device)
    if _process_count() > 1:
        raise NotImplementedError(
            "device_resident_batches is single-process (one corpus, a global "
            "index stream); use the DataLoader path for multi-process training")
    n = len(dataset)
    if batch_size > n:
        raise ValueError(
            f"batch_size {batch_size} exceeds record count {n}; shrink the "
            f"batch or add records")
    records = [(s, i) for s in dataset.shards for i in range(s.n)]
    if max_clips is not None and 0 < max_clips < n:
        sel = np.unique(np.linspace(0, n - 1, int(max_clips)).round().astype(np.int64))
        print(f"[resident] capping corpus {n} -> {sel.size} clips "
              f"(evenly strided)", flush=True)
        records = [records[i] for i in sel]
    n = len(records)
    if batch_size > n:
        raise ValueError(
            f"batch_size {batch_size} exceeds capped record count {n}; "
            f"raise data.resident_max_clips")
    s0 = dataset.shards[0]
    flags = np.array([s.flags[i] for s, i in records], np.uint8)
    if dataset.device_preprocess:
        v_shape, v_dtype = s0.video_shape, s0.video_dtype
        videos = (s.record(i)[0] for s, i in records)
    else:
        T, H, W, C = s0.video_shape
        v_shape, v_dtype = (C, T, H, W), np.dtype(np.float32)
        videos = (_video_f32(s.record(i)[0]) for s, i in records)
    t0 = time.perf_counter()
    video = _upload(videos, n, v_shape, v_dtype, device, "video")
    audio = _upload((s.record(i)[1].reshape(1, -1) for s, i in records), n,
                    (1, int(np.prod(s0.audio_shape))), s0.audio_dtype, device, "audio")
    has_v = torch.from_numpy((flags & 1).astype(np.float32)).to(device)
    has_a = torch.from_numpy(((flags >> 1) & 1).astype(np.float32)).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    device_resident_batches.last_upload = {
        "clips": n, "bytes": video.nbytes + audio.nbytes,
        "seconds": time.perf_counter() - t0}
    return _gather_batches(video, audio, has_v, has_a, batch_size, seed, shuffle)


device_resident_batches.last_upload = None


def _gather_batches(video, audio, has_v, has_a, batch_size, seed, shuffle):
    n, device = video.shape[0], video.device
    rng = np.random.default_rng(seed)
    order = np.arange(n)
    order_dev = torch.arange(n, device=device)
    pos = n  # the first batch shuffles (or starts the sequence)
    while True:
        if pos + batch_size > n:
            if shuffle:
                rng.shuffle(order)
                order_dev = torch.from_numpy(order.copy()).to(device)
            pos = 0
        idx = order_dev[pos: pos + batch_size]
        pos += batch_size
        yield {"video": video.index_select(0, idx), "audio": audio.index_select(0, idx),
               "has_video": has_v.index_select(0, idx),
               "has_audio": has_a.index_select(0, idx)}
