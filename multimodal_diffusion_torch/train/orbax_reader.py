"""Read the JAX package's orbax checkpoints without orbax or tensorstore.

Counterpart of ``multimodal_diffusion_tpu/train/checkpoint.py::
CheckpointManager.restore``: the same nested tree, with torch tensors (CPU)
for leaves. The JAX package's ``CheckpointManager`` (orbax, OCDBT on, zarr
v2) writes one directory per step::

    <dir>/<step>/default/_METADATA                 JSON: the tree's paths and leaf kinds
                         manifest.ocdbt, d/<hex>   the OCDBT key-value store
                         ocdbt.process_0/...       the store of the one writing process
    <dir>/meta_<step>.json                         the trainer's sidecar

**OCDBT.** Every manifest and b-tree node is a file (or a slice of a data
file) of: a big-endian magic (``0x0cdb3a2a`` manifest, ``0x0cdb20de``
node), its own length (uint64 LE), a format version (varint, 0), a
compression flag (varint: 0 none, 1 zstd), the body, and a CRC-32C of all
bytes before it (uint32 LE). Bodies store their lists column by column,
integers as LEB128 varints:

* manifest: config (uuid[16], manifest kind, max inline value bytes, max
  decoded node bytes, version-tree arity log2 (uint8), compression method,
  zstd level (int32 LE) when zstd); a data-file table; the latest versions
  (generation[n], root height (uint8)[n], root data file[n], offset[n],
  length[n], keys[n], tree bytes[n], indirect value bytes[n], commit time
  (uint64 LE)[n]); then references to older versions (not read).
* data-file table: count; path prefix shared with the previous path[n-1];
  suffix length[n]; base-path length[n]; the suffixes. A node's paths are
  relative to the base path of the file the node was read from.
* node: height (uint8); a data-file table; count; key prefix shared with
  the previous key[n-1]; key suffix length[n]; for interior nodes, the
  length of the prefix every key of the child's subtree shares[n]; the key
  suffixes. Interior entries then give child data file[n], offset[n],
  length[n] and three statistics[n]; the child's keys omit the shared
  prefix. Leaf entries give value length[n], value kind[n] (0 inline, 1 in
  a data file), data file and offset of each indirect value, then the
  inline values concatenated.

**zarr v2.** A leaf ``('params', 'core', 'w')`` is the array
``params.core.w``: the JSON key ``params.core.w/.zarray`` (shape, chunks,
little-endian dtype or ``bfloat16``, ``zstd`` compressor, ``.`` dimension
separator, C order) and one key per chunk, ``params.core.w/0.1``; each
chunk is a zstd frame of the full chunk (edge chunks padded). ``bfloat16``
is read as uint16 and viewed as ``torch.bfloat16``.

**The tree.** ``_METADATA`` lists every leaf by its key path, each key a
dict key (``key_type`` 2) or a sequence index (1): sequences come back as
lists, as orbax restores them (an optax tuple is a list, a named-tuple
state a dict by field); an empty dict, list or tuple (``skip_deserialize``)
is ``{}``, ``[]`` or ``()``, an ``optax.EmptyState`` ``None``.

Anything else raises ``OrbaxFormatError`` before a tree is returned: zarr3,
OCDBT off, another compressor or filter, a numbered manifest, a store of
several writing processes, a missing chunk, a bad checksum. Decompression
goes through ``utils/zstd.py`` (the system's libzstd).
"""

from __future__ import annotations

import ast
import json
import math
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
ITEM = "default"  # the item name of the JAX CheckpointManager's StandardSave
ARRAY_KINDS = ("np.ndarray", "jax.Array")
DICT_KEY, SEQUENCE_INDEX = 2, 1


class OrbaxFormatError(ValueError):
    """The checkpoint holds something this reader does not understand."""


# ---------------------------------------------------------------------------
# bytes
# ---------------------------------------------------------------------------


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OrbaxFormatError("OCDBT: record ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def uint_le(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OrbaxFormatError("OCDBT: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> bool:
        return self.pos == len(self.data)


def _unwrap(buf: bytes, magic: int, what: str) -> bytes:
    """Check a manifest's or node's header and checksum; return its body."""
    if len(buf) < 18 or int.from_bytes(buf[:4], "big") != magic:
        raise OrbaxFormatError(f"OCDBT {what}: bad magic")
    cur = _Cursor(buf)
    cur.take(4)
    length = cur.uint_le(8)
    if length != len(buf):
        raise OrbaxFormatError(f"OCDBT {what}: states {length} bytes, has {len(buf)}")
    if cur.varint() != 0:
        raise OrbaxFormatError(f"OCDBT {what}: unknown format version")
    compression = cur.varint()
    if crc32c(buf[:-4]) != int.from_bytes(buf[-4:], "little"):
        raise OrbaxFormatError(f"OCDBT {what}: checksum mismatch")
    body = buf[cur.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body).tobytes()
    raise OrbaxFormatError(f"OCDBT {what}: unknown compression {compression}")


def _file_table(cur: _Cursor, base: str) -> List[Tuple[str, str]]:
    """(base path, path) of each data file, both relative to the store's
    root: a node's own paths are relative to `base`."""
    n = cur.varint()
    shared = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    out, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise OrbaxFormatError("OCDBT: bad path prefix")
        prev = prev[:shared[i]] + cur.take(suffix[i])
        out.append((base + prev[:base_len[i]].decode(), base + prev.decode()))
    return out


def _keys(cur: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    shared = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    subtree = cur.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise OrbaxFormatError("OCDBT: bad key prefix")
        prev = prev[:shared[i]] + cur.take(suffix[i])
        keys.append(prev)
    return keys, subtree


# ---------------------------------------------------------------------------
# the key-value store
# ---------------------------------------------------------------------------


class OcdbtStore:
    """The latest version of an OCDBT store: every key and where its value
    lies (inline bytes, or a data file, offset and length)."""

    def __init__(self, root):
        self.root = Path(root)
        self._values: Dict[bytes, Any] = {}
        self._open: Dict[str, Any] = {}
        body = _unwrap((self.root / "manifest.ocdbt").read_bytes(), MANIFEST_MAGIC, "manifest")
        cur = _Cursor(body)
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            raise OrbaxFormatError("OCDBT: numbered manifests are not read")
        cur.varint(), cur.varint(), cur.u8()  # max inline, max node bytes, arity
        if cur.varint() == 1:  # compression method zstd, then its level
            cur.take(4)
        files = _file_table(cur, "")
        n = cur.varint()
        gen, height = cur.varints(n), [cur.u8() for _ in range(n)]
        fid, off, length = cur.varints(n), cur.varints(n), cur.varints(n)
        num_keys = cur.varints(n)
        if not n:
            raise OrbaxFormatError("OCDBT: the manifest holds no version")
        i = int(np.argmax(gen))
        self.generation = gen[i]
        if num_keys[i]:
            try:
                self._node(files[fid[i]], off[i], length[i], height[i], b"")
                if len(self._values) != num_keys[i]:
                    raise OrbaxFormatError(f"OCDBT: {len(self._values)} keys read, the "
                                           f"manifest states {num_keys[i]}")
            finally:
                self.close()

    def _bytes(self, path: str, offset: int, length: int) -> bytes:
        f = self._open.get(path)
        if f is None:
            f = self._open[path] = open(self.root / path, "rb")
        f.seek(offset)
        out = f.read(length)
        if len(out) != length:
            raise OrbaxFormatError(f"OCDBT: {path} ends before byte {offset + length}")
        return out

    def _node(self, file: Tuple[str, str], offset: int, length: int, height: int,
              prefix: bytes) -> None:
        base, path = file
        cur = _Cursor(_unwrap(self._bytes(path, offset, length), NODE_MAGIC, "node"))
        if cur.u8() != height:
            raise OrbaxFormatError("OCDBT: node height differs from its reference")
        files = _file_table(cur, base)
        n = cur.varint()
        keys, subtree = _keys(cur, n, height > 0)
        if height > 0:
            fid, off, ln = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)  # keys, tree bytes, indirect bytes below each child
            for i in range(n):
                self._node(files[fid[i]], off[i], ln[i], height - 1,
                           prefix + keys[i][:subtree[i]])
            return
        ln = cur.varints(n)
        kind = cur.varints(n)
        if any(k not in (0, 1) for k in kind):
            raise OrbaxFormatError("OCDBT: unknown value kind")
        indirect = [i for i in range(n) if kind[i] == 1]
        fid, off = cur.varints(len(indirect)), cur.varints(len(indirect))
        where = dict(zip(indirect, zip(fid, off)))
        for i in range(n):
            if kind[i]:
                f, o = where[i]
                self._values[prefix + keys[i]] = (files[f][1], o, ln[i])
            else:
                self._values[prefix + keys[i]] = cur.take(ln[i])
        if not cur.done():
            raise OrbaxFormatError("OCDBT: trailing bytes in a leaf node")

    def keys(self) -> List[bytes]:
        return sorted(self._values)

    def read(self, key) -> Optional[bytes]:
        """The value of `key` (str or bytes), None when absent."""
        key = key.encode() if isinstance(key, str) else key
        v = self._values.get(key)
        if v is None or isinstance(v, bytes):
            return v
        return self._bytes(*v)

    def close(self) -> None:
        for f in self._open.values():
            f.close()
        self._open.clear()


# ---------------------------------------------------------------------------
# zarr v2 arrays
# ---------------------------------------------------------------------------


def _dtype(name: str) -> Tuple[np.dtype, bool]:
    """(numpy dtype the bytes are read as, is bfloat16)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    dt = np.dtype(name)
    if dt.kind not in "biuf" or dt.byteorder == ">" or dt.itemsize > 8:
        raise OrbaxFormatError(f"zarr dtype {name!r} is not read")
    return dt.newbyteorder("<") if dt.byteorder == "=" else dt, False


def read_array(store: OcdbtStore, name: str) -> torch.Tensor:
    """The zarr v2 array `name` of the store, as a CPU tensor."""
    raw = store.read(f"{name}/.zarray")
    if raw is None:
        raise OrbaxFormatError(f"no array {name!r} in the store")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr_format {meta.get('zarr_format')}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: compressor {comp.get('id')!r} is not read")
    if meta.get("filters") or meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}: filters or Fortran order are not read")
    if meta.get("dimension_separator", ".") != ".":
        raise OrbaxFormatError(f"{name}: dimension separator "
                               f"{meta.get('dimension_separator')!r} is not read")
    dt, bf16 = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks):
        raise OrbaxFormatError(f"{name}: chunks {chunks} for shape {shape}")
    chunk_bytes = dt.itemsize * math.prod(chunks)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    out = None
    for idx in np.ndindex(*grid):
        key = f"{name}/{'.'.join(map(str, idx)) if idx else '0'}"
        data = store.read(key)
        if data is None:
            raise OrbaxFormatError(f"{name}: chunk {key!r} is missing")
        if comp is not None:
            data = zstd.decompress(data, chunk_bytes)
        if len(data) != chunk_bytes:
            raise OrbaxFormatError(f"{name}: chunk of {len(data)} bytes, expected {chunk_bytes}")
        chunk = np.frombuffer(data, dt).reshape(chunks)
        if chunks == shape:
            out = chunk.copy() if comp is None else chunk
            break
        if out is None:
            out = np.empty(shape, dt)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    if out is None:  # an array with a zero-length axis
        out = np.empty(shape, dt)
    t = torch.from_numpy(np.require(out, requirements=["C", "W"]))
    return t.view(torch.bfloat16) if bf16 else t


# ---------------------------------------------------------------------------
# the checkpoint tree
# ---------------------------------------------------------------------------


def is_orbax_step(step_dir) -> bool:
    """A step directory written by the JAX package's CheckpointManager."""
    return (Path(step_dir) / ITEM / "_METADATA").is_file()


def orbax_steps(ckpt_dir) -> List[int]:
    """The finished steps of an orbax checkpoint directory (orbax's
    ``*.orbax-checkpoint-tmp-*`` directories are unfinished saves)."""
    root = Path(ckpt_dir)
    if not root.is_dir():
        return []
    return sorted(int(p.name) for p in root.iterdir()
                  if p.name.isdigit() and is_orbax_step(p))


def read_meta(ckpt_dir, step: int) -> Optional[Dict]:
    """The trainer's ``meta_<step>.json`` sidecar, or None."""
    p = Path(ckpt_dir) / f"meta_{int(step)}.json"
    return json.loads(p.read_text()) if p.exists() else None


def _leaf_paths(metadata: Dict) -> Iterator[Tuple[Tuple[str, ...], Tuple[int, ...], Dict]]:
    for key, entry in metadata["tree_metadata"].items():
        km = entry.get("key_metadata")
        if km is None:
            raise OrbaxFormatError(f"_METADATA entry {key} has no key_metadata")
        path = tuple(str(k["key"]) for k in km)
        if path != tuple(str(k) for k in ast.literal_eval(key)):
            raise OrbaxFormatError(f"_METADATA key {key} disagrees with its key_metadata")
        kinds = tuple(int(k["key_type"]) for k in km)
        if any(k not in (DICT_KEY, SEQUENCE_INDEX) for k in kinds):
            raise OrbaxFormatError(f"{key}: key types {kinds} are not read")
        yield path, kinds, entry["value_metadata"]


def _leaf(store: OcdbtStore, path: Tuple[str, ...], vm: Dict):
    kind = vm.get("value_type")
    if kind in ARRAY_KINDS:
        return read_array(store, ".".join(path))
    if kind == "scalar":
        return read_array(store, ".".join(path)).item()
    if vm.get("skip_deserialize"):
        empty = {"Dict": dict, "List": list, "Tuple": tuple, "None": lambda: None}.get(kind)
        if empty is not None:
            return empty()
    raise OrbaxFormatError(f"{'/'.join(path)}: value type {kind!r} is not read")


def _sequences_to_lists(node):
    if isinstance(node, _Seq):
        if sorted(node) != list(range(len(node))):
            raise OrbaxFormatError(f"sequence indices {sorted(node)} are not 0..n-1")
        return [_sequences_to_lists(node[i]) for i in range(len(node))]
    if isinstance(node, dict):
        return {k: _sequences_to_lists(v) for k, v in node.items()}
    return node


class _Seq(dict):
    """A sequence while the tree is built, keyed by index."""


def read_orbax_step(step_dir) -> Dict[str, Any]:
    """The tree saved in one step directory (``<dir>/<step>``), leaves as CPU
    tensors; raises OrbaxFormatError rather than return a partial tree."""
    item = Path(step_dir) / ITEM
    if not is_orbax_step(step_dir):
        raise OrbaxFormatError(f"{step_dir} holds no {ITEM}/_METADATA")
    metadata = json.loads((item / "_METADATA").read_text())
    if metadata.get("use_zarr3"):
        raise OrbaxFormatError("zarr3 checkpoints are not read")
    if not metadata.get("use_ocdbt"):
        raise OrbaxFormatError("checkpoints without OCDBT are not read")
    writers = [p for p in item.iterdir() if p.name.startswith("ocdbt.process_")]
    if len(writers) > 1:
        raise OrbaxFormatError(f"a store of {len(writers)} writing processes is not read")
    store = OcdbtStore(item)
    tree: Dict = {}
    try:
        for path, kinds, vm in _leaf_paths(metadata):
            node = tree
            for i, (key, kind) in enumerate(zip(path, kinds)):
                k = int(key) if kind == SEQUENCE_INDEX else key
                if i == len(path) - 1:
                    node[k] = _leaf(store, path, vm)
                else:
                    child = node.setdefault(k, _Seq() if kinds[i + 1] == SEQUENCE_INDEX else {})
                    if isinstance(child, _Seq) != (kinds[i + 1] == SEQUENCE_INDEX):
                        raise OrbaxFormatError(f"{'/'.join(path)}: mixed key types")
                    node = child
    finally:
        store.close()
    return _sequences_to_lists(tree)


def read_orbax_checkpoint(ckpt_dir, step: Optional[int] = None) -> Tuple[int, Dict[str, Any]]:
    """(step, tree) of the given or latest step of an orbax checkpoint
    directory."""
    if step is None:
        steps = orbax_steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no orbax checkpoints under {ckpt_dir}")
        step = steps[-1]
    return int(step), read_orbax_step(Path(ckpt_dir) / str(int(step)))


def tree_leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf, dict keys sorted, list entries in order;
    empty containers and None are not leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree
