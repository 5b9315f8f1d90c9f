"""Reading JAX's orbax checkpoint directories, with numpy and the system's
libzstd (utils/zstd.py) only.

Counterpart of the reading side of buctd_tpu/train/checkpoint.py:
``load_params`` (:104) returns the whole tree of a directory that JAX's
``save_params`` (:97) or ``save_checkpoint`` (:48) wrote, as its
``load_params(path, template=None)`` does.  The writers stay JAX's: the port
trains to ``.pth`` (train/run.py).

orbax's ``StandardCheckpointer`` writes one OCDBT key-value database in the
directory (``manifest.ocdbt``; nodes and values in ``d/<id>`` and
``ocdbt.process_<i>/d/<id>``), and in it one zarr v2 array per leaf: the key
``<path>/.zarray`` holds the array's JSON metadata, and ``<path>/<i>.<j>...``
its chunks, where ``<path>`` joins the leaf's tree keys with ``.``.
``_METADATA`` (JSON) lists each leaf's key tuple, so the tree is rebuilt from
it and chunk keys are made from its tuples, never by splitting on ``.``.

The OCDBT layout read here (tensorstore's format, version 0):

* every manifest and B-tree node is ``magic (u32 big-endian) | total length
  (u64) | version (varint, 0) | compression (varint: 0 none, 1 zstd) | body |
  CRC-32C (u32) of everything before it``; magics 0x0cdb3a2a (manifest) and
  0x0cdb20de (B-tree node);
* the manifest body: the config (a 16-byte uuid, manifest kind, the inline
  and node size limits, the version tree's arity, the compression and its
  zstd level as an int32), then a data-file table and the versions, each with
  its generation and the location of its B-tree root;
* a data-file table: the number of files, then each path's prefix shared with
  the previous one, the suffix lengths, the base-path lengths, and the
  suffixes; paths are relative to the directory of the manifest;
* a B-tree node: its height, a data-file table and its entries, column by
  column: key prefix lengths shared with the previous key, key suffix
  lengths, (interior nodes) each child's common key prefix length, the key
  suffixes, then either each child's location (file, offset, length) and
  statistics, or (leaves) each value's length and kind (0 inline, 1 a
  file, offset and the length in a data file) and the inline values.  A
  child's keys omit the common prefix its parent entry names.

Arrays: zarr v2 with ``compressor`` zstd or null and no ``filters``; ``order``
C or F; chunks that are absent take ``fill_value`` (null reads as zero).
bfloat16 leaves come back as float32 holding the same values (numpy has no
bfloat16, and widening bf16 to f32 is exact).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..utils.zstd import decompress

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_OFFSET = (1 << 64) - 1


class CheckpointFormatError(ValueError):
    """A directory that is not an orbax checkpoint this reader can read."""


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT seals its manifests and nodes."""
    c, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Reads varints, fixed-width integers and byte runs off a body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise CheckpointFormatError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32le(self) -> int:
        return int.from_bytes(self.take(4), "little")

    def u64le(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise CheckpointFormatError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise CheckpointFormatError(f"{self.what}: {len(self.data) - self.pos} bytes "
                                        "after the end")


def _unseal(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or B-tree node: header, CRC-32C and compression
    checked."""
    if len(raw) < 18:
        raise CheckpointFormatError(f"{what}: {len(raw)} bytes, too short")
    if int.from_bytes(raw[:4], "big") != magic:
        raise CheckpointFormatError(f"{what}: magic {raw[:4].hex()}, expected {magic:08x}")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise CheckpointFormatError(f"{what}: its header says "
                                    f"{int.from_bytes(raw[4:12], 'little')} bytes, it has "
                                    f"{len(raw)}")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise CheckpointFormatError(f"{what}: CRC-32C mismatch")
    cur = _Cursor(raw[12:-4], what)
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise CheckpointFormatError(f"{what}: format version {version}, only 0 is read")
    body = cur.data[cur.pos:]
    if compression == 1:
        return decompress(body)
    if compression != 0:
        raise CheckpointFormatError(f"{what}: compression {compression} is not none or zstd")
    return body


def _data_file_table(cur: _Cursor) -> list:
    """The paths of a data-file table, relative to the database's directory."""
    n = cur.varint()
    if n == 0:
        return []
    prefix = [0] + cur.varints(n - 1)
    suffix = cur.varints(n)
    cur.varints(n)  # base-path lengths: where each path's base ends
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise CheckpointFormatError(f"{cur.what}: data-file path prefix past the "
                                        "previous path")
        prev = prev[:p] + cur.take(s)
        paths.append(prev.decode())
    return paths


class OcdbtStore:
    """The keys and values of the latest version of an OCDBT database.

    ``keys()`` lists every key; ``get(key)`` reads a value (``None`` when the
    key is absent); ``root_height`` is the B-tree's height (0: the root is a
    leaf).  Use as a context manager to close the data files."""

    def __init__(self, root):
        self.root = Path(root)
        self._fds: dict = {}
        self._lock = threading.Lock()
        self._values: dict = {}
        manifest = self.root / "manifest.ocdbt"
        if not manifest.exists():
            raise CheckpointFormatError(f"{self.root}: no manifest.ocdbt")
        cur = _Cursor(_unseal(manifest.read_bytes(), MANIFEST_MAGIC, str(manifest)),
                      str(manifest))
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            raise CheckpointFormatError(f"{manifest}: manifest kind {kind} (numbered "
                                        "manifests) is not read; orbax writes kind 0")
        cur.varint(), cur.varint(), cur.u8()  # max inline value, max node bytes, arity
        if cur.varint() == 1:
            cur.u32le()  # zstd level
        files = _data_file_table(cur)
        n = cur.varint()
        if n == 0:
            raise CheckpointFormatError(f"{manifest}: no version inline")
        generation = cur.varints(n)
        height = [cur.u8() for _ in range(n)]
        file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        num_keys = cur.varints(n)
        cur.varints(n), cur.varints(n)  # tree bytes, indirect value bytes
        [cur.u64le() for _ in range(n)]  # commit times
        last = max(range(n), key=generation.__getitem__)
        self.root_height = height[last]
        if num_keys[last] and offset[last] != _NO_OFFSET:
            try:
                self._walk(self._location(files, file_id[last], offset[last], length[last]),
                           height[last], b"")
            except BaseException:
                self.close()
                raise

    def _location(self, files: list, file_id: int, offset: int, length: int) -> tuple:
        if file_id >= len(files):
            raise CheckpointFormatError(f"{self.root}: data file {file_id} of "
                                        f"{len(files)}")
        path = files[file_id]
        if path.startswith("/") or ".." in Path(path).parts:
            raise CheckpointFormatError(f"{self.root}: data file {path!r} outside the "
                                        "directory")
        return path, offset, length

    def _read(self, loc: tuple) -> bytes:
        path, offset, length = loc
        with self._lock:
            fd = self._fds.get(path)
            if fd is None:
                full = self.root / path
                if not full.exists():
                    raise CheckpointFormatError(f"{full}: data file missing")
                fd = self._fds[path] = os.open(full, os.O_RDONLY)
        data = os.pread(fd, length, offset)
        if len(data) != length:
            raise CheckpointFormatError(f"{self.root / path}: {length} bytes at {offset} "
                                        "run past its end")
        return data

    def _walk(self, loc: tuple, height: int, prefix: bytes) -> None:
        what = f"{self.root / loc[0]}@{loc[1]}"
        cur = _Cursor(_unseal(self._read(loc), NODE_MAGIC, what), what)
        if cur.u8() != height:
            raise CheckpointFormatError(f"{what}: B-tree node at the wrong height")
        files = _data_file_table(cur)
        n = cur.varint()
        shared = [0] + cur.varints(n - 1) if n else []
        suffix = cur.varints(n)
        common = cur.varints(n) if height else None
        keys, prev = [], b""
        for p, s in zip(shared, suffix):
            if p > len(prev):
                raise CheckpointFormatError(f"{what}: key prefix past the previous key")
            prev = prev[:p] + cur.take(s)
            keys.append(prev)
        if height:
            ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)  # each child's keys, tree bytes, indirect value bytes
            cur.done()
            for key, c, f, o, ln in zip(keys, common, ids, offsets, lengths):
                if c > len(key):
                    raise CheckpointFormatError(f"{what}: common prefix past its key")
                self._walk(self._location(files, f, o, ln), height - 1, prefix + key[:c])
            return
        lengths = cur.varints(n)
        kinds = cur.varints(n)
        n_ind = sum(k == 1 for k in kinds)
        if any(k not in (0, 1) for k in kinds):
            raise CheckpointFormatError(f"{what}: value kind not inline or indirect")
        ids, offsets = cur.varints(n_ind), cur.varints(n_ind)
        it = iter(zip(ids, offsets))
        for key, ln, kind in zip(keys, lengths, kinds):
            if kind:
                f, o = next(it)
                self._values[prefix + key] = self._location(files, f, o, ln)
            else:
                self._values[prefix + key] = cur.take(ln)
        cur.done()

    def keys(self) -> list:
        return sorted(self._values)

    def get(self, key):
        value = self._values.get(key.encode() if isinstance(key, str) else key)
        if value is None or isinstance(value, bytes):
            return value
        return self._read(value)

    def close(self) -> None:
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _zarr_dtype(name: str, where: str) -> np.dtype:
    if name == "bfloat16":
        return np.dtype("<u2")  # raw bits, widened by _read_array
    try:
        dtype = np.dtype(name)
    except TypeError as err:
        raise CheckpointFormatError(f"{where}: dtype {name!r} is not a numpy dtype") from err
    if dtype.kind not in "biufc":
        raise CheckpointFormatError(f"{where}: dtype {name!r} is not numeric")
    return dtype


# zarr v2's JSON words for the float fill values JSON has no number for
_FILL_WORDS = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}


def _read_array(store, name: str) -> np.ndarray:
    """The zarr v2 array stored under ``name``."""
    raw_meta = store.get(f"{name}/.zarray")
    if raw_meta is None:
        raise CheckpointFormatError(f"{name}: no {name}/.zarray in the checkpoint")
    meta = json.loads(raw_meta)
    where = f"{name}/.zarray"
    if meta.get("zarr_format") != 2:
        raise CheckpointFormatError(f"{where}: zarr_format {meta.get('zarr_format')}, only 2 "
                                    "is read")
    if meta.get("filters"):
        raise CheckpointFormatError(f"{where}: filters {meta['filters']} are not read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise CheckpointFormatError(f"{where}: compressor {compressor.get('id')!r} is not "
                                    "zstd or null")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise CheckpointFormatError(f"{where}: order {order!r}")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = _zarr_dtype(meta["dtype"], where)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise CheckpointFormatError(f"{where}: chunks {chunks} do not fit shape {shape}")
    fill = meta.get("fill_value")
    if bf16 and fill is not None:
        raise CheckpointFormatError(f"{where}: a bfloat16 fill value is not read")
    out = np.full(shape, 0 if fill is None else _FILL_WORDS.get(fill, fill), dtype)
    sep = meta.get("dimension_separator", ".")
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in (np.ndindex(*grid) if shape else [()]):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = store.get(key)
        if data is None:       # an absent chunk holds the fill value
            continue
        if compressor is not None:
            data = decompress(data, size_hint=nbytes, max_size=nbytes)
        if len(data) != nbytes:
            raise CheckpointFormatError(f"{key}: {len(data)} bytes, a chunk holds {nbytes}")
        block = np.frombuffer(data, dtype).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    if bf16:
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


# leaves that orbax writes as metadata alone: an empty dict, and None
_EMPTY = {"Dict": dict, "None": lambda: None}


def _insert(tree: dict, keys: list, leaf) -> None:
    node = tree
    for i, k in enumerate(keys):
        kind = (k["key_type"], k["key"])
        if i == len(keys) - 1:
            node[kind] = leaf
        else:
            node = node.setdefault(kind, {})


def _build(node):
    """Nested dicts keyed by (key_type, key) → dicts (key_type 2) and lists
    (key_type 1, ordered by index)."""
    if not isinstance(node, dict) or not node:
        return node
    types = {t for t, _ in node}
    if types == {1}:
        items = sorted(node.items(), key=lambda kv: int(kv[0][1]))
        if [int(k) for (_, k), _ in items] != list(range(len(items))):
            raise CheckpointFormatError("sequence indices in _METADATA are not 0..n-1")
        return [_build(v) for _, v in items]
    if types != {2}:
        raise CheckpointFormatError(f"_METADATA key types {sorted(types)} are not 1 "
                                    "(sequence) or 2 (dict)")
    return {k: _build(v) for (_, k), v in node.items()}


def load_params(path) -> dict:
    """The whole tree of an orbax checkpoint directory: nested dicts and
    lists of numpy arrays, ``None`` where the tree held ``None`` (JAX's
    ``load_params(path, template=None)``).  Up to 8 threads read the arrays
    (libzstd runs without the GIL)."""
    root = Path(path)
    meta_path = root / "_METADATA"
    if not meta_path.exists():
        raise CheckpointFormatError(f"{root}: no _METADATA, not an orbax checkpoint")
    meta = json.loads(meta_path.read_text())
    if meta.get("use_zarr3"):
        raise CheckpointFormatError(f"{root}: zarr3 arrays (use_zarr3 true) are not read")
    if not meta.get("use_ocdbt", True):
        raise CheckpointFormatError(f"{root}: use_ocdbt false (a file a key) is not read; "
                                    "orbax's StandardCheckpointer writes OCDBT")
    entries = meta.get("tree_metadata")
    if entries is None:
        raise CheckpointFormatError(f"{meta_path}: no tree_metadata")
    tree: dict = {}
    arrays = []
    for entry in entries.values():
        keys, value = entry["key_metadata"], entry["value_metadata"]
        if value["value_type"] in _EMPTY:
            _insert(tree, keys, _EMPTY[value["value_type"]]())
        elif value.get("skip_deserialize"):
            raise CheckpointFormatError(f"{meta_path}: leaf {[k['key'] for k in keys]} of "
                                        f"type {value['value_type']!r} holds no array")
        else:
            arrays.append(keys)
    with OcdbtStore(root) as store, ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        leaves = list(pool.map(
            lambda keys: _read_array(store, ".".join(str(k["key"]) for k in keys)), arrays))
    for keys, leaf in zip(arrays, leaves):
        _insert(tree, keys, leaf)
    return _build(tree)


def leaf_digests(tree, path=()) -> dict:
    """``{"a/b/c": {"dtype", "shape", "sha256"}}`` over a nested tree of dicts,
    lists and arrays (``None`` leaves are left out): what a fixture's
    ``expected.json`` holds."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        here = path + (str(key),)
        if isinstance(value, (dict, list, tuple)):
            out.update(leaf_digests(value, here))
        elif value is not None:
            arr = np.ascontiguousarray(np.asarray(value))
            out["/".join(here)] = {"dtype": str(arr.dtype), "shape": list(arr.shape),
                                   "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    return out
