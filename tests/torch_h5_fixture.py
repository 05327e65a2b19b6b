"""A small HDF5 writer in numpy, ``struct`` and ``zlib`` for test files in
the layout h5py writes by default (superblock version 0, symbol-table
groups, version-1 object headers), and the shapenet15k-layout file that
``chip_smoke.py`` trains on. The machine with the card has no h5py; on
this side of the tests h5py reads back what this module writes.

``write(path, tree, chunked)``: ``tree`` maps names to numpy arrays
(datasets) or to dicts (groups); ``chunked`` maps a dataset's path
(``"03001627/test"``) to its chunk shape, stored through the shuffle and
deflate filters as h5py's ``compression="gzip", shuffle=True`` stores it.
Other datasets are contiguous. A group holds at most 256 entries and a
chunked dataset at most 64 chunks (one B-tree node each).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

UNDEF = 0xFFFF_FFFF_FFFF_FFFF
GROUP_LEAF_K, GROUP_INTERNAL_K, CHUNK_K = 4, 16, 32
SYMBOL_ENTRY = 40


class _Out:
    """The file as a growing buffer; every block 8-byte aligned."""

    def __init__(self):
        self.buf = bytearray(96)            # the superblock, written last

    def alloc(self, data: bytes) -> int:
        addr = len(self.buf)
        self.buf += data
        self.buf += b"\0" * (-len(self.buf) % 8)
        return addr


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _datatype(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    if dtype == np.float32:
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 31, 0, 4, 0, 32, 23,
                           8, 0, 23, 127)
    if dtype == np.float64:
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 63, 0, 8, 0, 64, 52,
                           11, 0, 52, 1023)
    if dtype in (np.int32, np.int64, np.uint8):
        signed = 0x08 if dtype.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, signed, 0, 0, dtype.itemsize,
                           0, 8 * dtype.itemsize)
    raise ValueError(f"unsupported dtype {dtype}")


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(out: _Out, messages) -> int:
    data = b"".join(messages)
    head = struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(data))
    return out.alloc(head + data)


def _dataset(out: _Out, arr: np.ndarray,
             chunks: Optional[Tuple[int, ...]], level: int) -> int:
    arr = np.ascontiguousarray(arr)
    rank = arr.ndim
    space = struct.pack("<BBBB4x", 1, rank, 1 if rank else 0, 0)
    space += struct.pack(f"<{2 * rank}Q", *arr.shape, *arr.shape)
    msgs = [_message(0x0001, space),
            _message(0x0003, _datatype(arr.dtype), 1)]
    if chunks is None:
        addr = out.alloc(arr.tobytes()) if arr.size else UNDEF
        msgs.append(_message(0x0005, struct.pack("<BBBBI", 2, 2, 2, 1, 0),
                             1))
        msgs.append(_message(0x0008, struct.pack(
            "<BBQQ", 3, 1, addr, arr.nbytes)))
        return _object_header(out, msgs)
    btree = _chunk_btree(out, arr, tuple(chunks), level)
    msgs.append(_message(0x0005, struct.pack("<BBBBI", 2, 3, 2, 1, 0), 1))
    filters = struct.pack("<BB6x", 1, 2)
    for fid, name, value in ((2, b"shuffle\0", arr.dtype.itemsize),
                             (1, b"deflate\0", level)):
        filters += struct.pack("<HHHH", fid, len(name), 1, 1) + name
        filters += struct.pack("<I4x", value)
    msgs.append(_message(0x000B, filters, 1))
    layout = struct.pack("<BBBQ", 3, 2, rank + 1, btree)
    layout += struct.pack(f"<{rank + 1}I", *chunks, arr.dtype.itemsize)
    msgs.append(_message(0x0008, layout))
    return _object_header(out, msgs)


def _chunk_btree(out: _Out, arr: np.ndarray, chunks, level: int) -> int:
    grid = [range(0, n, c) for n, c in zip(arr.shape, chunks)]
    offsets = [()]
    for axis in grid:
        offsets = [o + (i,) for o in offsets for i in axis]
    if len(offsets) > 2 * CHUNK_K:
        raise ValueError(f"{len(offsets)} chunks: one B-tree node holds "
                         f"{2 * CHUNK_K}")
    itemsize = arr.dtype.itemsize
    entries = []
    for off in offsets:
        chunk = np.zeros(chunks, arr.dtype)
        src = tuple(slice(o, min(o + c, n))
                    for o, c, n in zip(off, chunks, arr.shape))
        chunk[tuple(slice(0, s.stop - s.start) for s in src)] = arr[src]
        raw = chunk.tobytes()
        n = len(raw) // itemsize
        shuffled = np.frombuffer(raw, np.uint8).reshape(n, itemsize).T
        stored = zlib.compress(shuffled.tobytes(), level)
        entries.append((off, len(stored), out.alloc(stored)))
    rank = arr.ndim

    def key(size, off):
        return struct.pack(f"<II{rank + 1}Q", size, 0, *off, 0)

    node = b"TREE" + struct.pack("<BBHQQ", 1, 0, len(entries), UNDEF, UNDEF)
    for off, size, addr in entries:
        node += key(size, off) + struct.pack("<Q", addr)
    last = entries[-1][0]
    node += key(0, tuple(o + c for o, c in zip(last, chunks)))
    key_len = 8 + 8 * (rank + 1)
    full = 24 + 2 * CHUNK_K * 8 + (2 * CHUNK_K + 1) * key_len
    return out.alloc(node + b"\0" * (full - len(node)))


def _group(out: _Out, tree: Dict, path: str, chunked: Dict,
           level: int) -> Tuple[int, int, int]:
    """Writes a group and everything under it; returns the addresses of its
    object header, B-tree and local heap."""
    names = sorted(tree)
    if len(names) > 2 * GROUP_INTERNAL_K * 2 * GROUP_LEAF_K:
        raise ValueError(f"{len(names)} entries in one group")
    entries = []
    for name in names:
        sub = f"{path}/{name}" if path else name
        value = tree[name]
        if isinstance(value, dict):
            header, btree, heap = _group(out, value, sub, chunked, level)
            entries.append((name, header, 1, struct.pack("<QQ", btree, heap)))
        else:
            header = _dataset(out, np.asarray(value), chunked.get(sub), level)
            entries.append((name, header, 0, b"\0" * 16))
    heap = bytearray(8)                      # offset 0: the empty name
    offsets = []
    for name, *_ in entries:
        offsets.append(len(heap))
        heap += _pad8(name.encode() + b"\0")
    free = len(heap)
    heap += struct.pack("<QQ", 1, 16)        # one free block, list end
    data_addr = out.alloc(bytes(heap))
    heap_addr = out.alloc(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap),
                                                free, data_addr))
    per_node = 2 * GROUP_LEAF_K
    snods, keys = [], [0]
    for s in range(0, max(len(entries), 1), per_node):
        part = entries[s:s + per_node]
        node = b"SNOD" + struct.pack("<BBH", 1, 0, len(part))
        for (name, header, cache, scratch), off in zip(
                part, offsets[s:s + per_node]):
            node += struct.pack("<QQI4x", off, header, cache) + scratch
        node += b"\0" * (8 + per_node * SYMBOL_ENTRY - len(node))
        snods.append(out.alloc(node))
        keys.append(offsets[s + len(part) - 1] if part else 0)
    tree_node = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snods), UNDEF,
                                      UNDEF)
    for k, child in zip(keys, snods):
        tree_node += struct.pack("<QQ", k, child)
    tree_node += struct.pack("<Q", keys[-1])
    full = 24 + 2 * GROUP_INTERNAL_K * 8 + (2 * GROUP_INTERNAL_K + 1) * 8
    btree = out.alloc(tree_node + b"\0" * (full - len(tree_node)))
    header = _object_header(out, [_message(0x0011, struct.pack(
        "<QQ", btree, heap_addr))])
    return header, btree, heap_addr


def write(path: str, tree: Dict, chunked: Optional[Dict] = None,
          level: int = 4) -> None:
    """Write ``tree`` (names -> arrays or dicts) as an HDF5 file."""
    out = _Out()
    header, btree, heap = _group(out, tree, "", chunked or {}, level)
    sb = b"\x89HDF\r\n\x1a\n" + struct.pack(
        "<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, GROUP_LEAF_K,
        GROUP_INTERNAL_K, 0)
    sb += struct.pack("<QQQQ", 0, UNDEF, len(out.buf), UNDEF)
    sb += struct.pack("<QQI4xQQ", 0, header, 1, btree, heap)
    out.buf[:96] = sb
    with open(path, "wb") as f:
        f.write(out.buf)


# --------------------------------------------- the shapenet15k-layout file
CHAIR, AIRPLANE = "03001627", "02691156"
SPLITS = {CHAIR: {"train": 175, "val": 8, "test": 64},
          AIRPLANE: {"train": 4, "val": 2, "test": 4}}
TEST_CHUNKS = (5, 2048, 3)


def shapenet_clouds(seed: int, n_points: int = 2048,
                    splits: Optional[Dict] = None) -> Dict:
    """``{synsetid: {split: (n, n_points, 3) float32}}``: gaussian-mixture
    shapes (``SyntheticShapes``' recipe: four centres, 0.15 spread), each
    scaled and shifted so that the scale modes have work to do."""
    out = {}
    rng = np.random.RandomState(seed)
    for synsetid, split_sizes in (splits or SPLITS).items():
        out[synsetid] = {}
        for split, n in split_sizes.items():
            centers = rng.randn(n, 4, 3).astype(np.float32) * 0.5
            assign = rng.randint(0, 4, (n, n_points))
            pts = (np.take_along_axis(centers, assign[..., None], 1)
                   + 0.15 * rng.randn(n, n_points, 3).astype(np.float32))
            scale = rng.uniform(0.5, 2.0, (n, 1, 1)).astype(np.float32)
            shift = rng.randn(n, 1, 3).astype(np.float32)
            out[synsetid][split] = (pts * scale + shift).astype(np.float32)
    return out


def write_shapenet(path: str, seed: int, n_points: int = 2048,
                   splits: Optional[Dict] = None) -> Dict:
    """The shapenet15k layout at ``path``: chair's train split contiguous,
    its test split chunked (``TEST_CHUNKS``, a ragged last chunk) through
    shuffle and deflate. Returns the clouds written."""
    clouds = shapenet_clouds(seed, n_points, splits)
    chunks = (TEST_CHUNKS[0], n_points, 3)
    write(path, clouds, {f"{CHAIR}/test": chunks})
    return clouds
