"""A reader for the HDF5 subset that h5py writes by default (the port's
counterpart of the ``h5py`` calls in pdgn_tpu/data/shapenet.py:133-165 and
provider.py:180-185), in numpy, ``struct`` and ``zlib``.

``File(path)[name][split][...]`` returns numpy arrays, as h5py does. The
subset (HDF5 file format specification, version 2):

* superblock version 0 or 1, 8-byte offsets and lengths;
* groups kept in symbol tables: the version-1 B-tree of group nodes (any
  depth), its ``SNOD`` symbol nodes and the group's local heap of names;
* version-1 object headers, continuation blocks included;
* simple or scalar dataspaces; little-endian float32, float64, int32,
  int64 and uint8;
* contiguous storage, read with one ``np.fromfile`` at its offset (the
  shapenet15k file is about 1.2 GB), and chunked storage through the
  version-1 chunk B-tree, unfiltered or through the deflate and shuffle
  filters; edge chunks are cut to the extent, and chunks never written
  (and unallocated contiguous storage) read as the fill value.

Anything else raises :class:`H5FormatError` naming the structure, e.g.
superblock version 2 or 3 (h5py's ``libver="latest"``), link-message
groups, compact layout or another filter.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFF_FFFF_FFFF_FFFF
# object header message types the reader acts on
MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x0001, 0x0002, 0x0003
MSG_FILL, MSG_LINK, MSG_LAYOUT = 0x0005, 0x0006, 0x0008
MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x000B, 0x0010, 0x0011
FILTER_DEFLATE, FILTER_SHUFFLE = 1, 2
FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset",
                32000: "lzf", 32001: "blosc", 32004: "lz4", 32015: "zstd"}


class H5FormatError(ValueError):
    """The file uses an HDF5 structure outside the supported subset."""


class _Reader:
    """Little-endian reads at absolute addresses of an open file."""

    def __init__(self, fh, base: int):
        self.fh = fh
        self.base = base

    def read(self, addr: int, n: int) -> bytes:
        self.fh.seek(self.base + addr)
        data = self.fh.read(n)
        if len(data) != n:
            raise H5FormatError(
                f"truncated file: {n} bytes wanted at address {addr}")
        return data


def _u(data: bytes, off: int, size: int) -> int:
    return int.from_bytes(data[off:off + size], "little")


class _Messages:
    """The messages of one version-1 object header, continuations
    followed: ``{type: [body, ...]}``."""

    def __init__(self, r: _Reader, addr: int):
        head = r.read(addr, 16)
        if head[:4] == b"OHDR":
            raise H5FormatError(
                f"object header version 2 at address {addr} (files written "
                "with libver='latest' or later)")
        if head[0] != 1:
            raise H5FormatError(
                f"object header version {head[0]} at address {addr}")
        total, size = _u(head, 2, 2), _u(head, 8, 4)
        self.by_type: Dict[int, List[Tuple[bytes, int]]] = {}
        blocks = [(addr + 16, size)]
        seen = 0
        while blocks:
            start, length = blocks.pop(0)
            data = r.read(start, length)
            p = 0
            while p + 8 <= length and seen < total:
                mtype, msize, flags = _u(data, p, 2), _u(data, p + 2, 2), \
                    data[p + 4]
                body = data[p + 8:p + 8 + msize]
                seen += 1
                if mtype == MSG_CONTINUATION:
                    blocks.append((_u(body, 0, 8), _u(body, 8, 8)))
                elif mtype != 0:
                    self.by_type.setdefault(mtype, []).append((body, flags))
                p += 8 + msize

    def get(self, mtype: int) -> Optional[bytes]:
        found = self.by_type.get(mtype)
        if not found:
            return None
        body, flags = found[0]
        if flags & 0x02:
            raise H5FormatError(f"shared message of type {mtype:#06x} "
                                "(committed datatype or shared dataspace)")
        return body


# ----------------------------------------------------------- dataset parts
def _dataspace(body: bytes) -> Tuple[int, ...]:
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        off = 8
    elif version == 2:
        if body[3] == 2:
            raise H5FormatError("null dataspace")
        off = 4
    else:
        raise H5FormatError(f"dataspace message version {version}")
    return tuple(_u(body, off + 8 * i, 8) for i in range(rank))


_FLOATS = {4: (31, 23, 8, 0, 23, 127), 8: (63, 52, 11, 0, 52, 1023)}


def _datatype(body: bytes) -> np.dtype:
    cls, version = body[0] & 0x0F, body[0] >> 4
    bits = body[1] | body[2] << 8 | body[3] << 16
    size = _u(body, 4, 4)
    order = "big-endian" if bits & 1 else "little-endian"
    if cls == 0:
        signed = bool(bits & 0x08)
        name = {(4, True): "<i4", (8, True): "<i8", (1, False): "|u1"}.get(
            (size, signed))
        if name is None or bits & 1 or _u(body, 8, 2) != 0 \
                or _u(body, 10, 2) != 8 * size:
            raise H5FormatError(
                f"datatype fixed-point {size} bytes "
                f"{'signed' if signed else 'unsigned'} {order} (supported: "
                "little-endian int32, int64, uint8)")
        return np.dtype(name)
    if cls == 1:
        # sign location, exponent location and size, mantissa location and
        # size, exponent bias; normalisation "implied", no padding bits
        want = _FLOATS.get(size)
        props = (bits >> 8 & 0xFF, body[12], body[13], body[14], body[15],
                 _u(body, 16, 4))
        if want is None or bits & 0x7F != 0x20 or _u(body, 8, 2) != 0 \
                or _u(body, 10, 2) != 8 * size or props != want:
            raise H5FormatError(
                f"datatype floating-point {size} bytes {order} (supported: "
                "little-endian IEEE float32, float64)")
        return np.dtype("<f4" if size == 4 else "<f8")
    names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
             6: "compound", 7: "reference", 8: "enumerated",
             9: "variable-length", 10: "array"}
    raise H5FormatError(
        f"datatype class {names.get(cls, cls)} (version {version})")


def _fill(body: Optional[bytes], dtype: np.dtype):
    """The fill value of the fill-value message (versions 1-3), or 0
    (h5py writes no old-style fill-value message)."""
    if body is None:
        return 0
    version = body[0]
    if version in (1, 2):
        defined = body[3] if version == 2 else 1
        off = 4
    elif version == 3:
        defined = body[1] & 0x20
        off = 2
    else:
        raise H5FormatError(f"fill value message version {version}")
    if not defined or len(body) < off + 4 or _u(body, off, 4) == 0:
        return 0
    size = _u(body, off, 4)
    if size != dtype.itemsize:
        raise H5FormatError(f"fill value of {size} bytes for {dtype}")
    return np.frombuffer(body[off + 4:off + 4 + size], dtype)[0]


def _filters(body: Optional[bytes]) -> List[Tuple[int, Tuple[int, ...]]]:
    """``[(filter id, client values), ...]`` in pipeline order."""
    if body is None:
        return []
    version, count = body[0], body[1]
    if version not in (1, 2):
        raise H5FormatError(f"filter pipeline message version {version}")
    p = 8 if version == 1 else 2
    out = []
    for _ in range(count):
        fid = _u(body, p, 2)
        if version == 1 or fid >= 256:
            name_len = _u(body, p + 2, 2)
            p += 4
        else:
            name_len = 0
            p += 2
        nvalues = _u(body, p + 2, 2)
        p += 4
        if name_len:
            p += (name_len + 7) // 8 * 8 if version == 1 else name_len
        values = struct.unpack_from(f"<{nvalues}I", body, p)
        p += 4 * nvalues
        if version == 1 and nvalues % 2:
            p += 4
        if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE):
            raise H5FormatError(
                f"filter {FILTER_NAMES.get(fid, fid)} (supported: deflate, "
                "shuffle)")
        out.append((fid, values))
    return out


def _unfilter(raw: bytes, filters, mask: int, itemsize: int) -> bytes:
    for i in reversed(range(len(filters))):
        if mask >> i & 1:
            continue            # this filter was skipped for the chunk
        fid = filters[i][0]
        if fid == FILTER_DEFLATE:
            raw = zlib.decompress(raw)
        else:   # shuffle: byte j of every element was stored in plane j
            n = len(raw) // itemsize
            planes = np.frombuffer(raw, np.uint8, n * itemsize)
            body = planes.reshape(itemsize, n).T.tobytes()
            raw = body + raw[n * itemsize:]
    return raw


class Dataset:
    """An h5py-style dataset: ``shape``, ``dtype``, ``chunks`` (None when
    contiguous), ``compression`` (``"gzip"`` or None), ``shuffle``,
    ``ds[...]``, ``ds[:]`` and ``len(ds)``."""

    def __init__(self, file: "File", name: str, msgs: _Messages):
        self.file, self.name = file, name
        space, dtype = msgs.get(MSG_DATASPACE), msgs.get(MSG_DATATYPE)
        layout = msgs.get(MSG_LAYOUT)
        if space is None or dtype is None or layout is None:
            raise H5FormatError(f"{name}: no dataspace, datatype or layout "
                                "message")
        self.shape = _dataspace(space)
        self.dtype = _datatype(dtype)
        self._fill = _fill(msgs.get(MSG_FILL), self.dtype)
        self._filters = _filters(msgs.get(MSG_FILTERS))
        if layout[0] != 3:
            raise H5FormatError(f"{name}: data layout message version "
                                f"{layout[0]} (supported: 3)")
        self._layout = layout[1]
        self.chunks: Optional[Tuple[int, ...]] = None
        fids = [fid for fid, _ in self._filters]
        self.compression = "gzip" if FILTER_DEFLATE in fids else None
        self.shuffle = FILTER_SHUFFLE in fids
        if self._layout == 1:
            self._addr, self._size = _u(layout, 2, 8), _u(layout, 10, 8)
        elif self._layout == 2:
            ndims = layout[2]
            self._addr = _u(layout, 3, 8)
            self.chunks = tuple(_u(layout, 11 + 4 * i, 4)
                                for i in range(ndims - 1))
        else:
            kind = {0: "compact", 3: "virtual"}.get(self._layout,
                                                    self._layout)
            raise H5FormatError(f"{name}: {kind} layout (supported: "
                                "contiguous, chunked)")
        if self._layout == 1 and self._filters:
            raise H5FormatError(f"{name}: filters on contiguous storage")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("a scalar dataset has no len()")
        return self.shape[0]

    def __getitem__(self, key):
        return self.read()[key]

    def read(self) -> np.ndarray:
        """The whole dataset as a new numpy array."""
        if self._layout == 1:
            if self._addr == UNDEF:
                return np.full(self.shape, self._fill, self.dtype)
            want = self.size * self.dtype.itemsize
            if self._size < want:
                raise H5FormatError(f"{self.name}: {self._size} bytes of "
                                    f"storage for {want}")
            data = np.fromfile(self.file.path, self.dtype, self.size,
                               offset=self.file.base + self._addr)
            if data.size != self.size:
                raise H5FormatError(f"{self.name}: truncated data")
            return data.reshape(self.shape)
        return self._read_chunked()

    def _read_chunked(self) -> np.ndarray:
        out = np.full(self.shape, self._fill, self.dtype)
        if self._addr == UNDEF:
            return out
        rank = len(self.shape)
        nbytes = int(np.prod(self.chunks)) * self.dtype.itemsize
        for offset, size, mask, addr in self._chunk_entries(self._addr,
                                                            rank + 1):
            raw = self.file._r.read(addr, size)
            raw = _unfilter(raw, self._filters, mask, self.dtype.itemsize)
            if len(raw) != nbytes:
                raise H5FormatError(
                    f"{self.name}: chunk at {offset} holds {len(raw)} bytes "
                    f"after its filters, {nbytes} expected")
            chunk = np.frombuffer(raw, self.dtype).reshape(self.chunks)
            dst = tuple(slice(o, min(o + c, n))
                        for o, c, n in zip(offset, self.chunks, self.shape))
            src = tuple(slice(0, s.stop - s.start) for s in dst)
            out[dst] = chunk[src]
        return out

    def _chunk_entries(self, addr: int, ndims: int):
        """(offset, stored size, filter mask, address) of every chunk under
        the chunk B-tree node at ``addr`` (children followed, not sibling
        links)."""
        key = 8 + 8 * ndims
        node = self.file._btree_node(addr, 1, key)
        level, used, data = node
        for i in range(used):
            k = 24 + i * (key + 8)
            child = _u(data, k + key, 8)
            if level:
                yield from self._chunk_entries(child, ndims)
            else:
                offset = tuple(_u(data, k + 8 + 8 * d, 8)
                               for d in range(ndims - 1))
                yield offset, _u(data, k, 4), _u(data, k + 4, 4), child


class Group:
    """An h5py-style group: ``g[name]`` (``"a/b"`` paths too), ``keys()``
    and ``len``."""

    def __init__(self, file: "File", name: str, msgs: _Messages):
        self.file, self.name = file, name
        body = msgs.get(MSG_SYMBOL_TABLE)
        if body is None:
            kind = ("link-message (new-style) group"
                    if msgs.get(MSG_LINK_INFO) is not None
                    or msgs.get(MSG_LINK) is not None else "object")
            raise H5FormatError(f"{name}: {kind} without a symbol table")
        btree, heap = _u(body, 0, 8), _u(body, 8, 8)
        names = file._heap(heap)
        self._links: Dict[str, int] = {}
        for name_off, header in file._symbols(btree):
            self._links[names(name_off)] = header

    def keys(self) -> List[str]:
        return sorted(self._links)

    def __len__(self) -> int:
        return len(self._links)

    def __getitem__(self, path: str):
        head, _, rest = path.strip("/").partition("/")
        if head not in self._links:
            raise KeyError(f"{head!r} not in group {self.name!r}")
        full = (self.name.rstrip("/") + "/" + head)
        obj = self.file._object(self._links[head], full)
        return obj[rest] if rest else obj


class File(Group):
    """An HDF5 file opened for reading: ``File(path)[synsetid][split][...]``.
    Usable as a context manager, like ``h5py.File(path, "r")``."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._fh = open(self.path, "rb")
        try:
            self.base = self._find_superblock()
            self._r = _Reader(self._fh, self.base)
            sb = self._r.read(0, 24)
            version = sb[8]
            if version not in (0, 1):
                raise H5FormatError(
                    f"superblock version {version} (files written with "
                    "libver='latest' or another libver above 'earliest')")
            if sb[13] != 8 or sb[14] != 8:
                raise H5FormatError(f"{sb[13]}-byte offsets, {sb[14]}-byte "
                                    "lengths (supported: 8 and 8)")
            p = 24 + (4 if version == 1 else 0)
            rest = self._r.read(p, 32 + 40)
            root_header = _u(rest, 32 + 8, 8)
            super().__init__(self, "/", _Messages(self._r, root_header))
        except BaseException:
            self._fh.close()
            raise

    def _find_superblock(self) -> int:
        size = os.fstat(self._fh.fileno()).st_size
        at = 0
        while at + 8 <= size:
            self._fh.seek(at)
            if self._fh.read(8) == SIGNATURE:
                return at
            at = 512 if at == 0 else at * 2
        raise H5FormatError(f"{self.path}: no HDF5 signature")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- structures shared by groups and datasets
    def _object(self, header: int, name: str):
        msgs = _Messages(self._r, header)
        if msgs.get(MSG_LAYOUT) is not None:
            return Dataset(self, name, msgs)
        return Group(self, name, msgs)

    def _btree_node(self, addr: int, node_type: int, key: int):
        """``(level, entries used, node bytes)`` of a version-1 B-tree
        node; only the used entries are read."""
        head = self._r.read(addr, 24)
        if head[:4] != b"TREE":
            raise H5FormatError(f"no B-tree node at address {addr}")
        if head[4] != node_type:
            raise H5FormatError(f"B-tree node type {head[4]} at {addr}, "
                                f"{node_type} expected")
        used = _u(head, 6, 2)
        return head[5], used, self._r.read(addr, 24 + used * (key + 8) + key)

    def _symbols(self, addr: int):
        """(name offset, object header address) of every entry under the
        group B-tree node at ``addr``."""
        level, used, data = self._btree_node(addr, 0, 8)
        for i in range(used):
            child = _u(data, 24 + i * 16 + 8, 8)
            if level:
                yield from self._symbols(child)
                continue
            head = self._r.read(child, 8)
            if head[:4] != b"SNOD":
                raise H5FormatError(f"no symbol table node at {child}")
            n = _u(head, 6, 2)
            entries = self._r.read(child + 8, 40 * n)
            for j in range(n):
                e = entries[40 * j:40 * j + 40]
                if _u(e, 16, 4) == 2:
                    raise H5FormatError("soft link in a symbol table")
                yield _u(e, 0, 8), _u(e, 8, 8)

    def _heap(self, addr: int):
        head = self._r.read(addr, 32)
        if head[:4] != b"HEAP" or head[4] != 0:
            raise H5FormatError(f"no version-0 local heap at {addr}")
        data = self._r.read(_u(head, 24, 8), _u(head, 8, 8))

        def name(off: int) -> str:
            end = data.index(b"\0", off)
            return data[off:end].decode("utf-8")
        return name
