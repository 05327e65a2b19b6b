"""The msgpack subset that ``flax.serialization`` writes, read and written
without the msgpack package (the port's counterpart of
``flax.serialization.msgpack_serialize``/``msgpack_restore``).

Values: maps (string keys), arrays, str, bin, int, float, bool and nil;
ext type 1, an array as the packed ``(shape, dtype name, C-order bytes)``;
ext type 3, a numpy scalar in the same form; and flax's chunked arrays
(``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` for
an array over ``MAX_CHUNK_SIZE`` bytes, split into flat pieces).

:func:`unpackb` decodes arrays to numpy, except ``bfloat16`` ones, which
numpy lacks: those become ``torch.bfloat16`` tensors. :func:`packb`
encodes numpy arrays and scalars and torch tensors (any device; bfloat16
included) and, like flax, writes tuples as arrays only inside an array's
header (a tree to save holds dicts, not tuples).
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30      # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ encode
def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack("b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)),
                               (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit 64 bits")


def _sized(n: int, fix: int, fix_max: int, codes) -> bytes:
    """Header of a str/bin/array/map of ``n`` elements or bytes."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in codes:
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} elements or bytes in one msgpack value")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARR = ((None, "", 0), (0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((None, "", 0), (0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _raw(x) -> Tuple[Tuple[int, ...], str, bytes]:
    """(shape, dtype name, C-order bytes) of an array or tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy(
                ).tobytes()
        x = t.numpy()
    x = np.asarray(x)
    if x.dtype.hasobject or x.dtype.fields is not None:
        raise ValueError("object and structured dtypes are not serialised")
    return x.shape, x.dtype.name, np.ascontiguousarray(x).tobytes()


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    if n in _FIXEXT:
        return bytes([_FIXEXT[n], code]) + payload
    return _sized(n, None, 0, _EXT) + bytes([code]) + payload


def _encode(x, out: List[bytes]) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, np.generic):     # before float: np.float64 is one
        out.append(_ext(EXT_NPSCALAR, packb(_raw(np.asarray(x)))))
    elif isinstance(x, int):
        out.append(_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        b = x.encode("utf-8")
        out.append(_sized(len(b), 0xA0, 31, _STR) + b)
    elif isinstance(x, (bytes, bytearray)):
        out.append(_sized(len(x), None, 0, _BIN) + bytes(x))
    elif isinstance(x, dict):
        out.append(_sized(len(x), 0x80, 15, _MAP))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r} is not a string")
            _encode(k, out)
            _encode(v, out)
    elif isinstance(x, (list, tuple)):
        out.append(_sized(len(x), 0x90, 15, _ARR))
        for v in x:
            _encode(v, out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        out.append(_ext(EXT_NDARRAY, packb(_raw(x))))
    else:
        raise TypeError(f"cannot serialise {type(x).__name__}")


def _chunk_leaves(x):
    """flax's ``_chunk_array_leaves_in_place`` on a copy of the dicts, keys
    sorted as flax's copy (``jax.tree_util.tree_map``) sorts them."""
    if isinstance(x, dict):
        return {k: _chunk_leaves(x[k]) for k in sorted(x)}
    if isinstance(x, (np.ndarray, torch.Tensor)):
        nbytes = x.numel() * x.element_size() if isinstance(
            x, torch.Tensor) else x.nbytes
        if nbytes > MAX_CHUNK_SIZE:
            flat = x.reshape(-1)
            itemsize = nbytes // max(flat.shape[0], 1)
            step = max(1, MAX_CHUNK_SIZE // itemsize)
            pieces = [flat[i:i + step] for i in range(0, flat.shape[0], step)]
            return {CHUNKED: True,
                    "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
                    "chunks": {str(i): p for i, p in enumerate(pieces)}}
    return x


def packb(tree) -> bytes:
    """msgpack bytes of ``tree``, map keys sorted and arrays over
    ``MAX_CHUNK_SIZE`` bytes chunked as ``flax.serialization.
    msgpack_serialize`` writes them."""
    out: List[bytes] = []
    _encode(_chunk_leaves(tree), out)
    return b"".join(out)


# ------------------------------------------------------------------ decode
class _Decoder:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
                0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte {b:#04x} is not used")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.take(1)[0]
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not used")
        arr = _array(payload)
        if code == EXT_NPSCALAR:
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        return arr


def _array(payload: bytes):
    shape, name, buf = _Decoder(payload).value()
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        t = torch.frombuffer(bytearray(buf), dtype=torch.int16)
        return t.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk_leaves(x):
    if isinstance(x, dict):
        if CHUNKED in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            pieces = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            if isinstance(pieces[0], torch.Tensor):
                return torch.cat(pieces).reshape(shape)
            return np.concatenate(pieces).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in x.items()}
    return x


def unpackb(data: bytes) -> Any:
    """The tree in ``data``, chunked arrays joined."""
    dec = _Decoder(data)
    out = dec.value()
    if dec.pos != len(dec.data):
        raise ValueError("trailing bytes after the msgpack value")
    return _unchunk_leaves(out)
