"""The flax msgpack checkpoint format, in numpy alone.

`flax.serialization.to_bytes` / `msgpack_restore` write and read a tree of
dicts (string keys), strings, numbers and arrays as msgpack
(github.com/msgpack/msgpack/blob/master/spec.md): a numpy array is an
extension of type 1 whose payload is itself the msgpack array
[shape, dtype name, C-order bytes] (a numpy scalar: type 3, the same
payload). Dicts keep their insertion order, as flax packs them, so a tree
packs to the same bytes as `to_bytes` of the same tree. flax splits an array over 2^30 bytes into a
`__msgpack_chunked_array__` dict; `unpackb` joins one, `packb` raises
instead of writing one (a PkpNet's largest tensor is 2.4 MB).
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30


def _int(x: int) -> bytes:
    if 0 <= x < 128:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack("b", x)
    if x >= 0:
        for lim, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                               (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
            if x < lim:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for lim, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                               (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q")):
            if x >= -lim:
                return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError(f"integer {x} does not fit msgpack")


def _len(n: int, fix: int | None, fix_max: int, codes: tuple) -> bytes:
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for lim, code, fmt in zip((1 << 8, 1 << 16, 1 << 32), codes, (">B", ">H", ">I")):
        if code is not None and n < lim:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _len(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _bin(b: bytes) -> bytes:
    return _len(len(b), None, -1, (0xC4, 0xC5, 0xC6)) + b


def _ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        return bytes([fixed[len(data)], code]) + data
    return _len(len(data), None, -1, (0xC7, 0xC8, 0xC9)) + bytes([code]) + data


def _ndarray_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError(f"cannot serialize dtype {a.dtype}")
    return _pack((tuple(int(d) for d in a.shape), a.dtype.name, a.tobytes("C")))


def _pack(x) -> bytes:
    if x is None:
        return b"\xc0"
    if x is True:
        return b"\xc3"
    if x is False:
        return b"\xc2"
    if type(x) is int:
        return _int(x)
    if type(x) is float:
        return b"\xcb" + struct.pack(">d", x)
    if type(x) is str:
        return _str(x)
    if type(x) is bytes:
        return _bin(x)
    if type(x) in (list, tuple):
        return _len(len(x), 0x90, 15, (None, 0xDC, 0xDD)) + b"".join(_pack(v) for v in x)
    if type(x) is dict:
        return _len(len(x), 0x80, 15, (None, 0xDE, 0xDF)) + b"".join(
            _str(k) + _pack(v) for k, v in x.items())
    if isinstance(x, np.ndarray):
        if x.nbytes > MAX_CHUNK_SIZE:
            raise ValueError(f"array of {x.nbytes} bytes: flax would chunk it; not written")
        return _ext(EXT_NDARRAY, _ndarray_payload(x))
    if isinstance(x, np.generic):
        return _ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    raise TypeError(f"cannot serialize {type(x).__name__}")


def packb(tree) -> bytes:
    """msgpack bytes of a tree of dicts (str keys), lists, tuples, str,
    bytes, int, float, bool, None, numpy arrays and scalars: those of
    `flax.serialization.to_bytes` for the same tree."""
    return _pack(tree)


class _Reader:
    def __init__(self, data: bytes):
        self.b = memoryview(data)
        self.i = 0

    def take(self, n: int) -> memoryview:
        if self.i + n > len(self.b):
            raise ValueError("truncated msgpack data")
        out = self.b[self.i:self.i + n]
        self.i += n
        return out

    def u(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0xA0 <= c <= 0xBF:
            return str(self.take(c & 0x1F), "utf-8")
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            return self.u(ints[c])
        sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                 0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in sizes:
            n = self.u(sizes[c])
            if c in (0xD9, 0xDA, 0xDB):
                return str(self.take(n), "utf-8")
            if c in (0xC4, 0xC5, 0xC6):
                return bytes(self.take(n))
            if c in (0xDC, 0xDD):
                return [self.obj() for _ in range(n)]
            if c in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(n)
        if c in fixext:
            return self.ext(fixext[c])
        raise ValueError(f"unknown msgpack type byte 0x{c:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.take(1)[0]
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack extension type {code}")
        shape, name, buf = _Reader(data).obj()
        name = name.decode() if isinstance(name, bytes) else name
        if name == "bfloat16":
            raise ValueError("bfloat16 arrays need ml_dtypes; the JAX package saves f32")
        a = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()
        return a[()] if code == EXT_NPSCALAR else a


def _unchunk(x):
    if isinstance(x, dict):
        if "__msgpack_chunked_array__" in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in x.items()}
    return x


def unpackb(data: bytes):
    """The tree `flax.serialization.msgpack_restore` returns for `data`:
    dicts, lists, str, int, float, numpy arrays (writable copies)."""
    r = _Reader(data)
    out = r.obj()
    if r.i != len(r.b):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(out)
