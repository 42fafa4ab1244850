"""Baseline JPEG reading and writing for the BOP loader, without OpenCV.

The JAX package reads pbr frames and VOC backgrounds with `cv2.imread`
(libjpeg-turbo). The card's machine has no OpenCV, so the port decodes them
in C++ (`native/jpeg.cpp`, built by g++ at first use into
`build/suo_native/libjpeg.so` through `data/native.py`; a failed build
raises). `imread(path, flags)` returns what `cv2.imread` returns:

- `IMREAD_COLOR` (the default): [H, W, 3] uint8 BGR; a gray file's one
  channel copied into all three;
- `IMREAD_GRAYSCALE`: [H, W] uint8, for a 1-component file only;

after an EXIF Orientation of 2-8 is applied (OpenCV's flips and
transposes). The decoder reproduces libjpeg's integer IDCT, fancy
upsampling and colour tables; files it does not take (progressive,
arithmetic, lossless, 12-bit, CMYK or RGB colour space, multi-scan) raise
ValueError naming the file and the marker.

`encode(img, quality, subsampling, restart_interval)` / `imwrite` write a
baseline JPEG in numpy: the Annex K quantization tables scaled by libjpeg's
quality formula, the standard Huffman tables, 4:4:4 or 4:2:0 (gray for a
2-D image), integer colour conversion and DCT (libjpeg's `islow`), so the
bytes depend only on the pixels and the settings. It writes fixtures (the
tests, chip_smoke on the card); no CLI uses it.

No torch here: the process loader's workers decode with it.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading

import numpy as np

from . import native

IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1

SOURCE = native.NATIVE_DIR / "jpeg.cpp"
BUILD_DIR = native.BUILD_DIR

_LIB = None
_LIB_LOCK = threading.Lock()


def load_library():
    """The decoder's ctypes library, built first if missing or stale (call it
    in a parent before worker processes start, so they do not race to
    build)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(native.build_library(SOURCE, BUILD_DIR)))
            lib.jpg_info.restype = ctypes.c_int
            lib.jpg_info.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
                                     ctypes.c_int]
            lib.jpg_decode.restype = ctypes.c_int
            lib.jpg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
            _LIB = lib
        return _LIB


def is_jpeg(data: bytes) -> bool:
    return data[:2] == b"\xff\xd8"


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's EXIF transform (`ExifTransform`) for orientations 2-8."""
    t = lambda a: a.swapaxes(0, 1)  # noqa: E731
    ops = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: t, 6: lambda a: t(a)[:, ::-1], 7: lambda a: t(a[::-1, ::-1]),
           8: lambda a: t(a)[::-1]}
    op = ops.get(int(orientation))
    return img if op is None else np.ascontiguousarray(op(img))


def decode(data: bytes, flags: int = IMREAD_COLOR, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> the array `cv2.imdecode(data, flags)` returns (see the
    module docstring)."""
    lib = load_library()
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    info = (ctypes.c_int32 * 4)()
    if lib.jpg_info(data, len(data), info, err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    h, w, ncomp, orientation = info
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise ValueError(f"{name}: imread flags {flags} are not supported for JPEG")
    if flags == IMREAD_GRAYSCALE and ncomp != 1:
        raise ValueError(f"{name}: IMREAD_GRAYSCALE of a {ncomp}-component JPEG is not "
                         "supported")
    out = np.empty((h, w) if ncomp == 1 else (h, w, 3), np.uint8)
    if lib.jpg_decode(data, len(data), out.ctypes.data, out.nbytes, err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    if flags == IMREAD_COLOR and ncomp == 1:
        out = np.repeat(out[..., None], 3, axis=-1)
    return _orient(out, orientation)


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """Read a JPEG file as `cv2.imread(path, flags)` does (module docstring)."""
    with open(path, "rb") as f:
        return decode(f.read(), flags, name=str(path))


# ---------------------------------------------------------------- writer ---
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# ITU-T T.81 Annex K.1, natural order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
    56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81,
    104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99,
    99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)

# Annex K.3 standard Huffman tables: (counts of lengths 1-16, symbols)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
    0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3,
    0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8,
    0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
    0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18,
    0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA,
    0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7,
    0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def _huff_codes(table):
    """Canonical codes of a (counts, symbols) table -> (code [256], length
    [256]) indexed by symbol."""
    counts, symbols = table
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's `jpeg_quality_scaling` and `jpeg_add_quant_table` with
    force_baseline: natural order, values in [1, 255]."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


_FIX = lambda x: int(x * 65536 + 0.5)  # noqa: E731


def _ycc(bgr: np.ndarray):
    """libjpeg's fixed-point RGB -> YCbCr (jccolor.c), int64 planes."""
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_FIX(0.299) * r + _FIX(0.587) * g + _FIX(0.114) * b + half) >> 16
    cb = (-_FIX(0.16874) * r - _FIX(0.33126) * g + _FIX(0.5) * b + off + half - 1) >> 16
    cr = (_FIX(0.5) * r - _FIX(0.41869) * g - _FIX(0.08131) * b + off + half - 1) >> 16
    return y, cb, cr


_C = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373, c1175=9633,
          c1501=12299, c1847=15137, c1961=16069, c2053=16819, c2562=20995, c3072=25172)


def _fdct_pass(d, out_shift_even, desc):
    """One pass of libjpeg's `jpeg_fdct_islow` along the last axis of
    d [..., 8] (int64)."""
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o = np.empty_like(d)
    o[..., 0] = out_shift_even(t10 + t11)
    o[..., 4] = out_shift_even(t10 - t11)
    z1 = (t12 + t13) * _C["c0541"]
    o[..., 2] = desc(z1 + t13 * _C["c0765"])
    o[..., 6] = desc(z1 - t12 * _C["c1847"])
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * _C["c1175"]
    t4, t5, t6, t7 = t4 * _C["c0298"], t5 * _C["c2053"], t6 * _C["c3072"], t7 * _C["c1501"]
    z1, z2 = z1 * -_C["c0899"], z2 * -_C["c2562"]
    z3, z4 = z3 * -_C["c1961"] + z5, z4 * -_C["c0390"] + z5
    o[..., 7] = desc(t4 + z1 + z3)
    o[..., 5] = desc(t5 + z2 + z4)
    o[..., 3] = desc(t6 + z2 + z3)
    o[..., 1] = desc(t7 + z1 + z4)
    return o


def _fdct(blocks: np.ndarray) -> np.ndarray:
    """[N, 8, 8] level-shifted samples -> [N, 8, 8] DCT coefficients x 8."""
    d = blocks.astype(np.int64)
    d = _fdct_pass(d, lambda x: x << 2, lambda x: (x + (1 << 10)) >> 11)
    d = _fdct_pass(d.swapaxes(1, 2), lambda x: (x + 2) >> 2,
                   lambda x: (x + (1 << 14)) >> 15)
    return d.swapaxes(1, 2)


def _quantize(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's rounding division by 8 q: [N, 64] natural order."""
    qv = (qt * 8)[None, :]
    mag = (np.abs(coef) + (qv >> 1)) // qv
    return np.where(coef < 0, -mag, mag)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] (multiples of 8) -> [H/8, W/8, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2)


def _bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate big-endian codes, pad with 1s to a byte, stuff 0xFF."""
    total = int(lengths.sum())
    if total == 0:
        return b""
    starts = np.cumsum(lengths) - lengths
    item = np.repeat(np.arange(len(values)), lengths)
    j = np.arange(total) - starts[item]
    bits = (values[item] >> (lengths[item] - 1 - j)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    reps = np.where(data == 0xFF, 2, 1)
    out = np.repeat(data, reps)
    out[np.cumsum(reps)[data == 0xFF] - 1] = 0  # the stuffed zero after each 0xFF
    return out.tobytes()


def _category(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (the JPEG magnitude category)."""
    a = np.abs(v)
    s = np.zeros_like(a)
    while np.any(a > 0):
        s += a > 0
        a >>= 1
    return s


def _entropy(zz: np.ndarray, comp: np.ndarray, tables, mcu_of: np.ndarray, restart_interval: int) -> bytes:
    """Huffman-code blocks zz [N, 64] (zigzag, emission order) whose
    component indices are comp [N] (0 luma, 1-2 chroma)."""
    n = len(zz)
    # DC differences, the predictors reset at each restart interval
    dc = zz[:, 0]
    seg = mcu_of // restart_interval if restart_interval else np.zeros(n, np.int64)
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        sel = np.nonzero(comp == c)[0]
        prev = np.concatenate([[0], dc[sel][:-1]])
        first = np.concatenate([[True], seg[sel][1:] != seg[sel][:-1]])
        diff[sel] = dc[sel] - np.where(first, 0, prev)
    chroma = comp > 0
    dcc = [tables["dc"][0], tables["dc"][1]]
    acc = [tables["ac"][0], tables["ac"][1]]
    keys, vals, lens = [], [], []

    def emit(key, sym, tab_idx, which, extra, nextra):
        code = np.where(tab_idx, which[1][0][sym], which[0][0][sym])
        clen = np.where(tab_idx, which[1][1][sym], which[0][1][sym])
        keys.append(key)
        vals.append((code << nextra) | (extra & ((1 << nextra) - 1)))
        lens.append(clen + nextra)

    s = _category(diff)
    emit(np.arange(n) * 4096, s, chroma, dcc, np.where(diff < 0, diff - 1, diff), s)
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    prev_k = np.zeros_like(k)
    prev_k[1:] = np.where(b[1:] == b[:-1], k[:-1], 0)
    run = k - prev_k - 1
    nzrl = run // 16
    for z in range(3):
        sel = nzrl > z
        bb = b[sel]
        emit(bb * 4096 + k[sel] * 32 + z, np.full(len(bb), 0xF0), chroma[bb], acc,
             np.zeros(len(bb), np.int64), np.zeros(len(bb), np.int64))
    sv = _category(v)
    emit(b * 4096 + k * 32 + 4, (run % 16) * 16 + sv, chroma[b], acc,
         np.where(v < 0, v - 1, v), sv)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < 63)[0]
    emit(eob * 4096 + 64 * 32, np.zeros(len(eob), np.int64), chroma[eob], acc,
         np.zeros(len(eob), np.int64), np.zeros(len(eob), np.int64))
    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")
    val = np.concatenate(vals)[order]
    ln = np.concatenate(lens)[order]
    if not restart_interval:
        return _bits(val, ln)
    item_seg = seg[np.concatenate(keys)[order] // 4096]
    out = []
    bounds = np.searchsorted(item_seg, np.arange(int(seg.max()) + 2))
    for i in range(int(seg.max()) + 1):
        a, z = bounds[i], bounds[i + 1]
        out.append(_bits(val[a:z], ln[a:z]))
        if i < int(seg.max()):
            out.append(bytes([0xFF, 0xD0 + i % 8]))
    return b"".join(out)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _dht(tc: int, th: int, table) -> bytes:
    counts, symbols = table
    return bytes([tc << 4 | th] + list(counts) + list(symbols))


def encode(img: np.ndarray, quality: int = 95, subsampling: str = "4:2:0",
           restart_interval: int = 0) -> bytes:
    """[H, W, 3] uint8 BGR (or [H, W] gray) -> baseline JFIF JPEG bytes.
    subsampling "4:2:0" or "4:4:4" (ignored for gray); restart_interval in
    MCUs (0: none)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"JPEG: cannot write a {img.dtype} image of shape {img.shape}")
    if subsampling not in ("4:2:0", "4:4:4"):
        raise ValueError(f"JPEG: subsampling {subsampling!r} (4:2:0 or 4:4:4)")
    h, w = img.shape[:2]
    gray = img.ndim == 2
    f = 1 if gray or subsampling == "4:4:4" else 2
    mh, mw = 8 * f, 8 * f
    mcuy, mcux = -(-h // mh), -(-w // mw)
    pad = ((0, mcuy * mh - h), (0, mcux * mw - w)) + (((0, 0),) if not gray else ())
    full = np.pad(img, pad, mode="edge")
    if gray:
        planes = [full.astype(np.int64)]
    else:
        y, cb, cr = _ycc(full)
        if f == 2:  # libjpeg's h2v2 downsampling, biases 1, 2 alternating
            bias = np.tile([1, 2], cb.shape[1] // 2)[: cb.shape[1] // 2]
            cb, cr = ((p.reshape(mcuy * 8, 2, mcux * 8, 2).sum((1, 3)) + bias) >> 2
                      for p in (cb, cr))
        planes = [y, cb, cr]
    qts = [quant_table(_LUMA_Q, quality), quant_table(_CHROMA_Q, quality)]
    zz_parts, comp_parts, mcu_parts = [], [], []
    for ci, p in enumerate(planes):
        blk = _blocks(p - 128)  # [by, bx, 8, 8]
        hf = f if ci == 0 else 1
        coef = _fdct(blk.reshape(-1, 8, 8)).reshape(-1, 64)
        q = _quantize(coef, qts[min(ci, 1)])[:, _ZIGZAG]
        q = q.reshape(mcuy, hf, mcux, hf, 64).transpose(0, 2, 1, 3, 4)  # MCU, then (v, h)
        zz_parts.append(q.reshape(mcuy * mcux, hf * hf, 64))
        comp_parts.append(np.full((mcuy * mcux, hf * hf), ci))
        mcu_parts.append(np.broadcast_to(np.arange(mcuy * mcux)[:, None],
                                         (mcuy * mcux, hf * hf)))
    zz = np.concatenate(zz_parts, axis=1).reshape(-1, 64)
    comp = np.concatenate(comp_parts, axis=1).reshape(-1)
    mcu_of = np.concatenate(mcu_parts, axis=1).reshape(-1)
    tables = {"dc": [_huff_codes(_DC_LUMA), _huff_codes(_DC_CHROMA)],
              "ac": [_huff_codes(_AC_LUMA), _huff_codes(_AC_CHROMA)]}
    data = _entropy(zz, comp, tables, mcu_of, int(restart_interval))

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    nq = 1 if gray else 2
    out.append(_segment(0xDB, b"".join(bytes([t]) + bytes(qts[t][_ZIGZAG].tolist())
                                       for t in range(nq))))
    ncomp = 1 if gray else 3
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([ncomp])
    for ci in range(ncomp):
        hv = (f << 4 | f) if ci == 0 else 0x11
        sof += bytes([ci + 1, hv, min(ci, 1)])
    out.append(_segment(0xC0, sof))
    dht = _dht(0, 0, _DC_LUMA) + _dht(1, 0, _AC_LUMA)
    if not gray:
        dht += _dht(0, 1, _DC_CHROMA) + _dht(1, 1, _AC_CHROMA)
    out.append(_segment(0xC4, dht))
    if restart_interval:
        out.append(_segment(0xDD, int(restart_interval).to_bytes(2, "big")))
    sos = bytes([ncomp])
    for ci in range(ncomp):
        sos += bytes([ci + 1, 0x00 if ci == 0 else 0x11])
    out.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    out.append(data)
    out.append(b"\xff\xd9")
    return b"".join(out)


def imwrite(path: str, img: np.ndarray, quality: int = 95, subsampling: str = "4:2:0",
            restart_interval: int = 0) -> None:
    """Write `encode(img, ...)` to `path`."""
    with open(path, "wb") as f:
        f.write(encode(img, quality, subsampling, restart_interval))


# ------------------------------------------------------ the pinned check ---
def check_images():
    """Four seeded images and the settings each is encoded with: smooth
    gradients plus noise, 4:2:0 and 4:4:4 at qualities 90 and 95, sizes that
    are no multiple of 16. -> [(name, bgr [H, W, 3] uint8, quality,
    subsampling)]"""
    cases = []
    for i, (q, sub, (h, w)) in enumerate([(90, "4:2:0", (61, 83)), (95, "4:2:0", (48, 64)),
                                          (90, "4:4:4", (37, 50)), (95, "4:4:4", (72, 41))]):
        rng = np.random.default_rng(1000 + i)
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([(xx * 255) // max(1, w - 1), (yy * 255) // max(1, h - 1),
                         ((xx + yy) * 127) // max(1, h + w - 2)], -1)
        img = np.clip(base + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)
        cases.append((f"check{i}_q{q}_{sub.replace(':', '')}", img, q, sub))
    return cases


CHECK_SHA256 = {
    "check0_q90_420": "604749e84ebf01fee2a748115c8cd6a11b3d38e0cc9911d9d86f90297d67c88c",
    "check1_q95_420": "16eb49a85b7f661d76eca4176b8d2630382784c4451cc99d0c313babe37863d1",
    "check2_q90_444": "95e18263be46d14e72d817684e1d62efd77c95a787e2e2911a9c5c20d5ba1451",
    "check3_q95_444": "742ab912d025bcd159012d2ae8eecc34076fb8f41700a6ccc43cf0169e1213d4",
}


def check_digests() -> dict:
    """SHA-256 of the decoder's output on each of `check_images` after
    `encode`: the CPU tests pin these against `cv2.imread`, chip_smoke holds
    the card machine's build to them."""
    return {name: hashlib.sha256(decode(encode(img, q, sub)).tobytes()).hexdigest()
            for name, img, q, sub in check_images()}
