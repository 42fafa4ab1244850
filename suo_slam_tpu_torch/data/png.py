"""PNG reading for the BOP loader, on `zlib` and numpy.

The JAX package's loader reads images with `cv2.imread`; the port reads BOP's
PNG files itself so that it needs no OpenCV. `imread(path, flags)` returns
what `cv2.imread` returns for the reads the loader makes:

- 8-bit RGB with `IMREAD_COLOR` (the default): [H, W, 3] uint8 in BGR order;
- 8-bit gray with `IMREAD_GRAYSCALE`: [H, W] uint8 (the masks);
- 8- or 16-bit gray with `IMREAD_ANYDEPTH`: [H, W] uint8 or uint16 (depth
  maps, big-endian in the file).

Non-interlaced images only, with any of the five row filters. Other formats
and reads (palette, alpha, interlaced, 16-bit colour, conversions between
gray and colour) raise ValueError.

`imwrite(path, img)` writes what `cv2.imwrite` takes for those reads: an
[H, W, 3] uint8 BGR image as 8-bit RGB, an [H, W] uint8 or uint16 image as
8- or 16-bit gray (`encode` takes the file's channel order); rows unfiltered,
zlib level 6.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1
IMREAD_ANYDEPTH = 2

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filt: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Reverse the PNG row filters. filt [H, stride] uint8 filtered bytes,
    ftype [H] filter types, bpp bytes per pixel -> [H, stride] uint8."""
    h, stride = filt.shape
    w = stride // bpp
    f = filt.reshape(h, w, bpp).astype(np.int32)
    if np.any(ftype > 4):
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    if not np.isin(ftype, (3, 4)).any():
        # None / Sub / Up only: each row is one vectorized step
        out = np.empty_like(f)
        prev = np.zeros((w, bpp), np.int32)
        for r in range(h):
            t = ftype[r]
            row = f[r]
            if t == 1:
                row = np.cumsum(row, axis=0)
            elif t == 2:
                row = row + prev
            prev = out[r] = row & 255
        return out.reshape(h, stride).astype(np.uint8)
    # Average / Paeth depend on the left, upper and upper-left pixels: sweep
    # the anti-diagonals r + x = d, whose pixels depend only on the two
    # previous diagonals, over a copy padded with a zero row and column
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)
    t_all = ftype.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - (w - 1)), min(h - 1, d) + 1)
        x = d - r
        a = rec[r + 1, x]
        b = rec[r, x + 1]
        c = rec[r, x]
        t = t_all[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[r + 1, x + 1] = (f[r, x] + pred) & 255
    return rec[1:, 1:].reshape(h, stride).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W] (gray) or [H, W, 3] (RGB, file order) array,
    uint8 or uint16."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG: missing IHDR or IDAT")
    w, h, depth, color, _, _, interlace = ihdr
    if interlace:
        raise ValueError("PNG: interlaced images are not supported")
    if color not in (0, 2) or depth not in (8, 16):
        raise ValueError(f"PNG: colour type {color} at {depth} bits is not supported "
                         "(8/16-bit gray or RGB only)")
    ch = 1 if color == 0 else 3
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError("PNG: image data has the wrong size")
    rows = raw.reshape(h, w * bpp + 1)
    rec = _unfilter(rows[:, 1:], rows[:, 0], bpp)
    if depth == 16:
        img = rec.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = rec.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode(img: np.ndarray) -> bytes:
    """[H, W] uint8 / uint16 gray or [H, W, 3] uint8 RGB (file order) ->
    PNG bytes."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 3 and img.dtype == np.uint8:
        color, depth = 2, 8
    elif img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        color, depth = 0, 8 * img.dtype.itemsize
    else:
        raise ValueError(f"PNG: cannot write a {img.dtype} image of shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img, ">u2" if depth == 16 else np.uint8).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1)
    return (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray) -> None:
    """Write a PNG file as `cv2.imwrite(path, img)` does for the images the
    module docstring lists (3 channels in BGR order)."""
    img = np.asarray(img)
    with open(path, "wb") as f:
        f.write(encode(img[..., ::-1] if img.ndim == 3 else img))


def is_png(data: bytes) -> bool:
    return data[:8] == _SIGNATURE


def imdecode(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """PNG bytes as `cv2.imdecode(data, flags)` returns them (see the module
    docstring for the reads supported)."""
    img = decode(data)
    if flags == IMREAD_COLOR and img.ndim == 3 and img.dtype == np.uint8:
        return np.ascontiguousarray(img[..., ::-1])
    if img.ndim == 2 and (flags == IMREAD_ANYDEPTH
                          or (flags == IMREAD_GRAYSCALE and img.dtype == np.uint8)):
        return img
    raise ValueError(f"PNG: flags {flags} on a {'gray' if img.ndim == 2 else 'colour'} "
                     f"{img.dtype} image are not supported")


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """Read a PNG file as `cv2.imread(path, flags)` returns it (see the
    module docstring for the reads supported)."""
    with open(path, "rb") as f:
        return imdecode(f.read(), flags)
