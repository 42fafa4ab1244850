"""OpenCV's drawing calls that `eval/viz.py` makes, in numpy.

The port draws without OpenCV: these functions give OpenCV 5.0's pixels,
bit for bit, at the arguments the visualization passes, on `uint8` BGR
images of shape [H, W, 3], drawing in place.

- `hsv2bgr_u8`: `cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)` on 8-bit input (the
  float32 arithmetic of OpenCV's `HSV2RGB_b`).
- `circle`: `cv2.circle(img, center, radius, color, -1)` (the integer
  midpoint circle of drawing.cpp's `Circle`, filled).
- `ellipse`: `cv2.ellipse(img, center, axes, angle, 0, 360, color, t)`:
  `ellipse2Poly`'s points (OpenCV's own sine table) in 16-bit fixed point,
  then at t = 2 the thick polyline: each segment a convex polygon
  (`FillConvexPoly`, its outline drawn by `Line2`) with round joins; at
  t = -1 (filled) one `FillConvexPoly` of the points.
- `rectangle`: `cv2.rectangle(img, pt1, pt2, color, t)`, t = 2 or 3, the
  same thick polyline, closed (an odd thickness widens the segments by half
  a pixel and rounds the joins up).
- `put_text`: `cv2.putText(img, text, org, font, scale, color, thickness)`
  for the three fonts of `FONTS`: FONT_HERSHEY_PLAIN 1.0 thickness 1,
  PLAIN 1.2 thickness 2 and FONT_HERSHEY_SIMPLEX 0.5 thickness 1, each at
  LINE_8 or LINE_AA (the same pixels in OpenCV 5.0). OpenCV 5.0 renders the
  Hershey font names with its built-in TrueType font: each glyph's 8-bit
  coverage `a` is blended over the image in turn as
  `(bg * (255 - a) + col * a + 127) // 255`, the glyphs at integer advances
  with no kerning. The coverage and the advances are tables read off OpenCV
  (`eval/_raster_tables.py`).

Clipping follows OpenCV's own (`clipLine` in fixed point, the scan
converter's row and column limits), so a primitive partly or wholly outside
the image draws what OpenCV draws.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ._raster_tables import (PLAIN_1_2_T2_GLYPHS, PLAIN_GLYPHS, SIMPLEX_0_5_GLYPHS,
                             SIN_QUARTER)

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1

_q = np.asarray(SIN_QUARTER, np.float32).astype(np.float64)
# OpenCV's SinTable: sin of 0..450 degrees
_SIN = tuple(np.concatenate([_q, _q[::-1][1:], -_q[1:], -_q[::-1][1:], _q[1:]]).tolist())
del _q


# ----------------------------------------------------------------- colour --
def _fma32(a, b, c):
    """float32 fused multiply-add: the product of two float32 values is
    exact in float64, and the sum rounds once more there (exact on every
    8-bit input of `hsv2bgr_u8`)."""
    return (a.astype(np.float64) * b.astype(np.float64) + np.float64(c)).astype(np.float32)


def hsv2bgr_u8(hsv):
    """`cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)` pixel by pixel, for uint8
    [..., 3] HSV (OpenCV's 8-bit hue range, 0..179): the arithmetic of
    `HSV2RGB_native` as OpenCV's build runs it on one pixel, its
    `1 - s * h` terms fused multiply-adds. (Rows that OpenCV converts in
    SIMD lanes may differ by one level; `bbox_color` converts one pixel.)"""
    hsv = np.asarray(hsv, np.uint8)
    f32 = np.float32
    inv255 = f32(1.0) / f32(255.0)
    h = hsv[..., 0].astype(f32) * (f32(6.0) / f32(180.0))
    s = hsv[..., 1].astype(f32) * inv255
    v = hsv[..., 2].astype(f32) * inv255
    h = np.fmod(h, f32(6.0))
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64)
    one = f32(1.0)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, h, one),
                    v * _fma32(-s, one - h, one)], -1)
    sector_data = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    bgr = np.take_along_axis(tab, sector_data[sector], -1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    return np.clip(np.rint(bgr * f32(255.0)), 0, 255).astype(np.uint8)


# ------------------------------------------------------------ primitives --
def _draw_runs(img, runs, color):
    """Set the pixels of `runs` [(row, x1, x2)], x1 <= x2, that lie inside
    the image to `color`. Every part of a primitive has the one colour, so
    the order in which OpenCV sets its pixels does not matter."""
    if not runs:
        return
    h, w = img.shape[:2]
    r = np.array(runs, np.int64)
    y, a, b = r[:, 0], np.maximum(r[:, 1], 0), np.minimum(r[:, 2], w - 1)
    ok = (y >= 0) & (y < h) & (a <= b)
    y, a, b = y[ok], a[ok], b[ok]
    n = b - a + 1
    first = np.cumsum(n) - n
    img[np.repeat(y, n), np.arange(int(n.sum())) - np.repeat(first - a, n)] = color


@functools.lru_cache(maxsize=None)
def _disc(radius):
    """Runs (dy, dx1, dx2) of drawing.cpp's filled `Circle` (its integer
    midpoint loop); each clipped run is the clip of its pixels."""
    runs = []
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        runs += [(-dy, -dx, dx), (dy, -dx, dx), (-dx, -dy, dy), (dx, -dy, dy)]
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return tuple(runs)


def _add_disc(runs, cx, cy, radius):
    runs += [(cy + dy, cx + a, cx + b) for dy, a, b in _disc(radius)]


def _clip_line(w, h, x1, y1, x2, y2):
    """drawing.cpp's `clipLine` on a (w, h) box (int64 coordinates); None
    when the line misses it."""
    if w <= 0 or h <= 0:
        return None
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _tdiv(a, b):
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _line2(runs, ws, hs, x1, y1, x2, y2):
    """drawing.cpp's `Line2`: the 8-connected line between two 16-bit
    fixed-point points, clipped to the image (`ws`, `hs`: its size in
    fixed point)."""
    if not (0 <= x1 < ws and 0 <= y1 < hs and 0 <= x2 < ws and 0 <= y2 < hs):
        clipped = _clip_line(ws, hs, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    add = runs.append
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        ax = x2 - x1
        step = _tdiv(dy << XY_SHIFT, ax | 1)
        x = (x1 + _HALF) >> XY_SHIFT
        t = y1 + _HALF
        row, start = t >> XY_SHIFT, x
        for _ in range(ax >> XY_SHIFT):
            t += step
            x += 1
            r = t >> XY_SHIFT
            if r != row:
                add((row, start, x - 1))
                row, start = r, x
        add((row, start, x))
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _tdiv(dx << XY_SHIFT, (y2 - y1) | 1)
        y = (y1 + _HALF) >> XY_SHIFT
        t = x1 + _HALF
        for k in range(((y2 - y1) >> XY_SHIFT) + 1):
            c = t >> XY_SHIFT
            add((y + k, c, c))
            t += step
    ex, ey = (x2 + _HALF) >> XY_SHIFT, (y2 + _HALF) >> XY_SHIFT
    add((ey, ex, ex))


def _fill_convex_poly(runs, w, h, v):
    """drawing.cpp's `FillConvexPoly` (LINE_8, shift XY_SHIFT) of the
    fixed-point points `v` [(x, y)]: the outline by `Line2`, then the
    scan fill."""
    ws, hs = w << XY_SHIFT, h << XY_SHIFT
    npts = len(v)
    p0 = v[-1]
    for p in v:
        _line2(runs, ws, hs, p0[0], p0[1], p[0], p[1])
        p0 = p
    vx = [p[0] for p in v]
    vy = [p[1] for p in v]
    ymin_raw = min(vy)
    imin = vy.index(ymin_raw)
    ymin = (ymin_raw + _HALF) >> XY_SHIFT
    ymax = (max(vy) + _HALF) >> XY_SHIFT
    if (npts < 3 or ((max(vx) + _HALF) >> XY_SHIFT) < 0 or ymax < 0
            or ((min(vx) + _HALF) >> XY_SHIFT) >= w or ymin >= h):
        return
    ymax = min(ymax, h - 1)
    vt = [(t + _HALF) >> XY_SHIFT for t in vy]  # each vertex's row
    # the two edges: [vertex, step, x, dx, last row]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = vt[idx]
                    if ty > y:
                        e[0], e[2], e[4] = idx, vx[idx0], ty
                        e[3] = _tdiv((vx[idx] - vx[idx0]) * 2 + (ty - y), 2 * (ty - y))
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
        if edges < 0:
            return
        # the rows until an edge ends: x advances by dx a row
        stop = min(edge[0][4], edge[1][4], ymax + 1)
        xa, da = edge[0][2], edge[0][3]
        xb, db = edge[1][2], edge[1][3]
        add = runs.append
        for yy in range(y, stop):
            if yy >= 0:
                lo, hi = (xb, xa) if xa > xb else (xa, xb)
                add((yy, (lo + _HALF) >> XY_SHIFT, (hi + _HALF) >> XY_SHIFT))
            xa += da
            xb += db
        edge[0][2], edge[1][2] = xa, xb
        if stop > ymax:
            return
        y = stop


def _thick_line(runs, w, h, p0, p1, flags, thickness):
    """drawing.cpp's `ThickLine` at a thickness above 1, LINE_8, for
    fixed-point points: the segment's polygon and, per `flags`, round caps
    (`Circle` of radius (thickness + 1) // 2) at its ends."""
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > 2.220446049250313e-16:  # DBL_EPSILON
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        _fill_convex_poly(runs, w, h, [
            (p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
            (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)])
    cap = (thickness + _HALF) >> XY_SHIFT
    if flags & 1:
        _add_disc(runs, (p0[0] + _HALF) >> XY_SHIFT, (p0[1] + _HALF) >> XY_SHIFT, cap)
    if flags & 2:
        _add_disc(runs, (p1[0] + _HALF) >> XY_SHIFT, (p1[1] + _HALF) >> XY_SHIFT, cap)


def _polyline(img, pts, closed, color, thickness):
    """drawing.cpp's `PolyLine` at a thickness above 1 over fixed-point
    points."""
    h, w = img.shape[:2]
    runs = []
    p0 = pts[-1] if closed else pts[0]
    flags = 2 if closed else 3
    for p in pts[0 if closed else 1:]:
        _thick_line(runs, w, h, p0, p, flags, thickness)
        p0 = p
        flags = 2
    _draw_runs(img, runs, color)


def _ellipse2poly(cx, cy, ax, ay, angle, delta):
    """The float `ellipse2Poly` over the full arc (0..360)."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    beta, alpha = _SIN[angle], _SIN[450 - angle]
    pts = []
    for i in range(0, 360 + delta, delta):
        ang = min(i, 360)
        x = ax * _SIN[450 - ang]
        y = ay * _SIN[ang]
        pts.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
    return pts


@functools.lru_cache(maxsize=None)
def _disc_pixels(radius):
    runs = []
    _add_disc(runs, 0, 0, radius)
    pix = sorted({(y, x) for y, a, b in runs for x in range(a, b + 1)})
    return np.array(pix, np.int64).reshape(-1, 2).T


def circle(img, center, radius, color):
    """`cv2.circle(img, center, radius, color, -1)` (filled, LINE_8)."""
    dy, dx = _disc_pixels(int(radius))
    ys, xs = dy + int(center[1]), dx + int(center[0])
    h, w = img.shape[:2]
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    img[ys[ok], xs[ok]] = color
    return img


def ellipse(img, center, axes, angle, color, thickness=2):
    """`cv2.ellipse(img, center, axes, angle, 0, 360, color, thickness)`:
    the full outline at thickness 2, or filled at thickness -1 (LINE_8),
    with a float `angle` in degrees."""
    if thickness not in (2, -1):
        raise ValueError(f"ellipse draws thickness 2 or -1 (filled), not {thickness}")
    ang = int(round(float(angle)))  # cvRound
    cx, cy = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT
    ax, ay = abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT
    delta = (max(ax, ay) + _HALF) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v, prev = [], (-1, -1)
    for x, y in _ellipse2poly(float(cx), float(cy), float(ax), float(ay), ang, delta):
        pt = (int(round(x)), int(round(y)))
        if pt != prev:
            v.append(pt)
            prev = pt
    if len(v) == 1:
        v = [(cx, cy), (cx, cy)]
    if thickness == -1:
        runs = []
        _fill_convex_poly(runs, img.shape[1], img.shape[0], v)
        _draw_runs(img, runs, color)
    else:
        _polyline(img, v, False, color, thickness)
    return img


def rectangle(img, pt1, pt2, color, thickness=2):
    """`cv2.rectangle(img, pt1, pt2, color, thickness)`, thickness 2 or 3
    (LINE_8)."""
    if thickness not in (2, 3):
        raise ValueError(f"rectangle draws thickness 2 or 3, not {thickness}")
    x1, y1 = int(pt1[0]) << XY_SHIFT, int(pt1[1]) << XY_SHIFT
    x2, y2 = int(pt2[0]) << XY_SHIFT, int(pt2[1]) << XY_SHIFT
    _polyline(img, [(x1, y1), (x2, y1), (x2, y2), (x1, y2)], True, color, thickness)
    return img


# ------------------------------------------------------------------ text --
# font key: glyph table of the cv2.putText call (font, scale, thickness)
FONTS = {
    "plain": PLAIN_GLYPHS,                # FONT_HERSHEY_PLAIN, 1.0, 1
    "plain_1.2_t2": PLAIN_1_2_T2_GLYPHS,  # FONT_HERSHEY_PLAIN, 1.2, 2
    "simplex_0.5": SIMPLEX_0_5_GLYPHS,    # FONT_HERSHEY_SIMPLEX, 0.5, 1
}


@functools.lru_cache(maxsize=None)
def _glyph(font, c):
    adv, x0, y0, gw, hexrows = FONTS[font][c]
    cov = np.frombuffer(bytes.fromhex(hexrows), np.uint8)
    if gw == 0:
        return adv, np.zeros((0,), np.int64), np.zeros((0,), np.int64), cov.astype(np.int64)
    cov = cov.reshape(-1, gw)
    ys, xs = np.nonzero(cov)
    return adv, ys + y0, xs + x0, cov[ys, xs].astype(np.int64)


def put_text(img, text, org, color, font="plain"):
    """`cv2.putText(img, text, org, <font>, color)` for printable ASCII
    `text`, `font` a key of `FONTS`: "plain" is FONT_HERSHEY_PLAIN at scale
    1.0, thickness 1; "plain_1.2_t2" the same font at 1.2, thickness 2;
    "simplex_0.5" FONT_HERSHEY_SIMPLEX at 0.5, thickness 1 (LINE_8 or
    LINE_AA alike)."""
    if font not in FONTS:
        raise ValueError(f"put_text draws the fonts {sorted(FONTS)}, not {font!r}")
    bad = [c for c in text if c not in PLAIN_GLYPHS]
    if bad:
        raise ValueError(f"put_text draws printable ASCII only, not {bad[0]!r}")
    h, w = img.shape[:2]
    col = np.asarray(color, np.int64).reshape(1, -1)
    x = int(org[0])
    y = int(org[1])
    for c in text:
        adv, ys, xs, a = _glyph(font, c)
        ys, xs = ys + y, xs + x
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        if ok.any():
            ys, xs, a = ys[ok], xs[ok], a[ok][:, None]
            bg = img[ys, xs].astype(np.int64)
            img[ys, xs] = ((bg * (255 - a) + col * a + 127) // 255).astype(np.uint8)
        x += adv
    return img
