"""Training augmentations with the camera-matrix fix-up, in numpy.

Port of `suo_slam_tpu/data/augmentations.py`: a scale-and-rotate warp that
folds itself into K (K' = T @ K) and the bounding boxes, a Gaussian blur and
Pillow's four enhancers (sharpness, contrast, brightness, colour). The JAX
package calls OpenCV and Pillow for the pixels; the card's machine has
neither, so each operation here reproduces the arithmetic of the library
call it replaces, as OpenCV 5.0 and Pillow 12.1 run it:

- `warp_affine_linear` is `cv2.warpAffine(img, A, (w, h), INTER_LINEAR)` on
  uint8: A inverted in f64 and rounded to f32; a source coordinate is
  fma(m0, x, m1 * y + m2) in f32; floor and fraction; the bilinear blend
  f00 + a * (f01 - f00) by rows, then by columns, each an f32 fma; rounded
  half to even; taps outside the image read the border value 0.
  `warp_affine_nearest` (the depth map) rounds the same coordinates half to
  even. (OpenCV 5.0 computes in f32; the fixed-point remap of OpenCV 4 is
  gone.)
- `resize_linear` is `cv2.resize(img, (w, h))` (INTER_LINEAR) on uint8:
  f32 offsets, integer taps at 2^11, the vertical pass as OpenCV's SIMD
  path computes it; an exact 2x downscale is its INTER_AREA (the VOC
  background compositing).
- `blend` is `Image.blend`: in1 + alpha * (in2 - in1) in f32, truncated,
  clipped first where alpha lies outside [0, 1].
- `luma` is Pillow's RGB -> L: (19595 R + 38470 G + 7471 B + 2^15) >> 16.
- `smooth` is `ImageFilter.SMOOTH`: the 3x3 kernel (1 1 1 / 1 5 1 / 1 1 1)
  / 13 in f32, rows summed bottom to top, rounded half up and clipped; the
  border pixels are kept.
- `gaussian_blur` is `ImageFilter.GaussianBlur(r)`: Pillow's extended box
  blur, three passes along rows, then three along columns, each in 24-bit
  fixed point with the edge pixels repeated.

The JAX package hands OpenCV's BGR frame to Pillow as if it were RGB, so
Color and Contrast weight B, G, R with R, G, B's coefficients; that is the
reference's behaviour and is kept.

Each augmentation is `aug(rng, img, depth, bboxes, K) -> (img, depth,
bboxes, K)` with img uint8 [H, W, 3], and draws from the sample's
`np.random.Generator` exactly what the JAX package draws, in its order, so a
stream stands where JAX's stands after every sample.
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32


# --------------------------------------------------------------- OpenCV ---
def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """`cv2.getRotationMatrix2D`: [2, 3] f64, the centre rounded to f32."""
    cx, cy = (float(_F32(c)) for c in center)
    a = angle * (math.pi / 180.0)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1.0 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1.0 - alpha) * cy]], np.float64)


def _inverse_map(A) -> np.ndarray:
    """The destination -> source map of a forward affine [2, 3], inverted in
    f64 as `warpAffine` inverts it, then rounded to f32: [6]."""
    m = np.asarray(A, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m.astype(_F32)


def _fma32(a, b, c) -> np.ndarray:
    """f32 fused multiply-add: the product and sum in f64, rounded once to
    f32 (exact for the operands here)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _source_coords(A, h: int, w: int):
    """Source (x, y) of every destination pixel, [h, w] f32 each."""
    m = _inverse_map(A)
    xs = np.arange(w, dtype=_F32)[None, :]
    ys = np.arange(h, dtype=_F32)[:, None]
    mx = m[1] * ys + m[2]  # f32 products and sums, not fused
    my = m[4] * ys + m[5]
    return _fma32(m[0], xs, mx), _fma32(m[3], xs, my)


def warp_affine_linear(img: np.ndarray, A) -> np.ndarray:
    """`cv2.warpAffine(img, A, (w, h), flags=INTER_LINEAR)` of a uint8
    [H, W] or [H, W, C] image (see the module docstring). The f32 fmas are
    f64 products and sums rounded once to f32 (exact for these operands),
    a channel plane at a time."""
    h, w = img.shape[:2]
    x, y = _source_coords(A, h, w)
    x0, y0 = np.floor(x), np.floor(y)
    ax = np.subtract(x, x0, dtype=np.float64)
    ay = np.subtract(y, y0, dtype=np.float64)
    src = img.reshape(h, w, -1)
    c = src.shape[-1]
    # a zero border of two pixels: a tap outside the image reads 0, and a
    # corner clamped to [-2, w] keeps both of its taps outside
    w4 = w + 4
    pad = np.zeros((c, h + 4, w4), np.float64)
    pad[:, 2:-2, 2:-2] = np.moveaxis(src, -1, 0)
    planes = pad.reshape(c, -1)
    base = ((np.clip(y0, -2, h).astype(np.int64) + 2) * w4
            + np.clip(x0, -2, w).astype(np.int64) + 2)
    out = np.empty((h, w, c), np.uint8)
    for ch in range(c):
        f = planes[ch]
        f00, f01, f10, f11 = f[base], f[base + 1], f[base + w4], f[base + w4 + 1]
        f01 -= f00
        f01 *= ax
        f01 += f00
        f11 -= f10
        f11 *= ax
        f11 += f10
        r0, r1 = f01.astype(_F32), f11.astype(_F32)
        v = np.subtract(r1, r0, dtype=_F32).astype(np.float64)
        v *= ay
        v += r0
        v = v.astype(_F32)
        np.rint(v, out=v)
        out[..., ch] = np.clip(v, 0, 255, out=v)
    return out.reshape(img.shape)


def warp_affine_nearest(img: np.ndarray, A) -> np.ndarray:
    """`cv2.warpAffine(img, A, (w, h), flags=INTER_NEAREST)` of an [H, W]
    map of any dtype (the f32 depth): the source pixel at the coordinates
    rounded half to even, 0 outside the image."""
    h, w = img.shape[:2]
    x, y = _source_coords(A, h, w)
    sx, sy = np.rint(x).astype(np.int64), np.rint(y).astype(np.int64)
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = np.zeros_like(img)
    out[inside] = img[sy[inside], sx[inside]]
    return out


def _linear_taps(dst: int, src: int, clamp_weight: bool):
    """OpenCV's INTER_LINEAR taps along one axis: (i0, i1, w0, w1), the
    weights at 2^11 from the f32 offset (d + 0.5) * scale - 0.5, rounded
    half to even. The columns clamp the offset and its weight at the ends
    (`clamp_weight`); the rows clamp only the two row indices."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(_F32)
    i0 = np.floor(f).astype(np.int64)
    f = np.subtract(f, i0.astype(_F32), dtype=_F32)
    if clamp_weight:
        lo, hi = i0 < 0, i0 >= src - 1
        f[lo | hi] = 0
        i0 = np.where(lo, 0, np.where(hi, src - 1, i0))
    w1 = np.rint(f * _F32(2048)).astype(np.int32)
    w0 = np.rint(np.subtract(_F32(1), f, dtype=_F32) * _F32(2048)).astype(np.int32)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w0, w1


def resize_linear(img: np.ndarray, dsize) -> np.ndarray:
    """`cv2.resize(img, (w, h))` (INTER_LINEAR) of a uint8 [H, W, C] or
    [H, W] image, bit for bit as OpenCV 5.0 computes it: horizontal taps in
    integers at 2^11; the vertical pass as its SIMD path on every column,
    ((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) saturated to int16, then
    (v + 2) >> 2 saturated to uint8. An exact 2x downscale is OpenCV's
    INTER_AREA there: (a + b + c + d + 2) >> 2 of each 2x2 block."""
    w, h = int(dsize[0]), int(dsize[1])
    src = img.reshape(img.shape[0], img.shape[1], -1)
    H, W, C = src.shape
    if W == 2 * w and H == 2 * h:
        s = src.astype(np.int32).reshape(h, 2, w, 2, C).sum((1, 3))
        return ((s + 2) >> 2).astype(np.uint8).reshape((h, w) + img.shape[2:])
    x0, x1, a0, a1 = _linear_taps(w, W, True)
    y0, y1, b0, b1 = _linear_taps(h, H, False)
    s = src.astype(np.int32)
    hz = (s[:, x0] * a0[None, :, None] + s[:, x1] * a1[None, :, None]).reshape(H, w * C)
    hz >>= 4  # at most 255 * 2^11 >> 4 < 2^15: the int16 pack saturates nothing
    v = ((hz[y0] * b0[:, None]) >> 16) + ((hz[y1] * b1[:, None]) >> 16)
    np.clip(v, -32768, 32767, out=v)
    v += 2
    v >>= 2
    return np.clip(v, 0, 255).astype(np.uint8).reshape((h, w) + img.shape[2:])


# --------------------------------------------------------------- Pillow ---
def blend(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    """`Image.blend(a, b, alpha)` of two uint8 images."""
    al = _F32(alpha)
    fa = a.astype(_F32)
    t = fa + al * (b.astype(_F32) - fa)
    if not 0.0 <= al <= 1.0:
        t = np.clip(t, 0, 255)
    return t.astype(np.uint8)


def luma(img: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L of a uint8 [H, W, 3] image (channel 0 weighted as
    red): [H, W] uint8."""
    i = img.astype(np.int32)
    return ((i[..., 0] * 19595 + i[..., 1] * 38470 + i[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def smooth(img: np.ndarray) -> np.ndarray:
    """`img.filter(ImageFilter.SMOOTH)` of a uint8 [H, W, C] image."""
    k0, k1 = _F32(1) / _F32(13), _F32(5) / _F32(13)
    x = img.astype(_F32)

    def row(r, kc):  # (a k0 + b kc) + c k0 along the row, f32 as Pillow adds
        return (r[:, :-2] * k0 + r[:, 1:-1] * kc) + r[:, 2:] * k0

    ss = (row(x[2:], k0) + row(x[1:-1], k1)) + row(x[:-2], k0)
    v = np.where(ss <= 0, _F32(0), np.where(ss >= 255, _F32(255), ss + _F32(0.5)))
    out = img.copy()
    out[1:-1, 1:-1] = v.astype(np.uint8)
    return out


def _box_radius(radius: float, passes: int = 3) -> np.float32:
    """Pillow's `_gaussian_blur_radius`: the extended box radius of `passes`
    box blurs with the Gaussian's variance, in its f32 / f64 arithmetic."""
    r = _F32(radius)
    sigma2 = _F32(r * r / _F32(passes))
    big_l = _F32(math.sqrt(12.0 * float(sigma2) + 1.0))
    l = _F32(math.floor((float(big_l) - 1.0) / 2.0))
    a = _F32(_F32(2 * l + 1) * _F32(l * (l + 1) - _F32(3) * sigma2))
    a = _F32(a / _F32(_F32(6) * _F32(sigma2 - (l + 1) * (l + 1))))
    return _F32(l + a)


def _box_blur(x: np.ndarray, fr: np.float32, axis: int) -> np.ndarray:
    """One pass of Pillow's extended box blur along `axis` of a uint8 array:
    (ww * sum of the 2r + 1 window + fw * the two pixels beyond it + 2^23)
    >> 24 in uint32, edge pixels repeated."""
    r = int(fr)
    ww = int(_F32(16777216) / _F32(fr * _F32(2) + _F32(1)))
    fw = (16777216 - (2 * r + 1) * ww) // 2
    x = np.moveaxis(x, axis, 0)
    n = x.shape[0]
    pad = np.concatenate([np.repeat(x[:1], r + 1, 0), x, np.repeat(x[-1:], r + 1, 0)],
                         0).astype(np.uint32)
    cs = np.zeros((pad.shape[0] + 1,) + pad.shape[1:], np.uint32)
    np.cumsum(pad, 0, out=cs[1:])
    acc = cs[2 * r + 2:2 * r + 2 + n] - cs[1:1 + n]  # the window [i - r, i + r]
    far = pad[:n] + pad[2 * r + 2:2 * r + 2 + n]
    out = (acc * np.uint32(ww) + far * np.uint32(fw) + np.uint32(1 << 23)) >> np.uint32(24)
    return np.moveaxis(out.astype(np.uint8), 0, axis)


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """`img.filter(ImageFilter.GaussianBlur(radius))` of a uint8 [H, W, C]
    image: three box passes along each row, then three along each column."""
    fr = _box_radius(radius)
    x = img
    for axis in (1, 1, 1, 0, 0, 0):
        x = _box_blur(x, fr, axis)
    return np.ascontiguousarray(x)


def enhance_brightness(img, factor):
    """`ImageEnhance.Brightness(img).enhance(factor)`."""
    return blend(np.zeros_like(img), img, factor)


def enhance_color(img, factor):
    """`ImageEnhance.Color(img).enhance(factor)`: blend from the grey image."""
    return blend(np.repeat(luma(img)[..., None], img.shape[-1], -1), img, factor)


def enhance_contrast(img, factor):
    """`ImageEnhance.Contrast(img).enhance(factor)`: blend from the mean grey
    level, int(mean(L) + 0.5)."""
    lum = luma(img)
    mean = int(float(lum.sum(dtype=np.int64)) / lum.size + 0.5)
    return blend(np.full_like(img, mean), img, factor)


def enhance_sharpness(img, factor):
    """`ImageEnhance.Sharpness(img).enhance(factor)`: blend from SMOOTH."""
    return blend(smooth(img), img, factor)


# -------------------------------------------------------- augmentations ---
class ScaleAndRotate:
    """Random scale [1, 1.5] and rotation +-5 deg (with probability 0.5 plus
    180 deg) about the image centre, folded into K as K' = T @ K and into
    the boxes; the depth map warps nearest-neighbour."""

    def __init__(self, scale=(1.0, 1.5), angle=(-5.0, 5.0), p_flip=0.5):
        self.scale = scale
        self.angle = angle
        self.p_flip = p_flip

    def __call__(self, rng, img, depth=None, bboxes=None, K=None):
        h, w = img.shape[:2]
        s = rng.uniform(*self.scale)
        angle = rng.uniform(*self.angle)
        if rng.uniform() < self.p_flip:
            angle += 180.0
        T = np.eye(3, dtype=np.float64)
        T[:2, :] = rotation_matrix_2d((w / 2.0 - 0.5, h / 2.0 - 0.5), angle, s)
        if K is not None:
            K = T @ K
        A = T[:2, :]
        img = warp_affine_linear(img, A)
        if depth is not None:
            depth = warp_affine_nearest(depth, A)
        if bboxes is not None:
            pts = bboxes.reshape(-1, 2) @ A[:2, :2].T + A[None, :2, 2]
            bboxes = pts.reshape(-1, 4).astype(np.float32)
        return img, depth, bboxes, K


class _Enhance:
    """With probability p, an enhancer at a factor drawn from the interval."""

    def __init__(self, fn, p, factor_interval):
        self.fn = fn
        self.p = p
        self.factor_interval = factor_interval

    def __call__(self, rng, img, depth=None, bboxes=None, K=None):
        if rng.uniform() <= self.p:
            img = self.fn(img, rng.uniform(*self.factor_interval))
        return img, depth, bboxes, K


class Blur:
    """With probability p, a Gaussian blur of integer radius in the
    interval (both ends included)."""

    def __init__(self, p=0.4, factor_interval=(1, 3)):
        self.p = p
        self.factor_interval = factor_interval

    def __call__(self, rng, img, depth=None, bboxes=None, K=None):
        if rng.uniform() <= self.p:
            k = int(rng.integers(self.factor_interval[0], self.factor_interval[1] + 1))
            img = gaussian_blur(img, k)
        return img, depth, bboxes, K


def Sharpness(p=0.3, factor_interval=(0.0, 50.0)):
    return _Enhance(enhance_sharpness, p, factor_interval)


def Contrast(p=0.3, factor_interval=(0.2, 50.0)):
    return _Enhance(enhance_contrast, p, factor_interval)


def Brightness(p=0.5, factor_interval=(0.1, 6.0)):
    return _Enhance(enhance_brightness, p, factor_interval)


def Color(p=0.3, factor_interval=(0.0, 20.0)):
    return _Enhance(enhance_color, p, factor_interval)


def default_train_augs():
    """The training stack, in the JAX package's order."""
    return [
        ScaleAndRotate(),
        Blur(p=0.4, factor_interval=(1, 3)),
        Sharpness(p=0.3, factor_interval=(0.0, 50.0)),
        Contrast(p=0.3, factor_interval=(0.2, 50.0)),
        Brightness(p=0.5, factor_interval=(0.1, 6.0)),
        Color(p=0.3, factor_interval=(0.0, 20.0)),
    ]


def apply_augs(augs, rng, img, depth=None, bboxes=None, K=None, p_any=0.8):
    """The whole stack with probability `p_any` (one draw), else nothing."""
    if augs and rng.uniform() < p_any:
        for a in augs:
            img, depth, bboxes, K = a(rng, img, depth, bboxes, K)
    return img, depth, bboxes, K
