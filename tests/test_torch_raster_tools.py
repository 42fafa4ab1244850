"""The drawing calls of the labeling tools in `eval/raster.py` against
OpenCV, bit for bit: the filled full ellipse (`tools/labeling.py`'s
covariance ellipses), the thickness-3 rectangle (`view_sym_choice`'s
border) and text in FONT_HERSHEY_PLAIN 1.2 thickness 2 and
FONT_HERSHEY_SIMPLEX 0.5 (the tools' labels), on random backgrounds,
colours and geometry made from a seed (parts or all of it outside the
image, axes of 0 and far beyond it, strings running past the edges)."""

import cv2
import numpy as np
import pytest

from suo_slam_tpu_torch.eval import raster
from suo_slam_tpu_torch.eval._raster_tables import PLAIN_1_2_T2_GLYPHS, SIMPLEX_0_5_GLYPHS
from tests.test_torch_viz import PRINTABLE, _bg, _col, _same


@pytest.mark.parametrize("scale", ["small", "large"])
def test_filled_ellipse_matches_cv2(scale):
    """Axes of 0 and 1 (a point, a segment), every point step of
    ellipse2Poly, and axes far beyond the image; float angles."""
    rng = np.random.default_rng(11 if scale == "small" else 12)
    for i in range(1500 if scale == "small" else 300):
        h, w = (int(v) for v in rng.integers(1, 100, 2))
        c = (int(rng.integers(-30, w + 30)), int(rng.integers(-30, h + 30)))
        top = 40 if scale == "small" else 2500
        axes = (int(rng.integers(0, top)), int(rng.integers(0, top)))
        if i % 5 == 0:
            axes = (int(rng.integers(0, 2)), int(rng.integers(0, 3)))
        angle = float(rng.uniform(-400, 400)) if i % 3 else float(rng.integers(-8, 8)) * 45.5
        col = _col(rng)
        a = _bg(rng, h, w)
        b = a.copy()
        cv2.ellipse(a, c, axes, angle, 0, 360, col, -1)
        raster.ellipse(b, c, axes, angle, col, -1)
        _same(b, a, f"filled ellipse {i}: {c} {axes} {angle} in {h}x{w}")


def test_rectangle_thickness_3_matches_cv2():
    """Corners inside, partly or wholly outside, x2 < x1 / y2 < y1, and the
    tools' own border (1, 1) - (w - 2, h - 2)."""
    rng = np.random.default_rng(13)
    for i in range(2500):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        p1 = (int(rng.integers(-40, w + 40)), int(rng.integers(-40, h + 40)))
        p2 = (int(rng.integers(-40, w + 40)), int(rng.integers(-40, h + 40)))
        if i % 10 == 0:
            p1, p2 = (1, 1), (w - 2, h - 2)
        col = _col(rng)
        a = _bg(rng, h, w)
        b = a.copy()
        cv2.rectangle(a, p1, p2, col, 3)
        raster.rectangle(b, p1, p2, col, 3)
        _same(b, a, f"rectangle t3 {i}: {p1} {p2} in {h}x{w}")


@pytest.mark.parametrize("font", ["plain_1.2_t2", "simplex_0.5"])
def test_put_text_fonts_match_cv2(font):
    """Random printable-ASCII strings at origins left of, inside and past
    the image, at LINE_8 and LINE_AA."""
    cv_font, scale, thick = {"plain_1.2_t2": (cv2.FONT_HERSHEY_PLAIN, 1.2, 2),
                             "simplex_0.5": (cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)}[font]
    table = {"plain_1.2_t2": PLAIN_1_2_T2_GLYPHS, "simplex_0.5": SIMPLEX_0_5_GLYPHS}[font]
    rng = np.random.default_rng(14 if font == "simplex_0.5" else 15)
    for i in range(800):
        h, w = int(rng.integers(1, 70)), int(rng.integers(1, 700))
        text = "".join(rng.choice(PRINTABLE, int(rng.integers(1, 20))))
        org = (int(rng.integers(-200, w + 20)), int(rng.integers(-20, h + 25)))
        col = _col(rng)
        a = _bg(rng, h, w)
        b = a.copy()
        cv2.putText(a, text, org, cv_font, scale, col, thick,
                    cv2.LINE_AA if i % 2 else cv2.LINE_8)
        raster.put_text(b, text, org, col, font)
        _same(b, a, f"put_text {font} {i}: {text!r} at {org} in {h}x{w}")
        width = sum(table[c][0] for c in text) + 1
        assert width == cv2.getTextSize(text, cv_font, scale, thick)[0][0]


def test_unsupported_arguments_raise():
    img = np.zeros((20, 20, 3), np.uint8)
    with pytest.raises(ValueError, match="fonts"):
        raster.put_text(img, "a", (0, 10), (1, 2, 3), "simplex_1.0")
    with pytest.raises(ValueError, match="thickness"):
        raster.rectangle(img, (1, 1), (5, 5), (1, 2, 3), 4)
    with pytest.raises(ValueError, match="thickness"):
        raster.ellipse(img, (5, 5), (3, 2), 0.0, (1, 2, 3), 3)
    assert not img.any()
