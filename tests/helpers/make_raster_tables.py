"""Write `suo_slam_tpu_torch/eval/_raster_tables.py` from OpenCV (cv2 5.0.0).

    python -m tests.helpers.make_raster_tables

The tables are read off OpenCV's own output, not downloaded:

- `SIN_QUARTER`: OpenCV's `SinTable` (drawing.cpp) for 0..90 degrees.
  `cv2.ellipse2Poly((0, 0), (2**30, 2**30), 0, 0, 360, 1)` returns
  `round(2**30 * SinTable[i])` per degree, which is exact for a float
  table; the rest of the table is its mirror images (checked here).
- One glyph table per font that `eval/raster.put_text` draws (`FONTS`):
  for each printable ASCII character, `cv2.putText(...)` in white on black
  gives the glyph's 8-bit coverage; the advance is `getTextSize(c)` width
  minus 1. Checked here for every character of every font: the glyph is the
  same at LINE_8 and LINE_AA and at other integer origins, and the advances
  add up to `getTextSize`'s width over strings of three characters.
  `tests/test_torch_viz.py` and `tests/test_torch_raster_tools.py` hold the
  composition (glyph after glyph, each blended over the image) against
  `cv2.putText` on random strings, backgrounds and origins.
"""

from __future__ import annotations

import os

import cv2
import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "..", "..", "suo_slam_tpu_torch", "eval",
                   "_raster_tables.py")
_ORG = (40, 40)
PRINTABLE = [chr(c) for c in range(32, 127)]
# table name: (cv2 font, scale, thickness, line type, the call it reads)
FONTS = {
    "PLAIN_GLYPHS": (cv2.FONT_HERSHEY_PLAIN, 1.0, 1, cv2.LINE_AA,
                     "FONT_HERSHEY_PLAIN, scale 1.0, thickness 1"),
    "PLAIN_1_2_T2_GLYPHS": (cv2.FONT_HERSHEY_PLAIN, 1.2, 2, cv2.LINE_8,
                            "FONT_HERSHEY_PLAIN, scale 1.2, thickness 2"),
    "SIMPLEX_0_5_GLYPHS": (cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1, cv2.LINE_AA,
                           "FONT_HERSHEY_SIMPLEX, scale 0.5, thickness 1"),
}


def sin_quarter():
    a = 2 ** 30
    p = cv2.ellipse2Poly((0, 0), (a, a), 0, 0, 360, 1).astype(np.float64)
    table = np.zeros(451)
    for i in range(361):
        table[i], table[450 - i] = p[i, 1] / a, p[i, 0] / a
    q = table[:91]
    mirrored = np.concatenate([q, q[::-1][1:], -q[1:], -q[::-1][1:], q[1:]])
    assert np.array_equal(mirrored, table)
    assert np.array_equal(q, q.astype(np.float32))
    return q


def _coverage(c, font, scale, thick, line, org=_ORG):
    img = np.zeros((80, 80, 3), np.uint8)
    cv2.putText(img, c, org, font, scale, (255, 255, 255), thick, line)
    a = img[..., 0]
    assert (img == a[..., None]).all()
    return a


def glyph(c, font=cv2.FONT_HERSHEY_PLAIN, scale=1.0, thick=1, line=cv2.LINE_AA):
    a = _coverage(c, font, scale, thick, line)
    other = cv2.LINE_AA if line == cv2.LINE_8 else cv2.LINE_8
    assert np.array_equal(_coverage(c, font, scale, thick, other), a), (c, "line type")
    for dx, dy in ((1, 0), (0, 1), (-3, 5)):
        moved = _coverage(c, font, scale, thick, line, (_ORG[0] + dx, _ORG[1] + dy))
        assert np.array_equal(moved, np.roll(a, (dy, dx), (0, 1))), (c, "translation")
    adv = cv2.getTextSize(c, font, scale, thick)[0][0] - 1
    ys, xs = np.nonzero(a)
    if len(ys) == 0:
        return adv, 0, 0, 0, ""
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    assert 0 < y0 and y1 < 80 and 0 < x0 and x1 < 80
    return (adv, int(x0 - _ORG[0]), int(y0 - _ORG[1]), int(x1 - x0),
            a[y0:y1, x0:x1].tobytes().hex())


def check_advances(font, scale, thick, advs):
    """getTextSize's width of c + d + c is the sum of the advances + 1."""
    for c in PRINTABLE:
        for d in PRINTABLE[::3]:
            s = c + d + c
            assert cv2.getTextSize(s, font, scale, thick)[0][0] == \
                sum(advs[x] for x in s) + 1, (s, "advance")


def main():
    q = sin_quarter()
    lines = [
        '"""Tables of `eval/raster.py`, written by `python -m',
        'tests.helpers.make_raster_tables` from OpenCV 5.0.0 (see its docstring:',
        "OpenCV's sine table, and the glyphs of the fonts `put_text` draws as",
        "OpenCV 5.0 renders them, through its built-in TrueType font). Do not edit.",
        '"""',
        "",
        "# SinTable[0..90] of OpenCV's drawing.cpp (float literals); the rest of",
        "# the 451 entries mirror these",
        "SIN_QUARTER = (",
    ]
    vals = [str(np.float32(v)) for v in q]
    for i in range(0, len(vals), 8):
        lines.append("    " + ", ".join(vals[i:i + 8]) + ",")
    lines.append(")")
    for name, (font, scale, thick, line, what) in FONTS.items():
        lines += [
            "",
            f"# {what}: char: (advance, x0, y0, width, coverage rows, row-major,",
            "# as hex); the glyph's top-left pixel sits at (org.x + x0, org.y + y0)",
            f"{name} = {{",
        ]
        advs = {}
        for c in PRINTABLE:
            adv, x0, y0, w, hx = glyph(c, font, scale, thick, line)
            advs[c] = adv
            lines.append(f"    {c!r}: ({adv}, {x0}, {y0}, {w},")
            for i in range(0, len(hx), 64):
                lines.append(f'        "{hx[i:i + 64]}"')
            lines[-1] += "),"
            if not hx:
                lines[-1] = f'    {c!r}: ({adv}, {x0}, {y0}, {w}, ""),'
        lines.append("}")
        check_advances(font, scale, thick, advs)
    with open(OUT, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {os.path.normpath(OUT)}")


if __name__ == "__main__":
    main()
