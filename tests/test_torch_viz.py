"""The port's drawing (`suo_slam_tpu_torch/eval/raster.py`, `eval/viz.py`)
against OpenCV and the JAX package's `suo_slam_tpu/eval/viz.py`, bit for bit.

`raster.py` gives OpenCV 5.0's pixels without OpenCV: each primitive is held
against the `cv2` call it replaces on random backgrounds, colours and
geometry made from a seed (parts or all of it outside the image, inverted
boxes, axes of 0 and far beyond the image, negative text origins). The viz
functions are held against the JAX package's, which call `cv2`: the same
inputs through both give equal images and arrays.
"""

from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from suo_slam_tpu.eval import viz as jviz
from suo_slam_tpu_torch.eval import raster
from suo_slam_tpu_torch.eval import viz as tviz
from suo_slam_tpu_torch.eval._raster_tables import PLAIN_GLYPHS
from suo_slam_tpu_torch.kp import config as tkp

PRINTABLE = [chr(c) for c in range(32, 127)]


def _bg(rng, h, w):
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if rng.random() < 0.3:  # a flat background shows every blended level
        img[:] = rng.integers(0, 256, 3, dtype=np.uint8)
    return img


def _col(rng):
    return [int(v) for v in rng.integers(0, 256, 3)]


def _same(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    bad = np.argwhere((a != b).reshape(a.shape[0], a.shape[1], -1).any(-1))
    assert len(bad) == 0, f"{what}: {len(bad)} pixels differ, first at {bad[:3].tolist()}"


# ------------------------------------------------------------------ colour --
def test_hsv2bgr_u8_matches_cvtcolor():
    """All 180 hues at S, V = 255 and 5 other levels each, one pixel per
    conversion as `bbox_color` makes it, and a seeded sample of all
    inputs."""
    levels = [255, 0, 1, 64, 150, 254]
    h, s, v = np.meshgrid(np.arange(180), levels, levels, indexing="ij")
    hsv = np.stack([h, s, v], -1).reshape(-1, 1, 3).astype(np.uint8)
    np.testing.assert_array_equal(raster.hsv2bgr_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
    rng = np.random.default_rng(0)
    hsv = rng.integers(0, 256, (100_000, 1, 3), dtype=np.uint8)
    hsv[:, 0, 0] %= 180
    np.testing.assert_array_equal(raster.hsv2bgr_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def test_bbox_color_and_kp_colors_match_jax():
    from suo_slam_tpu.kp import config as jkp

    for obj_id in range(1, 91):
        assert tviz.bbox_color(obj_id) == jviz.bbox_color(obj_id), obj_id
    np.testing.assert_array_equal(tkp.kp_colors(), jkp.kp_colors())
    for name in tkp.KP_LIST:
        np.testing.assert_array_equal(tkp.kp_color(name), jkp.kp_color(name))


# -------------------------------------------------------------- primitives --
def test_circle_matches_cv2():
    rng = np.random.default_rng(1)
    for i in range(1500):
        h, w = (int(v) for v in rng.integers(1, 48, 2))
        c = (int(rng.integers(-12, w + 12)), int(rng.integers(-12, h + 12)))
        r, col = int(rng.integers(0, 14)), _col(rng)
        a = _bg(rng, h, w)
        b = a.copy()
        cv2.circle(a, c, r, col, -1)
        raster.circle(b, c, r, col)
        _same(b, a, f"circle {i}: {c} r={r} in {h}x{w}")


def test_rectangle_matches_cv2():
    """Corners inside, partly or wholly outside, and x2 < x1 / y2 < y1."""
    rng = np.random.default_rng(2)
    for i in range(2500):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        p1 = (int(rng.integers(-40, w + 40)), int(rng.integers(-40, h + 40)))
        p2 = (int(rng.integers(-40, w + 40)), int(rng.integers(-40, h + 40)))
        col = _col(rng)
        a = _bg(rng, h, w)
        b = a.copy()
        cv2.rectangle(a, p1, p2, col, 2)
        raster.rectangle(b, p1, p2, col)
        _same(b, a, f"rectangle {i}: {p1} {p2} in {h}x{w}")


@pytest.mark.parametrize("scale", ["small", "large"])
def test_ellipse_matches_cv2(scale):
    """Full-arc ellipses at thickness 2 with float angles: axes of 0 and
    small axes (every point step of ellipse2Poly), and axes up to far beyond
    the image; centres inside and outside."""
    rng = np.random.default_rng(3 if scale == "small" else 4)
    for i in range(1500 if scale == "small" else 400):
        h, w = (int(v) for v in rng.integers(1, 100, 2))
        c = (int(rng.integers(-30, w + 30)), int(rng.integers(-30, h + 30)))
        top = 40 if scale == "small" else 2500
        axes = (int(rng.integers(0, top)), int(rng.integers(0, top)))
        angle = float(rng.uniform(-400, 400)) if i % 3 else float(rng.integers(-8, 8)) * 45.5
        col = _col(rng)
        a = _bg(rng, h, w)
        b = a.copy()
        cv2.ellipse(a, c, axes, angle, 0, 360, col, 2)
        raster.ellipse(b, c, axes, angle, col)
        _same(b, a, f"ellipse {i}: {c} {axes} {angle} in {h}x{w}")


def test_put_text_matches_cv2():
    """Random printable-ASCII strings at integer origins left of, inside and
    past the image, on random backgrounds."""
    rng = np.random.default_rng(5)
    for i in range(1200):
        h, w = int(rng.integers(1, 70)), int(rng.integers(1, 700))
        text = "".join(rng.choice(PRINTABLE, int(rng.integers(1, 20))))
        org = (int(rng.integers(-200, w + 20)), int(rng.integers(-20, h + 25)))
        col = _col(rng)
        a = _bg(rng, h, w)
        b = a.copy()
        cv2.putText(a, text, org, cv2.FONT_HERSHEY_PLAIN, 1.0, col, 1, cv2.LINE_AA)
        raster.put_text(b, text, org, col)
        _same(b, a, f"put_text {i}: {text!r} at {org} in {h}x{w}")
        # the table's advances give OpenCV's text width
        width = sum(PLAIN_GLYPHS[c][0] for c in text) + 1
        assert width == cv2.getTextSize(text, cv2.FONT_HERSHEY_PLAIN, 1.0, 1)[0][0]
    with pytest.raises(ValueError, match="printable ASCII"):
        raster.put_text(np.zeros((20, 20, 3), np.uint8), "é", (0, 10), (1, 2, 3))


# --------------------------------------------------------------- the viz --
def _spd(rng, kind, scale):
    """[K, 2, 2] covariances: random SPD, zero, rank-1 or huge."""
    k = tkp.num_kp()
    if kind == "zero":
        return np.zeros((k, 2, 2))
    a = rng.normal(size=(k, 2, 2)) * scale
    if kind == "rank1":
        a[:, :, 1] = 0.0
    cov = a @ np.swapaxes(a, 1, 2)
    if kind == "huge":  # axes of about 2,000 px
        cov *= (2000.0 / (2.0 / 3.0 * np.sqrt(5.991))) ** 2 / np.maximum(
            np.linalg.eigvalsh(cov)[:, -1:, None], 1e-12)
    return cov


def test_draw_points_matches_jax():
    """200 sets of 41 keypoints on and off the image and on its edges, with
    and without covariances (random SPD, zero, rank-1, axes of 2,000 px)."""
    rng = np.random.default_rng(6)
    cols = tkp.kp_colors()
    k = tkp.num_kp()
    for i in range(200):
        h, w = int(rng.integers(40, 160)), int(rng.integers(40, 200))
        xy = np.stack([rng.uniform(-10, w + 10, k), rng.uniform(-10, h + 10, k)], -1)
        edge = rng.random(k) < 0.2
        xy[edge] = rng.choice([-0.5, 0.0, 0.49, w - 1, w - 0.5, h - 1], (edge.sum(), 2))
        cov = None if i % 5 == 0 else _spd(rng, ["spd", "zero", "rank1", "huge"][i % 4],
                                              float(rng.uniform(0.5, 12)))
        a = _bg(rng, h, w)
        b = a.copy()
        jviz.draw_points(a, xy, cols, cov=cov)
        tviz.draw_points(b, xy, cols, cov=cov)
        _same(b, a, f"draw_points {i}")
    ndc = rng.uniform(-1.2, 1.2, (k, 2))
    a, b = np.zeros((2, 90, 120, 3), np.uint8)
    jviz.draw_points(a, ndc, cols, ndc=True)
    tviz.draw_points(b, ndc, cols, ndc=True)
    _same(b, a, "draw_points ndc")


def test_draw_bbox_matches_jax():
    """200 boxes, some partly or wholly outside the image or inverted, with
    the labels `obj 1`-`obj 99` and custom labels."""
    rng = np.random.default_rng(7)
    for i in range(200):
        h, w = int(rng.integers(30, 200)), int(rng.integers(30, 260))
        x = np.sort(rng.uniform(-80, w + 80, 2))
        y = np.sort(rng.uniform(-40, h + 40, 2))
        bbox = [x[0], y[0], x[1], y[1]] if i % 7 else [x[1], y[1], x[0], y[0]]
        obj_id = i % 99 + 1  # the default labels `obj 1`-`obj 99` first, custom ones after
        label = None if i < 150 else "".join(rng.choice(PRINTABLE, int(rng.integers(1, 12))))
        a = _bg(rng, h, w)
        b = a.copy()
        jviz.draw_bbox(a, bbox, obj_id, label=label)
        tviz.draw_bbox(b, bbox, obj_id, label=label)
        _same(b, a, f"draw_bbox {i}: {bbox} {obj_id} {label!r}")


def _scene(rng, n_obj=8, hw=(480, 640)):
    """A frame of `n_obj` detections with keypoints (NDC in the box),
    covariances, validity, priors, model masks and poses, and mesh
    points."""
    h, w = hw
    k = tkp.num_kp()
    img = rng.random((h, w, 3)).astype(np.float32)
    K = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]])
    dets, poses, points = {}, {}, {}
    for o in range(1, n_obj + 1):
        x1, y1 = rng.uniform(-40, w - 40), rng.uniform(-20, h - 40)
        bbox = np.array([x1, y1, x1 + rng.uniform(20, 200), y1 + rng.uniform(20, 160)],
                        np.float32)
        a = rng.normal(size=(k, 2, 2)) * rng.uniform(0.005, 0.08)
        dets[o] = {
            "bbox": bbox,
            "uv": rng.uniform(-1.1, 1.1, (k, 2)).astype(np.float32),
            "cov": (a @ np.swapaxes(a, 1, 2)).astype(np.float32) if o % 4 else None,
            "kp_mask": rng.random(k) < 0.7,
            "prior_uv": rng.uniform(-1, 1, (k, 2)).astype(np.float32) if o % 3 else None,
            "model_mask": rng.random(k) < 0.8,
        }
        R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = [rng.uniform(-200, 200), rng.uniform(-150, 150), rng.uniform(400, 1500)]
        poses[o] = T if o % 5 else None
        points[o] = rng.uniform(-80, 80, (600, 3)).astype(np.float32)
    return img, dets, poses, K, SimpleNamespace(points=points)


@pytest.mark.parametrize("viz_cov", [False, True])
def test_make_frame_and_extra_viz_match_jax(viz_cov):
    """20 scenes of 8 objects at 480 x 640 with priors, poses and mesh
    points: the 3-panel frame and the per-object panels are equal."""
    rng = np.random.default_rng(8 + viz_cov)
    for i in range(20):
        img, dets, poses, K, mesh_db = _scene(rng)
        if not viz_cov:  # the CLI's default: no ellipses on the frame
            dets = {o: {**d, "cov": None} for o, d in dets.items()}
        priors = None
        if i % 2:
            priors = np.zeros((480, 640, tkp.num_kp()), np.float32)
            for d in dets.values():
                if d["prior_uv"] is not None:
                    c = jviz._bbox_ndc_to_px(d["prior_uv"][d["model_mask"]], d["bbox"])
                    priors = np.maximum(priors, jviz.render_prior_px(
                        (480, 640), c, np.where(d["model_mask"])[0]))
        a = jviz.make_frame_viz(img, dets, poses, K, mesh_db=mesh_db, priors=priors)
        b = tviz.make_frame_viz(img, dets, poses, K, mesh_db=mesh_db, priors=priors)
        _same(b, a, f"make_frame_viz {i}")
        ea = jviz.make_extra_viz(img, dets, poses, K, mesh_db=mesh_db, viz_cov=viz_cov)
        eb = tviz.make_extra_viz(img, dets, poses, K, mesh_db=mesh_db, viz_cov=viz_cov)
        assert list(eb) == list(ea)
        for name in ea:
            _same(eb[name], ea[name], f"make_extra_viz {i} {name}")


def test_prior_blend_and_ndc_arrays_match_jax():
    rng = np.random.default_rng(9)
    k = tkp.num_kp()
    for i in range(10):
        hw = (int(rng.integers(20, 300)), int(rng.integers(20, 300)))
        centers = np.stack([rng.uniform(-60, hw[1] + 60, 30), rng.uniform(-60, hw[0] + 60, 30)],
                           -1)
        idx = rng.integers(0, k, 30)
        pa = jviz.render_prior_px(hw, centers, idx)
        pb = tviz.render_prior_px(hw, centers, idx)
        np.testing.assert_array_equal(pb, pa)
        rgb = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        np.testing.assert_array_equal(tviz.blend_prior(rgb, pa), jviz.blend_prior(rgb, pa))
        chw = np.ascontiguousarray(pa.transpose(2, 0, 1))
        np.testing.assert_array_equal(tviz.blend_prior(rgb, chw), jviz.blend_prior(rgb, chw))
        xy = rng.uniform(-1.5, 1.5, (50, 2))
        np.testing.assert_array_equal(tviz.ndc_to_px(xy, hw), jviz.ndc_to_px(xy, hw))
        uv = rng.uniform(-1, 1, (7, k, 2))
        bbox = rng.uniform(0, 200, 4)
        np.testing.assert_array_equal(tviz._bbox_ndc_to_px(uv, bbox),
                                      jviz._bbox_ndc_to_px(uv, bbox))
        img = rng.random(hw + (3,)).astype(np.float32)
        np.testing.assert_array_equal(tviz._to_u8(img), jviz._to_u8(img))
