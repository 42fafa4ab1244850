"""`tools/labeling.py` and the interactive session of
`suo_slam_tpu_torch.manual_keypoints` against the JAX package's
`suo_slam_tpu.tools.labeling`, on the same inputs: the free functions, the
labeler's renders, clicks, statistics and saved JSON (tolerance 0: the same
numpy arithmetic), and the inspection pane bit-equal to JAX's, which draws
with cv2. A scripted session of clicks and keys gives the samples, the
accepted view pose and the JSON bytes of the JAX labeler driven by the same
calls, and the panel the JAX CLI draws."""

import copy
import json

import cv2
import numpy as np
import pytest

from suo_slam_tpu.tools import labeling as jlab
from suo_slam_tpu_torch.kp.config import KP_LIST
from suo_slam_tpu_torch.manual_keypoints import K_LABEL as K
from suo_slam_tpu_torch.manual_keypoints import LabelSession
from suo_slam_tpu_torch.tools import labeling as tlab
from tests.helpers.threads import one_torch_thread  # noqa: F401 (autouse)
from tests.helpers.meshes import torus_mesh
from tests.helpers.synthetic_bop import CUBOID_TRIS, OBJ_HALF_EXTENTS, cuboid_corners

NAMES = [KP_LIST[i] for i in (0, 1, 6, 8, 20, 35)]
MESHES = {"cuboid": (cuboid_corners(*OBJ_HALF_EXTENTS[1]), CUBOID_TRIS),
          "torus": torus_mesh(seed=3)}


@pytest.fixture(scope="module", params=list(MESHES))
def labelers(request):
    verts, faces = MESHES[request.param]
    return (jlab.KeypointLabeler(verts, faces, K), tlab.KeypointLabeler(verts, faces, K))


def _surface_clicks(lab, rng, n):
    """n (view, x, y) clicks on the rendered surface, as panel pixels."""
    h, w = lab.hw
    out = []
    for _ in range(n):
        vi = int(rng.integers(len(lab.view_poses)))
        ys, xs = np.nonzero(lab.depths[vi] > 0)
        k = int(rng.integers(len(xs)))
        out.append((vi, int(xs[k]), int(ys[k])))
    return out


def _spd(rng, scale):
    A = rng.normal(size=(3, 3)) * scale
    return A @ A.T


# ---------------------------------------------------------- free functions --
def _free_cases(rng):
    T = tlab.canonical_view_poses(150.0)[3]
    cases = [("canonical_view_poses", (d, n)) for d, n in ((80.0, 8), (333.3, 8), (12.5, 6))]
    for scale in (1e-4, 0.3, 5.0, 60.0):
        mean = rng.uniform(-40, 40, 3)
        cases.append(("propagate_cov_2d", (K, T, mean, _spd(rng, scale))))
        cases.append(("propagate_cov_2d", (K, T[:3], mean, _spd(rng, scale))))
    covs = [np.zeros((2, 2)), np.diag([4.0, 0.0]), np.array([[9.0, 3.0], [3.0, 2.0]])]
    covs += [_spd(rng, s)[:2, :2] for s in (1e-3, 1.0, 40.0)]
    cases += [("cov_ellipse", (c,)) for c in covs]
    cases += [("adjust_view_pose", (T, k)) for k in "wasdiox"]
    cases += [("adjust_view_pose", (T[:3], "w")), ("adjust_view_pose", (T, "d", 7.5))]
    return cases


FREE = [f"{fn} {i}" for i, (fn, _) in enumerate(_free_cases(np.random.default_rng(0)))]


@pytest.mark.parametrize("case", FREE)
def test_free_function_matches_jax(case):
    fn, args = _free_cases(np.random.default_rng(0))[FREE.index(case)]
    a, b = getattr(tlab, fn)(*args), getattr(jlab, fn)(*args)
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    for x, y in zip(a, b):
        if isinstance(y, tuple):
            assert x == y
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert type(x) is type(y)


# ---------------------------------------------------------------- labeler --
def test_labeler_renders_match_jax(labelers):
    j, t = labelers
    np.testing.assert_array_equal(t.view_poses, j.view_poses)
    for a, b in zip(t.shaded + t.depths, j.shaded + j.depths):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.render_panel(), j.render_panel())
    assert t.render_panel().shape == (480, 1280, 3)
    np.testing.assert_array_equal(t.view_pose, j.view_pose)


def test_clicks_samples_and_stats_match_jax(labelers):
    j, t = (copy.copy(lab) for lab in labelers)
    j.samples, t.samples = {}, {}
    rng = np.random.default_rng(4)
    clicks = _surface_clicks(t, rng, 24) + [(0, 0, 0), (1, -3, 5), (2, 320, 10),
                                            (3, 5.7, 239.9), (4, 100, 240)]
    for k, (vi, x, y) in enumerate(clicks):
        name = NAMES[k % 4]
        np.testing.assert_array_equal(np.asarray(t.backproject(vi, x, y), float),
                                      np.asarray(j.backproject(vi, x, y), float))
        assert t.add_sample(name, vi, x, y) == j.add_sample(name, vi, x, y)
    assert sum(map(len, t.samples.values())) >= 24
    assert t.samples.keys() == j.samples.keys()
    for n in t.samples:
        np.testing.assert_array_equal(np.stack(t.samples[n]), np.stack(j.samples[n]))
    for m in (1, 3, 7):
        st, sj = t.kp_stats(m), j.kp_stats(m)
        assert st.keys() == sj.keys()
        for n in st:
            np.testing.assert_array_equal(st[n][0], sj[n][0])
            np.testing.assert_array_equal(st[n][1], sj[n][1])
    with pytest.raises(AssertionError, match="Unknown keypoint"):
        t.add_sample("no_such_kp", 0, 0, 0)


def _inspection_samples(rng):
    """Keypoints with 3-6 samples spread from 0 (a point ellipse) to 60 mm
    (past the image), and one far off to the side (its dot outside)."""
    out = {}
    for k, spread in enumerate((0.0, 1e-3, 0.4, 3.0, 15.0, 60.0)):
        mean = rng.uniform(-30, 30, 3) + (400.0 * (k == 5), 0, 0)
        out[NAMES[k]] = list(mean + spread * rng.normal(size=(3 + k % 4, 3)))
    return out


@pytest.mark.parametrize("keys", ["", "wwaaiio", "ssdddoooo"])
def test_render_inspection_is_bit_equal_to_jax_drawn_by_cv2(labelers, keys):
    j, t = labelers
    samples = _inspection_samples(np.random.default_rng(5 + len(keys)))
    for lab in (j, t):
        lab.samples = {n: list(p) for n, p in samples.items()}
        lab.view_pose = lab.view_poses[0].copy()
    for k in keys:
        j.view_pose = jlab.adjust_view_pose(j.view_pose, k)
        t.view_pose = tlab.adjust_view_pose(t.view_pose, k)
    img_t, ok_t = t.render_inspection()
    img_j, ok_j = j.render_inspection()
    assert ok_t and ok_j
    assert img_t.shape == (240, 640, 3)
    np.testing.assert_array_equal(img_t, img_j)
    assert (img_t[:, :320] != img_t[:, 320:]).any()  # the ellipses were drawn
    # a keypoint short of samples: not accepted, and drawn as JAX draws it
    for lab in (j, t):
        lab.samples[NAMES[5]] = lab.samples[NAMES[5]][:1]
    (img_t, ok_t), (img_j, ok_j) = t.render_inspection(), j.render_inspection()
    assert not ok_t and not ok_j
    np.testing.assert_array_equal(img_t, img_j)


def test_save_and_load_match_jax_byte_for_byte(labelers, tmp_path):
    j, t = labelers
    samples = _inspection_samples(np.random.default_rng(9))
    for lab in (j, t):
        lab.samples = {n: list(p) for n, p in samples.items()}
        lab.view_pose = tlab.adjust_view_pose(lab.view_poses[2], "a")
    pt, pj = tmp_path / "t" / "obj_000001_kp_info.json", tmp_path / "j" / "kp.json"
    assert t.save(str(pt)) == j.save(str(pj))
    assert pt.read_bytes() == pj.read_bytes()
    vp = np.eye(4)
    assert t.save(str(pt), view_pose=vp, min_samples=5) == j.save(str(pj), view_pose=vp,
                                                                   min_samples=5)
    assert pt.read_bytes() == pj.read_bytes()
    (kt, vt), (kj, vj) = tlab.load_kp_info(str(pt)), jlab.load_kp_info(str(pt))
    np.testing.assert_array_equal(vt, vj)
    assert kt.keys() == kj.keys()
    for n in kt:
        np.testing.assert_array_equal(kt[n][0], kj[n][0])
        np.testing.assert_array_equal(kt[n][1], kj[n][1])
    t.samples = {}
    with pytest.raises(AssertionError, match="enough samples"):
        t.save(str(pt))


# ----------------------------------------------------------------- session --
def _jax_panel(lab, names, idx):
    """The JAX CLI's `redraw` image."""
    panel = lab.render_panel()[..., ::-1].copy()
    ns = len(lab.samples.get(names[idx], []))
    cv2.putText(panel, f"[{idx + 1}/{len(names)}] {names[idx]} "
                f"({ns} samples; >=3 to save)", (8, 16), cv2.FONT_HERSHEY_PLAIN, 1.0,
                (0, 255, 0), 1)
    return panel


def test_scripted_session_matches_the_jax_labeler(labelers, tmp_path, capsys):
    """Clicks on every view, a missed click, undo, n / p / digits, an
    inspection refused (a keypoint short of samples) and left with Esc, a
    second one with w / a / s / d / i / o accepted with Enter, a save, q."""
    j, t = (copy.copy(lab) for lab in labelers)
    for lab in (j, t):
        lab.samples, lab.view_pose = {}, lab.view_poses[0].copy()
    s = LabelSession(t, NAMES, str(tmp_path / "kp_info" / "obj_000001_kp_info.json"))
    h, w = t.hw
    rng = np.random.default_rng(6)

    def click_view(vi):
        ys, xs = np.nonzero(t.depths[vi] > 0)
        k = int(rng.integers(len(xs)))
        return (vi % 4) * w + int(xs[k]), (vi // 4) * h + int(ys[k])

    def both_click(x, y):
        s.click(x, y)
        j.add_sample(NAMES[s.kp_idx], (y // h) * 4 + x // w, x % w, y % h)

    np.testing.assert_array_equal(s.image(), _jax_panel(j, NAMES, 0))
    for vi in range(8):  # keypoint 0 on every view
        both_click(*click_view(vi))
    both_click(2, 2)  # off the surface: missed
    s.key("u")
    j.samples[NAMES[0]].pop()
    for k in "nnp":
        s.key(k)
    assert s.kp_idx == 1
    both_click(*click_view(3))  # one sample of keypoint 1: inspection refused
    np.testing.assert_array_equal(s.image(), _jax_panel(j, NAMES, 1))
    s.key("3")
    for vi in (0, 5, 6):
        both_click(*click_view(vi))
    s.key("v")
    s.key("w")
    j.view_pose = jlab.adjust_view_pose(j.view_pose, "w")
    np.testing.assert_array_equal(s.image(), j.render_inspection()[0][..., ::-1])
    s.key("\r")  # refused: keypoint 1 has one sample
    assert s.inspection is not None
    s.key("\x1b")
    assert s.inspection is None
    s.key("1")
    for vi in (2, 7):  # keypoint 1 up to 3 samples
        both_click(*click_view(vi))
    s.key("v")
    for k in "wasdio":
        s.key(k)
        j.view_pose = jlab.adjust_view_pose(j.view_pose, k)
    np.testing.assert_array_equal(s.image(), j.render_inspection()[0][..., ::-1])
    s.key("\r")
    assert s.inspection is None
    s.key("s")
    s.key("q")
    assert s.done
    out = capsys.readouterr().out
    assert out.count("added") == 14 and "MISSED surface" in out and "ERROR" in out
    assert "Accepted view_pose" in out and "Saved" in out
    np.testing.assert_array_equal(t.view_pose, j.view_pose)
    assert t.samples.keys() == j.samples.keys()
    for n in t.samples:
        np.testing.assert_array_equal(np.stack(t.samples[n]), np.stack(j.samples[n]))
    j.save(str(tmp_path / "jax.json"))
    assert (tmp_path / "kp_info" / "obj_000001_kp_info.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert len(json.loads((tmp_path / "jax.json").read_text())["keypoints"]) == 3
