"""The port's training augmentations (`suo_slam_tpu_torch/data/augmentations.py`,
numpy) against the JAX package's (OpenCV 5.0 warps, Pillow 12.1 filters),
on frames made from a seed: 64x80, and 480x640 for the warp.

Held per augmentation and for the whole stack (`apply_augs`):
- the draws: the same values, and the stream's next draw equal afterwards;
- K and the boxes to 1e-12 relative;
- the warp, Brightness, Color, Contrast and Sharpness bit-equal, or at most
  1 level apart on at most 0.1% of the values; the blur at most 1 level
  apart on at most 1%; the warped depth equal on at least 99.9% of the
  pixels.
Measured on this machine: every stage bit-equal (the warp, its depth and
the blur included) on every seed and frame here; K and boxes exactly equal.
The stack is held stage by stage: each stage is fed the JAX package's
output of the stage before, since Contrast and Sharpness factors up to 50
would turn one level into tens.

Whole samples: `BopDataset.get_raw` of an augmented `train_real` split
(`gt+noise` boxes, `mask_occluded`, priors): every key equal to the JAX
package's, the image too (measured bit-equal). Also: no module of the port
and not `chip_smoke.py` imports cv2, PIL or matplotlib.
"""

import copy
import os

import numpy as np
import pytest

from suo_slam_tpu.data import augmentations as ja
from suo_slam_tpu.data import bop as jbop
from suo_slam_tpu_torch.data import augmentations as ta
from suo_slam_tpu_torch.data import bop as tbop
from tests.helpers.synthetic_bop import write_synthetic_bop
from tests.test_torch_import import PKG, REPO, _imports

LEVEL_FRAC = {"warp": 1e-3, "enhance": 1e-3, "blur": 1e-2}
DEPTH_AGREE = 0.999


def _frame(rng, h, w):
    """A textured uint8 BGR frame: smooth blobs plus noise, so that flat
    areas and edges both occur."""
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    base = np.stack([np.sin(6 * xx + c) * np.cos(4 * yy - c) for c in range(3)], -1)
    img = 127.5 + 100 * base + rng.normal(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(20)
    out = {}
    for hw in ((64, 80), (480, 640)):
        h, w = hw
        depth = rng.uniform(300, 2000, hw).astype(np.float32)
        depth[rng.uniform(size=hw) < 0.2] = 0.0
        K = np.array([[1066.8, 0.0, w / 2 - 0.3], [0.0, 1067.5, h / 2 + 1.7], [0, 0, 1.0]])
        x1 = rng.uniform(0, w / 2, 5)
        y1 = rng.uniform(0, h / 2, 5)
        boxes = np.stack([x1, y1, x1 + rng.uniform(10, w / 2, 5),
                          y1 + rng.uniform(10, h / 2, 5)], -1).astype(np.float32)
        out[hw] = (_frame(rng, h, w), depth, boxes, K)
    return out


def _close_levels(a, b, frac, what):
    """Bit-equal, or at most 1 level apart on at most `frac` of the values."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, what
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= frac, (what, int(d.max()), (d > 0).mean())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _gen(seed_or_state):
    """A generator from a seed, or one standing at a saved stream state."""
    if isinstance(seed_or_state, dict):
        g = np.random.default_rng()
        g.bit_generator.state = copy.deepcopy(seed_or_state)
        return g
    return np.random.default_rng(seed_or_state)


def _stage(ja_aug, ta_aug, seed, x, kind):
    """One augmentation on the same input and stream (a seed or a saved
    state) in both packages: the outputs within `kind`'s tolerance, the
    streams at the same place after. Returns JAX's output (the next stage's
    input)."""
    rj, rt = _gen(seed), _gen(seed)
    oj = ja_aug(rj, *copy.deepcopy(x))
    ot = ta_aug(rt, *copy.deepcopy(x))
    assert rj.uniform() == rt.uniform(), "the draws differ"
    _close_levels(np.asarray(oj[0]), ot[0], LEVEL_FRAC[kind], kind)
    if oj[1] is not None:
        assert (oj[1] == ot[1]).mean() >= DEPTH_AGREE
    if oj[2] is not None:
        assert ot[2].dtype == oj[2].dtype and _rel(ot[2], oj[2]) <= 1e-12
    if oj[3] is not None:
        assert _rel(ot[3], oj[3]) <= 1e-12
    return tuple(np.array(v) if v is not None else None for v in oj)


@pytest.mark.parametrize("hw", [(64, 80), (480, 640)])
def test_scale_and_rotate_matches_jax(frames, hw):
    """The warp (scale, rotation, the 180-degree flip), its nearest depth,
    K' = T @ K and the boxes, over seeds that take both flip branches."""
    x = frames[hw]
    for seed in range(6 if hw == (64, 80) else 3):
        _stage(ja.ScaleAndRotate(), ta.ScaleAndRotate(), seed, x, "warp")


def test_rotation_matrix_equals_cv2():
    import cv2

    for ang, s in ((3.7, 1.2), (-184.2, 1.0), (0.0, 1.49)):
        want = cv2.getRotationMatrix2D((319.5, 239.5), ang, s)
        assert _rel(ta.rotation_matrix_2d((319.5, 239.5), ang, s), want) <= 1e-12


def test_blur_matches_jax(frames):
    """p = 1: every radius of the interval, drawn by the stream."""
    x = frames[(64, 80)]
    radii = set()
    for seed in range(8):
        rng = np.random.default_rng(seed)
        rng.uniform()
        radii.add(int(rng.integers(1, 4)))
        _stage(ja.Blur(p=1.0), ta.Blur(p=1.0), seed, x, "blur")
    assert radii == {1, 2, 3}


@pytest.mark.parametrize("name", ["Sharpness", "Contrast", "Brightness", "Color"])
def test_enhancers_match_jax(frames, name):
    """Each enhancer with p = 1 over its whole factor interval (the draws
    reach both sides of 1, where Pillow's blend clips)."""
    for hw in ((64, 80), (480, 640)):
        x = frames[hw]
        for seed in range(5 if hw == (64, 80) else 1):
            _stage(getattr(ja, name)(p=1.0), getattr(ta, name)(p=1.0), seed, x, "enhance")
    # coins: p = 0.3 both ways, the factor drawn only where it applies
    for seed in range(6):
        _stage(getattr(ja, name)(), getattr(ta, name)(), seed, frames[(64, 80)], "enhance")


def test_apply_augs_matches_jax_stage_by_stage(frames):
    """The default stack: `p_any` first, then each augmentation's coin and
    its factor where it applies, in the JAX package's order; each stage
    within its tolerance given JAX's previous output; the stream after the
    sample at JAX's place; and the port's own whole-stack result (measured
    bit-equal)."""
    x = frames[(64, 80)]
    kinds = ["warp", "blur", "enhance", "enhance", "enhance", "enhance"]
    n_applied = 0
    for seed in range(24):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        want = ja.apply_augs(ja.default_train_augs(), rj, *copy.deepcopy(x))
        got = ta.apply_augs(ta.default_train_augs(), rt, *copy.deepcopy(x))
        assert rj.uniform() == rt.uniform()
        assert np.array_equal(np.asarray(want[0]), got[0]), seed
        assert np.array_equal(want[1], got[1]) and np.array_equal(want[3], got[3])
        # the same stream, replayed a stage at a time
        r = np.random.default_rng(seed)
        if not r.uniform() < 0.8:
            continue
        n_applied += 1
        y = x
        for aj, at, kind in zip(ja.default_train_augs(), ta.default_train_augs(), kinds):
            state = copy.deepcopy(r.bit_generator.state)
            nxt = _stage(aj, at, state, y, kind)
            aj(r, *copy.deepcopy(y))  # advance r past this stage's draws
            y = nxt
    assert 10 <= n_applied < 24


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("aug_bop") / "bop_datasets" / "ycbv")
    write_synthetic_bop(r, n_scenes=1, n_views=15, hw=(64, 80), splits=("train_real",),
                        obj2_continuous_sym=False)
    return r


def test_augmented_samples_equal_jax(train_root):
    """`get_raw` with the stack on: K, uv_gt, kp_mask, boxes, the prior
    draws, the depth-based occlusion mask and the image equal the JAX
    package's, for several item seeds of each frame."""
    kw = dict(bop_dset="ycbv", no_aug=False, det_type="gt+noise", ignore_symmetry=False,
              mask_occluded=True, kp_config_root=os.path.join(train_root, "kp_configs"), seed=3)
    dj, dt = jbop.BopDataset(train_root, "train_real", **kw), \
        tbop.BopDataset(train_root, "train_real", **kw)
    assert len(dt) == len(dj) == 3 and dt.augs and dj.augs
    moved = 0
    for i in range(len(dt)):
        for seed in range(4):
            a, b = dj.sample_seeded(i, seed), dt.sample_seeded(i, seed)
            assert set(a) == set(b)
            for k in a:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (k, i, seed)
            frame = dt.data[b["scene_id"]][b["view_id"]]
            moved += not np.array_equal(b["K"], frame.K.astype(np.float32))
    assert moved >= 4  # the warp ran on some samples


def test_the_port_imports_no_image_library():
    """Nothing of the port and not chip_smoke.py imports cv2, PIL or
    matplotlib: the card's machine has none of them."""
    bad_roots = ("cv2", "PIL", "matplotlib")
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    bad = [(f, m) for f in files for m in _imports(f) if m.split(".")[0] in bad_roots]
    assert not bad, bad
