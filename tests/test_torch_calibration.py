"""The covariance calibration check in the port (`eval/calibration.py`,
`python -m suo_slam_tpu_torch.plot_cov`, the PNG writer beside
`data/png.py`'s reader) against the JAX package's (`eval/calibration.py`,
the root `plot_cov.py`).

- `cov_chi2`, `pct_inbounds` and `CHI2_99_2DOF` equal the JAX functions'
  to 1e-12 (nan for no keypoints);
- the port's `plot_cov` on the CPU writes `percent_sigma_inbounds.txt` and
  `sigma_plot.png`; on the same JAX-format checkpoint (a tiny net, its last
  head scaled up so that the heatmaps are peaked and many errors fall
  outside the bound) and `synthetic_bop` fixture, the keypoint count equals
  the JAX CLI's and the percentage lies within one keypoint's share of it;
- `png.imwrite` writes what `cv2.imread` reads back bit for bit.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from suo_slam_tpu.eval import calibration as jcal
from suo_slam_tpu_torch import plot_cov as tplot
from suo_slam_tpu_torch.data import png
from suo_slam_tpu_torch.eval import calibration as tcal
from tests.helpers.synthetic_bop import write_synthetic_bop
from tests.helpers.threads import one_torch_thread  # noqa: F401 (autouse)


def test_chi2_and_share_equal_jax():
    rng = np.random.default_rng(3)
    uv, gt = rng.normal(size=(5, 41, 2)), rng.normal(size=(5, 41, 2))
    a = rng.uniform(0.01, 2.0, (5, 41))
    b = rng.uniform(-0.5, 0.5, (5, 41)) * a
    cov = np.stack([np.stack([a, b], -1), np.stack([b, a * 1.3], -1)], -2).astype(np.float32)
    cov[0, 0] = 0.0  # a degenerate covariance takes the 1e-12 floor
    want, got = jcal.cov_chi2(uv, cov, gt), tcal.cov_chi2(uv, cov, gt)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert tcal.CHI2_99_2DOF == jcal.CHI2_99_2DOF
    for bound in (tcal.CHI2_99_2DOF, 1.0):
        assert abs(tcal.pct_inbounds(got, bound) - jcal.pct_inbounds(want, bound)) <= 1e-12
    assert np.isnan(tcal.pct_inbounds([])) and np.isnan(jcal.pct_inbounds([]))


@pytest.mark.parametrize("img", [
    np.random.default_rng(0).integers(0, 256, (7, 9, 3), dtype=np.uint8),
    np.random.default_rng(1).integers(0, 256, (5, 4), dtype=np.uint8),
    np.random.default_rng(2).integers(0, 65536, (3, 6), dtype=np.uint16),
])
def test_png_writer_round_trips_through_cv2(tmp_path, img):
    import cv2

    path = str(tmp_path / "x.png")
    png.imwrite(path, img)
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    flags = png.IMREAD_COLOR if img.ndim == 3 else png.IMREAD_ANYDEPTH
    assert np.array_equal(png.imread(path, flags), img)


def _result(out_dir):
    text = open(os.path.join(out_dir, "percent_sigma_inbounds.txt")).read()
    m = re.fullmatch(r"([\d.]+)% of (\d+) keypoint errors inside the 99% chi2 bound of the "
                     r"predicted covariance\n", text)
    assert m, text
    return float(m.group(1)), int(m.group(2))


def test_plot_cov_matches_the_jax_cli(tmp_path, monkeypatch):
    import plot_cov as jplot
    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.train import checkpoint as tck
    from suo_slam_tpu_torch.train import harness as th

    root = str(tmp_path / "bop_datasets" / "ycbv")
    write_synthetic_bop(root, n_scenes=1, n_views=15, hw=(96, 128), splits=("train_real",),
                        obj2_continuous_sym=False)
    monkeypatch.setenv("SUO_TINY_NET", "1")  # the JAX loader's tiny net
    net = PkpNet(n_stack=1, n_modules=1, features=16)
    state = th.init_state(net, seed=2)
    with torch.no_grad():
        net.backbone.heads[0].weight.mul_(40.0)
    ck = str(tmp_path / "run" / "checkpoint-3")
    tck.save_checkpoint(os.path.dirname(ck), state, 3, {"norm": "batch"}, 1.0)
    common = ["-c", ck, "--dataset", "ycbv", "--split", "train_real", "--data_root", root,
              "--kp_config_root", os.path.join(root, "kp_configs"), "--max_frames", "1"]
    monkeypatch.setattr(sys, "argv", ["plot_cov.py"] + common + ["--out", str(tmp_path / "j")])
    jplot.main()
    assert tplot.main(common + ["--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    (pj, nj), (pt, nt) = _result(tmp_path / "j"), _result(tmp_path / "t")
    assert nt == nj >= 8 and abs(pt - pj) <= 100.0 / nj + 0.005, (pt, pj, nj)
    assert 0.0 < pt < 100.0  # some errors fall outside the bound
    plot = png.imread(str(tmp_path / "t" / "sigma_plot.png"))
    assert plot.shape == tplot.PLOT_HW + (3,) and (plot < 250).any()
