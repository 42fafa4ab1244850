"""The port's frame cache (`suo_slam_tpu_torch/data/fastload.py`, its g++
library `native/fastload.cpp`, `--use_cache`) against the JAX package's on
a 64x80 `synthetic_bop` fixture: `pack_cache` writes the same bytes (with
and without depth maps), `CacheLoader` epochs with augmentations on give
the same batches, a failed g++ build and an index out of range raise, and
the training CLI trains from the cache.
"""

import os

import numpy as np
import pytest

from suo_slam_tpu.data import bop as jbop
from suo_slam_tpu.data import fastload as jfl
from suo_slam_tpu_torch.data import bop as tbop
from suo_slam_tpu_torch.data import fastload as tfl
from tests.helpers.synthetic_bop import write_synthetic_bop
from tests.helpers.threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("cache_bop") / "bop_datasets" / "ycbv")
    write_synthetic_bop(r, n_scenes=1, n_views=15, hw=(64, 80), splits=("train_real", "test"),
                        obj2_continuous_sym=False)
    return r


def _pair(root, **kw):
    kw = dict(bop_dset="ycbv", det_type="gt+noise", ignore_symmetry=False,
              kp_config_root=os.path.join(root, "kp_configs"), seed=11, **kw)
    return jbop.BopDataset(root, "train_real", **kw), tbop.BopDataset(root, "train_real", **kw)


@pytest.mark.parametrize("mask_occluded", [False, True])
def test_pack_cache_bytes_equal_jax(root, tmp_path, mask_occluded):
    dj, dt = _pair(root, mask_occluded=mask_occluded, no_aug=True)
    pj, pt = str(tmp_path / "j.suocache"), str(tmp_path / "t.suocache")
    jfl.pack_cache(dj, pj)
    tfl.pack_cache(dt, pt)
    a, b = open(pj, "rb").read(), open(pt, "rb").read()
    assert len(b) == 40 + 3 * (8 + 64 * 80 * 3 + (4 * 64 * 80 if mask_occluded else 0))
    assert a == b


def test_cache_loader_batches_equal_jax(root, tmp_path):
    dj, dt = _pair(root, mask_occluded=True)
    assert dt.augs
    pj, pt = str(tmp_path / "j.suocache"), str(tmp_path / "t.suocache")
    lj = jfl.CacheLoader(dj, pj, 2, truncate_obj=2, seed=4, n_threads=2)
    lt = tfl.CacheLoader(dt, pt, 2, truncate_obj=2, seed=4, n_threads=2)
    try:
        assert os.path.isfile(pt) and lt.total == lj.total == 3
        for _ in range(3):
            bj, bt = list(lj.epoch()), list(lt.epoch())
            assert len(bt) == len(bj) == 1
            for x, y in zip(bj, bt):
                assert set(x) == set(y)
                for k in x:
                    assert np.array_equal(x[k], y[k]), k
    finally:
        lt.close()


def test_gather_out_of_range_raises(root, tmp_path):
    _, dt = _pair(root, no_aug=True)
    r = tfl.CacheReader(tfl.pack_cache(dt, str(tmp_path / "t.suocache")))
    try:
        ids, imgs, depth = r.gather([2, 0])
        assert [tuple(v) for v in ids.tolist()] == [dt.view_index[2], dt.view_index[0]]
        assert depth is None
        assert np.array_equal(imgs[1], dt.read_img(*dt.view_index[0]))
        with pytest.raises(IndexError):
            r.gather([3])
    finally:
        r.close()


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "fastload.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tfl, "SOURCE", bad)
    monkeypatch.setattr(tfl, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fastload build failed"):
        tfl.build_library()
    assert not (tmp_path / "build" / "libfastload.so").exists()


def test_cli_trains_from_the_cache(root, tmp_path, monkeypatch):
    from suo_slam_tpu_torch.train import __main__ as cli

    monkeypatch.setenv("SUO_TINY_NET", "1")
    monkeypatch.chdir(tmp_path)
    cache = os.path.join(root, "train_real.suocache")
    if os.path.exists(cache):
        os.remove(cache)
    rc = cli.main(["--device", "cpu", "--dataset", "ycbv", "--data_split", "real",
                   "--use_cache", "--epochs", "1", "--steps_per_epoch", "1", "--no_val",
                   "--no_bf16", "--truncate_obj", "3", "--workers", "2", "--data_root", root,
                   "--kp_config_root", os.path.join(root, "kp_configs")])
    assert rc == 0 and os.path.isfile(cache)
    (run,) = os.listdir(tmp_path / "results")
    assert os.path.isfile(tmp_path / "results" / run / "checkpoint-0")
