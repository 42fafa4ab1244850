"""The port's synthetic training splits against the JAX package's, on the
`synthetic_bop` fixture with a VOC directory of JPEGs beside it
(`tests/helpers/jpeg_bop.py`): `BopDataset.get_raw` with augmentations on,
`gt+noise` boxes and random priors, for the same seeds, on

- YCB-V `train_synt` (the background written where the depth is 0), with
  and without `mask_occluded`;
- T-LESS `train_primesense` (the background off the object's mask, and 0-2
  occluder crops pasted near the box);
- YCB-V `train_pbr` (JPEG frames, no compositing).

Every key of every sample must be equal to the JAX package's: the image
too, since the decoder and `resize_linear` are bit-equal to OpenCV's (held
in `tests/test_torch_jpeg.py`). Also: the frame cache's gather and the
process loader on composited splits (batches equal to the thread loader's
and JAX's, the cache file's bytes unchanged), and the training CLI on
`--data_split real+synt` with VOC present and on `--data_split pbr
--use_cache`.
"""

import hashlib
import os

import numpy as np
import pytest

from suo_slam_tpu.data import bop as jbop
from suo_slam_tpu.data import fastload as jfl
from suo_slam_tpu_torch.data import bop as tbop
from suo_slam_tpu_torch.data import fastload as tfl
from suo_slam_tpu_torch.data.loader import ConcatLoader
from tests.helpers.jpeg_bop import write_pbr_split, write_voc
from tests.helpers.synthetic_bop import write_synthetic_bop
from tests.helpers.threads import one_torch_thread  # noqa: F401 (autouse)

HW = (96, 128)


@pytest.fixture(scope="module")
def ycbv(tmp_path_factory):
    bop_root = tmp_path_factory.mktemp("bg_port") / "bop_datasets"
    root = str(bop_root / "ycbv")
    write_synthetic_bop(root, n_scenes=1, n_views=5, hw=HW, obj2_continuous_sym=False,
                        splits=("train_real", "train_synt", "test"))
    write_pbr_split(root, "train_synt")
    write_voc(str(bop_root))
    return root


@pytest.fixture(scope="module")
def tless(tmp_path_factory):
    bop_root = tmp_path_factory.mktemp("bg_port_tless") / "bop_datasets"
    root = str(bop_root / "tless")
    write_synthetic_bop(root, n_scenes=1, n_views=3, hw=HW, bop_dset="tless",
                        obj2_continuous_sym=False, splits=("train_primesense",))
    write_voc(str(bop_root), n=4, seed=1)
    return root


def _pair(root, split, dset="ycbv", **kw):
    kw = dict(bop_dset=dset, det_type="gt+noise", ignore_symmetry=False,
              kp_config_root=os.path.join(root, "kp_configs"), seed=31, **kw)
    return jbop.BopDataset(root, split, **kw), tbop.BopDataset(root, split, **kw)


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("mask_occluded", [False, True])
def test_synt_composite_equals_jax(ycbv, mask_occluded):
    dj, dt = _pair(ycbv, "train_synt", mask_occluded=mask_occluded)
    assert dt.augs and len(dt.bg_image_files) == 8
    assert dt.bg_image_files == dj.bg_image_files
    bright = 0
    for i in range(len(dt)):
        for seed in (0, 5, 9):
            a, b = dj.sample_seeded(i, seed), dt.sample_seeded(i, seed)
            _equal(a, b)
            bright += float(b["img"][:4, :4].mean()) > 0.2  # the fixture's off-object is 30
    assert bright >= 5  # backgrounds landed (most corners are left unwarped)
    # the streams stand where JAX's stand after the samples
    assert dj.rng.integers(2 ** 31) == dt.rng.integers(2 ** 31)


def test_tless_primesense_pastes_equal_jax(tless, monkeypatch):
    dj, dt = _pair(tless, "train_primesense", dset="tless", map_by="obj")
    assert len(dt.bg_image_files) == 4
    reads = []
    read_img = tbop.BopDataset.read_img
    monkeypatch.setattr(tbop.BopDataset, "read_img",
                        lambda self, s, v: reads.append((s, v)) or read_img(self, s, v))
    for i in range(len(dt)):
        for seed in (1, 2, 3):
            _equal(dj.sample_seeded(i, seed), dt.sample_seeded(i, seed))
    # each sample reads its frame once plus one frame per occluder drawn
    n = 3 * len(dt)
    assert len(reads) > n + 3, (len(reads), n)


def test_pbr_split_reads_jpeg_and_equals_jax(ycbv):
    dj, dt = _pair(ycbv, "train_pbr")
    assert dt.bg_image_files == [] and len(dt) == len(dj) == 5
    assert dt.view_index == dj.view_index and dt.object_index == dj.object_index
    path = os.path.join(ycbv, "train_pbr", "000000", "rgb", "000000.jpg")
    assert open(path, "rb").read(2) == b"\xff\xd8"
    for i in range(len(dt)):
        _equal(dj.sample_seeded(i, 4), dt.sample_seeded(i, 4))


def _sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_cache_gather_composites_a_copy(ycbv, tmp_path):
    """The frame cache packs the same bytes as JAX's (JPEG frames of the pbr
    split too); composited epochs equal JAX's and leave the file as it
    was."""
    for split in ("train_synt", "train_pbr"):
        dj, dt = _pair(ycbv, split, no_aug=True)
        pj, pt = str(tmp_path / f"j_{split}.suocache"), str(tmp_path / f"t_{split}.suocache")
        jfl.pack_cache(dj, pj)
        tfl.pack_cache(dt, pt)
        assert _sha(pj) == _sha(pt)
    dj, dt = _pair(ycbv, "train_synt")
    pj, pt = str(tmp_path / "j_train_synt.suocache"), str(tmp_path / "t_train_synt.suocache")
    before = _sha(pt)
    lj = jfl.CacheLoader(dj, pj, 2, truncate_obj=3, seed=8, n_threads=2)
    lt = tfl.CacheLoader(dt, pt, 2, truncate_obj=3, seed=8, n_threads=2)
    try:
        for _ in range(2):
            for a, b in zip(lj.epoch(), lt.epoch()):
                _equal(a, b)
    finally:
        lt.close()
    assert _sha(pt) == before


def test_process_loader_first_batch_equals_threads(ycbv):
    def loader(mode):
        ds = [_pair(ycbv, "train_synt")[1], _pair(ycbv, "train_pbr")[1]]
        return ConcatLoader(ds, 3, 3, seed=2, workers=2, mode=mode)

    thr, prc = loader("thread"), loader("process")
    try:
        a, b = next(iter(thr.epoch())), next(iter(prc.epoch()))
    finally:
        prc.close()
    _equal(a, b)


@pytest.mark.parametrize("split, extra", [("real+synt", []), ("pbr", ["--use_cache"])])
def test_training_cli_on_the_default_splits(ycbv, tmp_path, monkeypatch, split, extra):
    from suo_slam_tpu_torch.train import __main__ as cli

    monkeypatch.setenv("SUO_TINY_NET", "1")
    monkeypatch.chdir(tmp_path)
    cache = os.path.join(ycbv, "train_pbr.suocache")
    rc = cli.main(["--device", "cpu", "--dataset", "ycbv", "--data_split", split, *extra,
                   "--epochs", "1", "--steps_per_epoch", "1", "--batch_size", "2",
                   "--no_val", "--no_bf16", "--truncate_obj", "3", "--workers", "2",
                   "--data_root", ycbv, "--kp_config_root", os.path.join(ycbv, "kp_configs")])
    assert rc == 0
    (run,) = os.listdir(tmp_path / "results")
    assert os.path.isfile(tmp_path / "results" / run / "checkpoint-0")
    if extra:
        before = _sha(cache)
        loader = tfl.CacheLoader(_pair(ycbv, "train_pbr")[1], cache, 2, 3, seed=1)
        try:
            list(loader.epoch())
        finally:
            loader.close()
        assert _sha(cache) == before
