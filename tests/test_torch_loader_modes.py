"""The training loader's process mode (`ConcatLoader(mode="process")`,
`--loader process`) against its thread mode and the JAX package's loader,
with augmentations on, on a 64x80 `synthetic_bop` fixture: every batch of
two epochs and of the validation epoch's fixed stream bit-equal, since each
sample's draws are seeded per (epoch, item) whatever the mode and the
number of workers. Also: a worker process imports neither torch nor the
JAX package; a sample that raises in a worker raises in the consumer, and a
worker that dies raises `BrokenProcessPool` (no switch back to threads).
"""

import os
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest

from suo_slam_tpu.data import bop as jbop
from suo_slam_tpu.data.loader import ConcatLoader as JaxLoader
from suo_slam_tpu_torch.data import bop as tbop
from suo_slam_tpu_torch.data.loader import ConcatLoader
from tests.helpers import loader_faults
from tests.helpers.synthetic_bop import write_synthetic_bop


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("loader_bop") / "bop_datasets" / "ycbv")
    write_synthetic_bop(r, n_scenes=2, n_views=10, hw=(64, 80), splits=("train_real", "test"),
                        obj2_continuous_sym=False)
    return r


def _datasets(pkg, root):
    kw = dict(bop_dset="ycbv", det_type="gt+noise", ignore_symmetry=False, mask_occluded=True,
              kp_config_root=os.path.join(root, "kp_configs"))
    # the test split takes no augmentations in either package ("train" not in it)
    return [pkg.BopDataset(root, "train_real", seed=123, **kw),
            pkg.BopDataset(root, "test", seed=124, **kw)]


def _epochs(loader):
    out = [list(loader.epoch()) for _ in range(2)]
    out.append(list(loader.epoch(shuffle=False, seed=666)))
    return out


def _equal(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for x, y in zip(ea, eb):
            assert set(x) == set(y)
            for k in x:
                assert np.array_equal(x[k], y[k]), k


def test_process_batches_equal_threads_and_jax(root):
    jl = JaxLoader(_datasets(jbop, root), 3, 2, seed=5, workers=3)
    thr = ConcatLoader(_datasets(tbop, root), 3, 2, seed=5, workers=3)
    prc = ConcatLoader(_datasets(tbop, root), 3, 2, seed=5, workers=2, mode="process")
    assert prc.datasets[0].augs and jl.datasets[0].augs
    try:
        want, t, p = _epochs(jl), _epochs(thr), _epochs(prc)
    finally:
        prc.close()
    assert len(want[0]) == len(thr) == 8  # 4 + 20 frames, batches of 3
    _equal(t, want)
    _equal(p, want)


def test_workers_import_neither_torch_nor_jax(root):
    prc = ConcatLoader(_datasets(tbop, root), 3, 2, workers=2, mode="process")
    try:
        assert prc._process_pool().submit(loader_faults.imported).result(timeout=120) == []
    finally:
        prc.close()


@pytest.mark.parametrize("how, error", [("raise", RuntimeError), ("die", BrokenProcessPool)])
def test_a_failing_worker_raises_in_the_consumer(how, error):
    loader = ConcatLoader([loader_faults.FailingDataset(8, how)], 2, 2, workers=2,
                          mode="process")
    try:
        with pytest.raises(error):
            for _ in loader.epoch():
                pass
    finally:
        loader.close()


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="loader mode"):
        ConcatLoader([], 2, 2, mode="fork")
