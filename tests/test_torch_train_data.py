"""The training side of the port's data path against the JAX package's, on
the `synthetic_bop` fixture (no augmentation): `BopDataset` training samples
(`gt+noise` boxes, `p_give_prior` 0.5 with random symmetries and noisy
priors, `sample_seeded`, `map_by="obj_<id>"`), `collate` and whole
`ConcatLoader` epochs, in line and with threads — bit-equal, since both
sides draw from the same numpy streams in the same order. The fixture's
symmetries are discrete (the discretized continuous ones are f32 rotations
that agree within 1e-6, `tests/test_torch_bop.py`). Also: each refusal the
training path keeps names an item that ROADMAP.md lists.
"""

import os
import pickle
import re

import numpy as np
import pytest

from suo_slam_tpu.data import bop as jbop
from suo_slam_tpu.data.loader import ConcatLoader as JaxLoader
from suo_slam_tpu_torch.data import bop as tbop
from suo_slam_tpu_torch.data.loader import ConcatLoader
from tests.helpers.synthetic_bop import write_synthetic_bop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("train_bop") / "bop_datasets" / "ycbv")
    write_synthetic_bop(r, n_scenes=2, n_views=10, splits=("train_real", "test"),
                        obj2_continuous_sym=False)
    return r


def _pair(root, split="train_real", seed=123, **kw):
    kw = dict(bop_dset="ycbv", no_aug=True, det_type="gt+noise", ignore_symmetry=False,
              kp_config_root=os.path.join(root, "kp_configs"), seed=seed, **kw)
    return jbop.BopDataset(root, split, **kw), tbop.BopDataset(root, split, **kw)


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_training_samples_bit_equal_to_jax(root):
    dj, dt = _pair(root)
    assert len(dj) == len(dt) == 4  # YCB-V train_real keeps every 5th frame
    assert dj.view_index == dt.view_index and dj.object_index == dt.object_index
    n_prior = 0
    for i in range(len(dt)):
        for seed in (0, 7):
            a, b = dj.sample_seeded(i, seed), dt.sample_seeded(i, seed)
            _equal(a, b)
            n_prior += int(b["has_prior"].sum())
    assert 0 < n_prior  # the give-prior coin fell both ways
    # the thread streams without pinning, then after reset_rng
    for d in (dj, dt):
        d.reset_rng()
    _equal(dj[1], dt[1])
    _equal(dj[2], dt[2])


def test_single_object_samples_and_pickling(root):
    dj, dt = _pair(root, map_by="obj_3")
    assert len(dj) == len(dt) and all(o == 3 for _, _, o in dt.object_index)
    _equal(dj.sample_seeded(0, 3), dt.sample_seeded(0, 3))
    clone = pickle.loads(pickle.dumps(dt))
    _equal(clone.sample_seeded(1, 5), dt.sample_seeded(1, 5))


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_epochs_bit_equal_to_jax(root, workers):
    pairs = [_pair(root, seed=123), _pair(root, "test", seed=124)]
    jl = JaxLoader([p[0] for p in pairs], 3, 2, seed=5, workers=workers)
    tl = ConcatLoader([p[1] for p in pairs], 3, 2, seed=5, workers=workers)
    assert len(jl) == len(tl) and jl.total == tl.total
    for ep in range(2):
        jb, tb = list(jl.epoch()), list(tl.epoch())
        assert len(jb) == len(tb) == len(tl)
        for a, b in zip(jb, tb):
            _equal(a, b)
    _equal(next(iter(jl.epoch(shuffle=False, seed=666))),
           next(iter(tl.epoch(shuffle=False, seed=666))))
    # truncation kept a random sorted subset of 2 of the frames' 3 objects
    assert b["obj_mask"].shape[1] == 2


def test_collate_pads_object_slots(root):
    _, dt = _pair(root)
    samples = [dt.sample_seeded(0, 1), dt.sample_seeded(1, 1)]
    samples[1] = {k: (v[:1] if isinstance(v, np.ndarray) and v.ndim and k not in
                      ("img", "K") else v) for k, v in samples[1].items()}
    out = tbop.collate(samples, truncate_obj=16)
    assert out["obj_mask"].tolist() == [[True] * 3, [True, False, False]]
    assert not out["prior_mask"][1, 1:].any() and not out["kp_mask"][1, 1:].any()
    _equal(out, jbop.collate(samples, truncate_obj=16))


def _roadmap_has(item: str) -> bool:
    return bool(re.search(rf"\*\*{item}[ .]", open(os.path.join(REPO, "ROADMAP.md")).read()))


def test_training_refusals_name_roadmap_items(root, monkeypatch, tmp_path):
    """What the training path still refuses names its ROADMAP item: pbr
    splits (A22), VOC backgrounds (A21) and more than one visible card
    (A15). Augmentations, `--use_cache`, `--loader process` and `-u` train
    (`tests/test_torch_augmentations.py`, `test_torch_fastload.py`,
    `test_torch_loader_modes.py`, `test_torch_train_u.py`)."""
    import torch

    from suo_slam_tpu_torch.train import __main__ as cli

    kw = dict(bop_dset="ycbv", kp_config_root=os.path.join(root, "kp_configs"))
    msgs = []
    with pytest.raises(NotImplementedError) as e:                              # A22
        tbop.BopDataset(root, "train_pbr", no_aug=True, **kw)
    msgs.append(str(e.value))
    bg = tmp_path / "voc"
    bg.mkdir()
    (bg / "0001.png").write_bytes(b"")
    monkeypatch.setenv("SUO_BG_IMAGES_DIR", str(bg))
    with pytest.raises(NotImplementedError) as e:                              # A21
        tbop.BopDataset(root, "train_synt", no_aug=True, **kw)
    msgs.append(str(e.value))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit) as e:                                       # A15
        cli._refuse(torch.device("cuda"))
    msgs.append(str(e.value))
    cli._refuse(torch.device("cpu"))  # the CPU is one device
    items = [re.search(r"ROADMAP (A\d+)", m).group(1) for m in msgs]
    assert items == ["A22", "A21", "A15"]
    assert all(_roadmap_has(i) for i in items), items
