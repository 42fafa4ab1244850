"""The port's BOP loader against the JAX package's on the `synthetic_bop`
fixture (YCB-V and T-LESS layouts): `BopDataset`'s evaluation surface, the
PNG reader against `cv2.imread`, the mesh DB, the symmetry stacks and the
saved-detection loaders. Everything here is host numpy, so equal means equal,
with one exception: the discretized continuous symmetries are f32 rotations
(cos and sin of numpy against XLA's, within 1e-6), so a sample whose pose
went through a symmetry pick (ignore_symmetry=False) agrees within 1e-5."""

import json
import os
import pickle
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.core import symmetry as jsym
from suo_slam_tpu.data import bop as jbop
from suo_slam_tpu.data import mesh as jmesh
from suo_slam_tpu.eval import detections as jdet
from suo_slam_tpu_torch.core import symmetry as tsym
from suo_slam_tpu_torch.data import bop as tbop
from suo_slam_tpu_torch.data import mesh as tmesh
from suo_slam_tpu_torch.data import png
from suo_slam_tpu_torch.eval import detections as tdet
from tests.helpers.synthetic_bop import write_synthetic_bop

SPLITS = {"ycbv": "test", "tless": "test_primesense"}


@pytest.fixture(scope="module", params=["ycbv", "tless"])
def layout(request, tmp_path_factory):
    dset = request.param
    root = str(tmp_path_factory.mktemp(f"bop_{dset}") / "bop_datasets" / dset)
    write_synthetic_bop(root, n_scenes=2, n_views=3, bop_dset=dset,
                        splits=(SPLITS[dset],))
    return dset, root


def _datasets(dset, root, ignore_symmetry=True):
    kw = dict(bop_dset=dset, ignore_symmetry=ignore_symmetry,
              kp_config_root=os.path.join(root, "kp_configs"))
    return (jbop.BopDataset(root, SPLITS[dset], seed=666, **kw),
            tbop.BopDataset(root, SPLITS[dset], **kw))


@pytest.mark.parametrize("ignore_symmetry", [True, False])
def test_dataset_index_and_samples_match_jax(layout, ignore_symmetry):
    dset, root = layout
    dj, dt = _datasets(dset, root, ignore_symmetry)
    assert dt.num_obj() == dj.num_obj() and len(dt) == len(dj)
    assert dt.scene_ids() == dj.scene_ids()
    assert dt.models_dir == dj.models_dir and dt.targets == dj.targets
    for name in ("kp_full", "kp_full_mask", "view_pose"):
        assert np.array_equal(getattr(dt, name), getattr(dj, name)), name
    n_obj = 0
    for s in dj.scene_ids():
        assert dt.view_ids(s) == dj.view_ids(s)
        assert np.array_equal(dt.get_cam_pose(s), dj.get_cam_pose(s))
        for v in dj.view_ids(s):
            assert dt.obj_ids(s, v) == dj.obj_ids(s, v)
            assert np.array_equal(dt.get_cam_pose(s, v), dj.get_cam_pose(s, v))
            assert np.array_equal(tbop._to44_cam(dt.get_cam_pose(s, v)),
                                  jbop._to44_cam(dj.get_cam_pose(s, v)))
            for o in dj.obj_ids(s, v) + [9]:
                assert dt.is_target(s, v, o) == dj.is_target(s, v, o)
            for o in dj.obj_ids(s, v):
                assert np.array_equal(dt.get_obj_pose(s, v, o), dj.get_obj_pose(s, v, o))
                assert np.array_equal(dt.read_mask(s, v, o), dj.read_mask(s, v, o))
            assert np.array_equal(dt.read_depth(s, v), dj.read_depth(s, v))
            ids = dj.obj_ids(s, v)
            rj = dj.get_raw(s, v, ids, p_give_prior=0.0)
            rt = dt.get_raw(s, v, ids, p_give_prior=0.0)
            assert rj.keys() == rt.keys()
            for k in rj:
                a, b = np.asarray(rj[k]), np.asarray(rt[k])
                assert a.dtype == b.dtype, (k, s, v)
                if ignore_symmetry or a.dtype != np.float32:
                    assert np.array_equal(a, b), (k, s, v)
                else:  # the picked symmetry's f32 rotation (see below)
                    np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=k)
            n_obj += len(ids)
    assert n_obj >= 12


def test_unported_sampling_raises(layout):
    """Random priors draw and augmentations run (the training side is
    ported); what the training side still refuses names its ROADMAP item:
    pbr splits, which are JPEG (A22)."""
    dset, root = layout
    _, dt = _datasets(dset, root)
    s = dt.scene_ids()[0]
    v = dt.view_ids(s)[0]
    r = dt.get_raw(s, v, dt.obj_ids(s, v), p_give_prior=1.0)
    assert r["has_prior"].all() and np.isfinite(r["prior_uvs"]).all()
    kw = dict(bop_dset=dset, kp_config_root=os.path.join(root, "kp_configs"))
    with pytest.raises(NotImplementedError, match="ROADMAP A22"):
        tbop.BopDataset(root, "train_pbr", no_aug=True, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP A22"):
        tbop.BopDataset(root, "train_pbr", **kw)


def test_png_reader_matches_cv2_on_the_fixture(layout):
    dset, root = layout
    n = 0
    for d, _, files in os.walk(os.path.join(root, SPLITS[dset])):
        for f in files:
            if not f.endswith(".png"):
                continue
            path = os.path.join(d, f)
            kind = os.path.basename(d)
            flags = {"rgb": png.IMREAD_COLOR, "depth": png.IMREAD_ANYDEPTH,
                     "mask_visib": png.IMREAD_GRAYSCALE}[kind]
            a, b = png.imread(path, flags), cv2.imread(path, flags)
            assert a.dtype == b.dtype and np.array_equal(a, b), path
            if kind == "rgb":  # a conversion the loader never asks for
                with pytest.raises(ValueError, match="not supported"):
                    png.imread(path, png.IMREAD_GRAYSCALE)
            n += 1
    assert n >= 6 * 3


def _encode(img, filters):
    """A PNG of img whose rows use the given filter types in turn."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    raw = img.astype(">u2").tobytes() if img.dtype == np.uint16 else img.tobytes()
    bpp = ch * img.dtype.itemsize
    rows = np.frombuffer(raw, np.uint8).reshape(h, w * bpp).astype(np.int32)
    out = []
    for r in range(h):
        t = filters[r % len(filters)]
        x, up = rows[r], rows[r - 1] if r else np.zeros(w * bpp, np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        p = a + up - c
        pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
        pred = [0 * x, a, up, (a + up) >> 1, paeth][t]
        out.append(bytes([t]) + ((x - pred) & 255).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, 0 if ch == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_png_reader_handles_every_row_filter(tmp_path, filters):
    """cv2 writes Sub rows only; these files use each filter (and a mix)."""
    rng = np.random.default_rng(len(filters) * 10 + filters[0])
    cases = [(rng.integers(0, 256, (19, 23, 3), dtype=np.uint8), png.IMREAD_COLOR),
             (rng.integers(0, 256, (11, 17), dtype=np.uint8), png.IMREAD_GRAYSCALE),
             (rng.integers(0, 65536, (13, 9), dtype=np.uint16), png.IMREAD_ANYDEPTH)]
    for i, (img, flags) in enumerate(cases):
        path = str(tmp_path / f"{i}.png")
        with open(path, "wb") as f:
            f.write(_encode(img, filters))
        a, b = png.imread(path, flags), cv2.imread(path, flags)
        assert a.dtype == b.dtype and np.array_equal(a, b), (filters, i)
        assert np.array_equal(png.decode(open(path, "rb").read()), img)


def test_mesh_db_matches_jax(layout):
    dset, root = layout
    models = os.path.join(root, "models_bop-compat" if dset == "ycbv" else "models_cad")
    for max_points in (4096, 32):  # 32: the seeded subsample
        mj = jmesh.load_mesh_db(models, max_points=max_points)
        mt = tmesh.load_mesh_db(models, max_points=max_points)
        assert mt.obj_ids == mj.obj_ids
        for name in ("diameter", "is_symmetric", "has_continuous_sym"):
            assert np.array_equal(getattr(mt, name), getattr(mj, name)), name
        for o in mj.obj_ids:
            assert np.array_equal(mt.points[o], mj.points[o])
            assert np.array_equal(mt.verts_full[o], mj.verts_full[o])
            assert np.array_equal(mt.faces[o], mj.faces[o])
        for a, b in zip(mt.points_padded(), mj.points_padded()):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_symmetry_stacks_match_jax(layout):
    dset, root = layout
    dj, dt = _datasets(dset, root)
    rng = np.random.default_rng(0)
    for o, (sj, st) in enumerate(zip(dj.symmetries, dt.symmetries)):
        assert st.shape == sj.shape and st.dtype == sj.dtype
        np.testing.assert_allclose(st, sj, atol=1e-6, rtol=0)
        pj, vj = jsym.pad_symmetry_stack(sj, 80)
        pt, vt = tsym.pad_symmetry_stack(st, 80)
        assert np.array_equal(vt, vj)
        np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0)
        kp = dj.kp_full[o][dj.kp_full_mask[o]]
        T = np.eye(4)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0] * [1, 1, 1]
        T[:3, :3] *= np.sign(np.linalg.det(T[:3, :3]))
        T[:3, 3] = [10.0, -20.0, 700.0]
        f32 = (T[:3], pt, kp, dj.view_pose[o])
        Tj, ij = jsym.pick_symmetry_transform(
            *(jnp.asarray(a, jnp.float32) for a in f32[:2]), jnp.asarray(vj),
            *(jnp.asarray(a, jnp.float32) for a in f32[2:]))
        Tt, it = tsym.pick_symmetry_transform(
            *(torch.as_tensor(a, dtype=torch.float32) for a in f32[:2]), torch.from_numpy(vt),
            *(torch.as_tensor(a, dtype=torch.float32) for a in f32[2:]))
        assert int(it) == int(ij)
        np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4, rtol=0)


def test_saved_detection_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    sd = tmp_path / "saved_detections"
    sd.mkdir()
    (tmp_path / "ycbv").mkdir()
    with open(tmp_path / "ycbv" / "offsets.txt", "w") as f:
        f.write("\n".join(f"{o:02d} {json.dumps((rng.normal(size=3) * 0.01).tolist())}"
                          for o in (1, 2, 3)))
    posecnn, pix2pose = {}, {}
    for s, v in ((48, 1), (48, 7), (55, 2)):
        n = 3
        rois = np.zeros((n, 6), np.float32)
        rois[:, 1] = [1, 2, 3]
        rois[:, 2:] = rng.uniform(0, 300, (n, 4))
        q = rng.normal(size=(n, 4))
        posecnn[f"{s}/{v}"] = {"rois": rois, "poses": np.concatenate(
            [q, rng.uniform(-0.2, 0.8, (n, 3))], 1)}
        pose = np.tile(np.eye(4)[:3], (n, 1, 1))
        pose[:, :, 3] = rng.uniform(-0.2, 0.8, (n, 3))
        pix2pose[f"{s}/{v}"] = {"rois": rois.copy(),
                                "poses": pose,
                                "labels_txt": [f"obj_{o:06d}" for o in (1, 2, 3)]}
    with open(sd / "ycbv_posecnn.pkl", "wb") as f:
        pickle.dump(posecnn, f)
    with open(sd / "tless_pix2pose_retinanet_siso_top1.pkl", "wb") as f:
        pickle.dump(pix2pose, f)
    targets = {48: {1: [1, 3], 7: [2]}}
    for jl, tl in ((jdet.load_posecnn_results, tdet.load_posecnn_results),
                   (jdet.load_pix2pose_results, tdet.load_pix2pose_results)):
        a, b = jl(str(tmp_path)), tl(str(tmp_path))
        assert a.keys() == b.keys()
        for k in a:
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                assert np.array_equal(np.asarray(x), np.asarray(y)), k
        for t in (None, targets):
            assert tdet.build_detection_map(b, t) == jdet.build_detection_map(a, t)
