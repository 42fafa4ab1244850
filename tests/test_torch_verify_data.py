"""`python -m suo_slam_tpu_torch.verify_data`, the port of
`scripts/verify_data.py`, on the synthetic fixture laid out as the real
tree (bop_datasets/{ycbv,tless}, saved_detections, offsets.txt, VOCdevkit),
here with a `train_pbr` split of JPEG frames and a VOC directory of JPEGs:
PASS on a good tree, a non-zero exit and the same FAIL rows as the JAX
package's script on broken ones.
"""

import importlib.util
import json
import os
import pickle
import re
import shutil

import numpy as np
import pytest

from suo_slam_tpu_torch import verify_data as tvd
from tests.helpers.jpeg_bop import write_pbr_split, write_voc
from tests.helpers.synthetic_bop import write_synthetic_bop
from tests.helpers.threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_verifier():
    spec = importlib.util.spec_from_file_location(
        "verify_data_jax", os.path.join(REPO, "scripts", "verify_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quat_wxyz(R):
    w = np.sqrt(max(0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])


@pytest.fixture(scope="module")
def real_shape_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("verify_port") / "bop_datasets"
    ycbv = root / "ycbv"
    write_synthetic_bop(str(ycbv), n_scenes=1, n_views=2, hw=(96, 128))
    write_pbr_split(str(ycbv), "train_synt")
    os.symlink(ycbv / "models_bop-compat", ycbv / "models_bop-compat_eval",
               target_is_directory=True)
    write_synthetic_bop(str(root / "tless"), n_scenes=1, n_views=2, hw=(96, 128),
                        bop_dset="tless")
    with open(ycbv / "offsets.txt", "w") as f:
        for obj_id in (1, 2, 3):
            f.write(f"{obj_id:02d} [0.0, 0.0, 0.0]\n")
    from suo_slam_tpu_torch.data.bop import BopDataset

    ds = BopDataset(str(ycbv), "test", kp_config_root=str(ycbv / "kp_configs"), seed=0)
    results = {}
    for s in ds.scene_ids():
        for v in ds.view_ids(s):
            rois, poses = [], []
            for o in ds.obj_ids(s, v):
                T = ds.get_obj_pose(s, v, o)
                x, y, w, h = ds.data[s][v].objects[o].bbox_xywh
                rois.append([0, o, x, y, x + w, y + h])
                poses.append(np.concatenate([_quat_wxyz(T[:3, :3]), T[:3, 3] / 1000.0]))
            results[f"{s:06d}/{v:06d}"] = {"rois": np.asarray(rois, np.float64),
                                           "poses": np.asarray(poses, np.float64)}
    os.makedirs(root / "saved_detections")
    with open(root / "saved_detections" / "ycbv_posecnn.pkl", "wb") as f:
        pickle.dump(results, f)
    write_voc(str(root), n=3)
    return str(root)


def _fails(out):
    """The FAIL rows as the checks ran (not the closing summary's repeat)."""
    return sorted(re.findall(r"^  \[FAIL\] (\S+(?: \S+)*)", out.split("FAILED:")[0], re.M))


def test_verify_data_passes_on_good_tree(real_shape_root, capsys):
    rc = tvd.main(["--bop_root", real_shape_root])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "FAIL" not in out, out
    for item in ["mesh database", "kp_info schema", "ycbv/train_pbr get_raw",
                 "ycbv/train_synt get_raw", "tless/train_primesense get_raw",
                 "PoseCNN detections", "VOC backgrounds", "checkpoint load"]:
        assert item in out, (item, out)
    assert "3 backgrounds" in out and "resized to 480x640" in out, out
    assert "suo_slam_tpu_torch.evaluate" in out and "--pipeline_scenes" in out, out


def _broken_kp_info(tree):
    kp = tree / "ycbv" / "kp_info" / "obj_000001_kp_info.json"
    info = json.loads(kp.read_text())
    info["keypoints"][next(iter(info["keypoints"]))]["pos_mean"] = [0.0]
    kp.write_text(json.dumps(info))


def _broken_pbr_frame(tree):
    (tree / "ycbv" / "train_pbr" / "000000" / "rgb" / "000000.jpg").write_bytes(b"")


@pytest.mark.parametrize("breakage, row", [(_broken_kp_info, "ycbv kp_info schema"),
                                           (_broken_pbr_frame, "ycbv/train_pbr get_raw")])
def test_verify_data_fails_on_broken_tree(real_shape_root, tmp_path, capsys, breakage, row):
    broken = tmp_path / "bop_datasets"
    shutil.copytree(real_shape_root, broken, symlinks=True)
    breakage(broken)
    rc = tvd.main(["--bop_root", str(broken)])
    out = capsys.readouterr().out
    assert rc != 0 and _fails(out) == [row], out
    rc_jax = _jax_verifier().main(["--bop_root", str(broken)])
    out_jax = capsys.readouterr().out
    assert rc_jax != 0 and _fails(out_jax) == _fails(out), out_jax


def test_verify_data_fails_on_missing_dataset_dirs(tmp_path, capsys):
    rc = tvd.main(["--bop_root", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc != 0 and "bop_root" in out
    assert _fails(out) == ["bop_root"]
