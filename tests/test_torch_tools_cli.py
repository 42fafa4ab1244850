"""The port's tool CLIs, `python -m suo_slam_tpu_torch.manual_keypoints`
and `python -m suo_slam_tpu_torch.view_sym_choice`, against the JAX
package's `manual_keypoints.py` and `view_sym_choice.py` (run in this
process through runpy) on a synthetic BOP tree: equal decoded pixels and
the same printed lines. Without a display server the interactive labeler
and `--show` exit non-zero with a line that names the cause."""

import os
import runpy
import sys

import cv2
import numpy as np
import pytest

from suo_slam_tpu_torch import manual_keypoints, view_sym_choice
from suo_slam_tpu_torch.data import png
from tests.helpers.synthetic_bop import write_synthetic_bop
from tests.helpers.threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bop_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tools_cli") / "ycbv")
    return write_synthetic_bop(root, n_scenes=1, n_views=2, splits=("test",))


def _jax_cli(script, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [script] + argv)
    runpy.run_path(os.path.join(REPO, script), run_name="__main__")


def _common(root):
    return ["--dataset", "ycbv", "--data_root", root,
            "--kp_config_root", os.path.join(root, "kp_configs")]


def test_manual_keypoints_viz_equals_the_jax_cli(bop_root, tmp_path, monkeypatch, capsys):
    argv = _common(bop_root) + ["--viz"]
    _jax_cli("manual_keypoints.py", argv + ["--out", str(tmp_path / "jax")], monkeypatch)
    out_j = capsys.readouterr().out
    assert manual_keypoints.main(argv + ["--out", str(tmp_path / "port")]) == 0
    out_t = capsys.readouterr().out
    assert out_t == out_j.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) == 3
    for f in files:
        a = cv2.imread(str(tmp_path / "jax" / f), cv2.IMREAD_UNCHANGED)
        b = png.imread(str(tmp_path / "port" / f))
        assert a.shape == (480, 1280, 3)
        np.testing.assert_array_equal(b, a)
        assert len(np.unique(a.reshape(-1, 3), axis=0)) > 8  # shading and dots


@pytest.mark.parametrize("obj_id", [3, 2], ids=["discrete", "continuous"])
def test_view_sym_choice_equals_the_jax_cli(bop_root, tmp_path, monkeypatch, capsys, obj_id):
    """Object 3 has one discrete symmetry (2 candidates); object 2 a
    continuous one (65 candidates, every 4th rendered at --max_syms 16, the
    best appended)."""
    argv = _common(bop_root) + ["--split", "test", "--scene_id", "0", "--view_id", "1",
                                "--obj_id", str(obj_id)]
    _jax_cli("view_sym_choice.py", argv + ["--out", str(tmp_path / "jax.png")], monkeypatch)
    out_j = capsys.readouterr().out
    assert view_sym_choice.main(argv + ["--out", str(tmp_path / "port.png")]) == 0
    out_t = capsys.readouterr().out
    best = [ln for ln in out_j.splitlines() if ln.startswith("Best symmetry index")]
    assert len(best) == 1 and best[0].replace("jax.png", "port.png") in out_t.splitlines()
    a = cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED)
    b = png.imread(str(tmp_path / "port.png"))
    np.testing.assert_array_equal(b, a)
    assert a.shape[0] >= 240 and (a == (0, 255, 0)).all(-1).any()  # the chosen one's border


@pytest.mark.parametrize("display", [None, ":99"], ids=["no-display", "unreachable"])
def test_interactive_tools_refuse_without_a_display(bop_root, tmp_path, monkeypatch, capsys,
                                                    display):
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    if display is None:
        monkeypatch.delenv("DISPLAY", raising=False)
    else:
        monkeypatch.setenv("DISPLAY", display)
    assert manual_keypoints.main(_common(bop_root) + ["--obj_id", "1"]) == 2
    err = capsys.readouterr().err
    cause = "no display server" if display is None else "the window failed on display ':99'"
    assert err.startswith("manual_keypoints: ") and cause in err, err
    out = tmp_path / "sym.png"
    assert view_sym_choice.main(_common(bop_root) + ["--obj_id", "3", "--show",
                                                     "--out", str(out)]) == 2
    err = capsys.readouterr().err
    assert err.startswith("view_sym_choice --show: ") and cause in err, err
    assert out.exists() == (display is not None)  # the grid is written before the window
