"""The port's visualization through its entry points, on the CPU.

- `python -m suo_slam_tpu_torch.evaluate` at its defaults (viz on) and with
  `--viz_cov --do_viz_extra`, in process on the `synthetic_bop` fixture with
  `--debug_gt_kp --device cpu`: at every frame the JAX package's own
  `Evaluator._write_viz` (cv2) draws the port engine's data (its
  `get_view_viz_data`, poses and `_last_img`) beside the port's, and the
  written PNGs, decoded, are equal file for file.
- `--show_viz` without a display server (`DISPLAY` unset) and with one that
  cannot be reached (`DISPLAY=:99`) prints the JAX CLI's two lines.
- `--nviews 1 --batched` with a tiny net (so the keypoints carry the net's
  covariances) and `--viz_cov --do_viz_extra` writes its frames, equal to
  JAX's drawing.
- The training CLI for 2 epochs writes `viz_train_epoch_<N>`,
  `viz_test_epoch_<N>` and `viz_best`; around a direct call of the dump, the
  parameters, buffers, optimizer state and generator states are bit-equal,
  a fault in the crop propagates and a failed write prints JAX's line.
- Importing the viz modules and the entry points loads neither cv2, Pillow
  nor JAX.
"""

import os
import random
import subprocess
import sys
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

import evaluate as jax_evaluate
from suo_slam_tpu_torch import evaluate as port_evaluate
from tests.helpers.synthetic_bop import write_synthetic_bop
from tests.helpers.threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHOD = "pkpnet-epoch=-1-nviews={}-det=gt-GT-KP_ycbv-test"


@pytest.fixture(scope="module")
def ycbv(tmp_path_factory):
    root = tmp_path_factory.mktemp("vizcli") / "bop_datasets" / "ycbv"
    write_synthetic_bop(str(root), n_scenes=1, n_views=4, seed=3, splits=("test",))
    os.symlink(root / "models_bop-compat", root / "models_bop-compat_eval",
               target_is_directory=True)
    return str(root)


@pytest.fixture
def jax_drawing(monkeypatch, tmp_path):
    """At every frame, JAX's `_write_viz` draws the port engine's data into
    `<tmp>/jax/viz_images` before the port's `_write_viz` runs."""
    jax_out = tmp_path / "jax"
    orig = port_evaluate.Evaluator._write_viz

    def both(self, outdir, scene_id, j, view_id, results):
        same = SimpleNamespace(object_slam=self.object_slam, viz_cov=self.viz_cov,
                               do_viz_extra=self.do_viz_extra, show_viz=False,
                               mesh_db=self.mesh_db, _last_img=self._last_img,
                               _last_K=self._last_K)
        jax_evaluate.Evaluator._write_viz(same, str(jax_out), scene_id, j, view_id, results)
        return orig(self, outdir, scene_id, j, view_id, results)

    monkeypatch.setattr(port_evaluate.Evaluator, "_write_viz", both)
    return jax_out / "viz_images"


def _same_pngs(port_dir, jax_dir, n_frames):
    port = sorted(os.path.relpath(os.path.join(d, f), port_dir)
                  for d, _, fs in os.walk(port_dir) for f in fs)
    jax = sorted(os.path.relpath(os.path.join(d, f), jax_dir)
                 for d, _, fs in os.walk(jax_dir) for f in fs)
    assert port == jax and sum("/" not in p for p in port) == n_frames, (port, jax)
    for rel in port:
        a = cv2.imread(os.path.join(port_dir, rel), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(os.path.join(jax_dir, rel), cv2.IMREAD_UNCHANGED)
        assert a is not None and a.shape == b.shape, rel
        np.testing.assert_array_equal(a, b, err_msg=rel)
    return port


def _cli_argv(ycbv, *extra):
    return ["--device", "cpu", "--debug_gt_kp", "--dataset", "ycbv", "--data_root", ycbv,
            "--kp_config_root", os.path.join(ycbv, "kp_configs"), "--checkpoint_path", "",
            *extra]


@pytest.mark.parametrize("flags", [(), ("--viz_cov", "--do_viz_extra")],
                         ids=["defaults", "viz_cov+extra"])
def test_evaluate_cli_frames_equal_jax_drawing(ycbv, tmp_path, monkeypatch, jax_drawing,
                                               flags):
    monkeypatch.chdir(tmp_path)
    port_evaluate.main(_cli_argv(ycbv, "--nviews", "-1", *flags))
    outdir = tmp_path / "results" / METHOD.format(-1)
    assert (outdir / "summary.txt").is_file()
    files = _same_pngs(str(outdir / "viz_images"), str(jax_drawing), 4)
    frames = [cv2.imread(str(outdir / "viz_images" / f)) for f in files if "/" not in f]
    # the first frame has no prior yet; the later ones add the prior panel
    assert [f.shape for f in frames] == [(240, 640, 3)] + [(240, 960, 3)] * 3
    assert any("/viz_obj_" in f for f in files) == bool(flags)


@pytest.mark.parametrize("display,line", [
    (None, "[evaluate] --show_viz: no display server; disabled"),
    (":99", "[evaluate] --show_viz: imshow failed; disabled"),
], ids=["no-display", "unreachable"])
def test_show_viz_without_a_display(ycbv, tmp_path, monkeypatch, capsys, display, line):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    if display is None:
        monkeypatch.delenv("DISPLAY", raising=False)
    else:
        monkeypatch.setenv("DISPLAY", display)
    port_evaluate.main(_cli_argv(ycbv, "--nviews", "1", "--show_viz"))
    out = capsys.readouterr().out
    assert out.count(line) == 1, out[-2000:]
    frames = os.listdir(tmp_path / "results" / METHOD.format(1) / "viz_images")
    assert len(frames) == 4


def test_batched_run_writes_frames_equal_jax_drawing(ycbv, tmp_path, jax_drawing):
    from suo_slam_tpu_torch.models.pkpnet import PkpNet

    torch.manual_seed(0)
    net = PkpNet(n_stack=1, n_modules=1, features=16).eval()
    ev = port_evaluate.Evaluator("ycbv", ycbv, "", nviews=1, detection_type="gt", net=net,
                                 batched=True, eval_window=2, no_viz=False, viz_cov=True,
                                 do_viz_extra=True, device="cpu",
                                 kp_config_root=os.path.join(ycbv, "kp_configs"))
    ev.model_path = str(tmp_path / "port")
    assert ev.run() is not None
    viz_dir = os.path.join(ev.model_path, ev.method_name(), "viz_images")
    files = _same_pngs(viz_dir, str(jax_drawing), 4)
    assert ev.viz_ms["frames"] == 4 and ev.viz_ms["draw"] > 0 and ev.viz_ms["png"] > 0
    assert sum(f.endswith("_output.png") for f in files) == 12  # 4 views x 3 objects


# ------------------------------------------------------------ training --
@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vizdump") / "bop_datasets" / "ycbv"
    write_synthetic_bop(str(root), n_scenes=1, n_views=10, splits=("train_real", "test"))
    return str(root)


def test_training_cli_writes_the_epoch_dumps(train_root, tmp_path, monkeypatch):
    from suo_slam_tpu_torch.train import __main__ as cli

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SUO_TINY_NET", "1")
    argv = ["--device", "cpu", "--dataset", "ycbv", "--data_split", "real",
            "--no_augmentations", "--no_bf16", "--batch_size", "1", "--truncate_obj", "3",
            "--steps_per_epoch", "2", "--val_steps", "1", "--workers", "1", "--epochs", "2",
            "--data_root", train_root, "--kp_config_root", os.path.join(train_root, "kp_configs")]
    assert cli.main(argv) == 0
    (outdir,) = (tmp_path / "results").iterdir()
    for split in ("train", "test"):
        for epoch in (0, 1):
            img = cv2.imread(str(outdir / f"viz_{split}_epoch_{epoch}" / "sample.png"))
            assert img is not None and img.shape == (240, 640, 3), (split, epoch)
    # epoch 0 is the best so far by construction; viz_best holds a best
    # epoch's test dump
    best = cv2.imread(str(outdir / "viz_best" / "sample.png"))
    assert any(np.array_equal(best, cv2.imread(str(outdir / f"viz_test_epoch_{e}" /
                                                    "sample.png"))) for e in (0, 1))


def _state_snapshot(state):
    net, opt = state.net, state.optimizer
    return {
        "params": {k: v.detach().clone() for k, v in net.named_parameters()},
        "buffers": {k: v.detach().clone() for k, v in net.named_buffers()},
        "opt": {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
                for i, s in enumerate(opt.state.values())},
        "step": state.step,
        "training": net.training,
        "torch_rng": torch.get_rng_state(),
        "np_rng": np.random.get_state()[1].copy(),
        "py_rng": random.getstate(),
    }


def test_epoch_dump_leaves_training_state_untouched(train_root, tmp_path, monkeypatch, capsys):
    from suo_slam_tpu_torch.data.bop import BopDataset, collate
    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.train import __main__ as cli
    from suo_slam_tpu_torch.train import harness

    ds = BopDataset(train_root, "train_real", bop_dset="ycbv", map_by="view",
                    kp_config_root=os.path.join(train_root, "kp_configs"), seed=123)
    np_batch = collate([ds[0], ds[1]], truncate_obj=3)
    net = PkpNet(n_stack=1, n_modules=1, features=16)
    state = harness.init_state(net, seed=0)
    step = harness.make_train_step()
    state, _ = step(state, harness.to_batch(np_batch, "cpu", o_pad=3), 0.0)  # Adam has state
    net.train()
    before = _state_snapshot(state)
    viz_dir = cli._dump_epoch_viz(str(tmp_path), 3, net, np_batch, torch.device("cpu"),
                                  split="train")
    after = _state_snapshot(state)
    assert viz_dir == str(tmp_path / "viz_train_epoch_3")
    assert cv2.imread(os.path.join(viz_dir, "sample.png")).shape == (240, 640, 3)
    for key in ("params", "buffers"):
        assert before[key].keys() == after[key].keys()
        for name in before[key]:
            assert torch.equal(before[key][name], after[key][name]), (key, name)
    for i in before["opt"]:
        for k, v in before["opt"][i].items():
            w = after["opt"][i][k]
            assert torch.equal(v, w) if torch.is_tensor(v) else v == w, (i, k)
    assert before["step"] == after["step"] and after["training"]
    assert torch.equal(before["torch_rng"], after["torch_rng"])
    assert np.array_equal(before["np_rng"], after["np_rng"])
    assert before["py_rng"] == after["py_rng"]

    # a failed write prints JAX's line and returns None; a fault in the
    # crop or the net is not caught
    blocker = tmp_path / "blocked"
    blocker.write_text("")
    assert cli._dump_epoch_viz(str(blocker), 0, net, np_batch, torch.device("cpu")) is None
    assert "viz dump failed: " in capsys.readouterr().out

    def broken(*a, **k):
        raise RuntimeError("crop kernel fault")

    from suo_slam_tpu_torch.ops import roi

    monkeypatch.setattr(roi, "roi_crop_batch", broken)
    with pytest.raises(RuntimeError, match="crop kernel fault"):
        cli._dump_epoch_viz(str(tmp_path), 4, net, np_batch, torch.device("cpu"))
    assert net.training


def test_viz_modules_load_no_opencv_pillow_or_jax():
    code = ("import sys\n"
            "from suo_slam_tpu_torch.eval import viz, raster\n"
            "from suo_slam_tpu_torch import evaluate\n"
            "from suo_slam_tpu_torch.train import __main__\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('cv2', 'PIL', 'jax', 'jaxlib', 'suo_slam_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
