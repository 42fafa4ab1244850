"""The PyTorch port stands alone: importing it pulls in neither JAX nor the
JAX package, no module of it imports them, and its entry points default to
CUDA and raise (never fall back) when no card is present."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "suo_slam_tpu_torch")
FORBIDDEN = ("jax", "flax", "suo_slam_tpu")


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import suo_slam_tpu_torch\n"
        "from suo_slam_tpu_torch.slam import engine, kernels\n"
        "from suo_slam_tpu_torch.models import pkpnet, convert\n"
        "from suo_slam_tpu_torch.solvers import ba, pnp, p3p\n"
        "from suo_slam_tpu_torch.ops import roi, heatmap\n"
        "from suo_slam_tpu_torch.kernels import _build\n"
        "from suo_slam_tpu_torch.core import lie, geometry\n"
        "from suo_slam_tpu_torch.kp import config\n"
        "from suo_slam_tpu_torch import evaluate, calibrate_int8\n"
        "from suo_slam_tpu_torch.data import bop\n"
        "from suo_slam_tpu_torch.models import int8_forward, int8_kernels\n"
        "from suo_slam_tpu_torch import parallel, compat\n"
        "from suo_slam_tpu_torch.compat import g2o, lambdatwist\n"
        "from suo_slam_tpu_torch.parallel import mesh\n"
        "from suo_slam_tpu_torch.train import harness\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'suo_slam_tpu', 'cv2'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 15
    for sub in ("parallel", "compat"):  # the data-parallel and compat packages are walked
        assert any(os.sep + sub + os.sep in f for f in files), sub
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_chip_smoke_imports_nothing_of_jax():
    bad = [m for m in _imports(os.path.join(REPO, "chip_smoke.py"))
           if m.split(".")[0] in FORBIDDEN + ("tests",)]
    assert not bad, bad


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract is not testable")
    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.slam import kernels
    from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig

    with pytest.raises(RuntimeError, match="cuda"):
        ObjectSlam(SlamConfig(single_view_mode=True), infer_fn=lambda *a: None)
    net = PkpNet(n_stack=1, n_modules=1, features=8)
    with pytest.raises(RuntimeError, match="cuda"):
        kernels.make_frame_inference(net)


def test_slam_mode_raises_naming_its_roadmap_item():
    """SLAM, SfM, debug_gt_kp and int8 runs construct (int8 serving, B5, is
    ported: an int8 engine builds its s8 program and refuses a run with
    neither scales nor calibration frames); the CLI takes the visualization
    flags (ported: no refusal is left)."""
    from suo_slam_tpu_torch import evaluate as port_evaluate
    from suo_slam_tpu_torch.args import get_args
    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig

    for cfg in (SlamConfig(), SlamConfig(sfm_mode=True),
                SlamConfig(int8_inference=True)):
        ObjectSlam(cfg, infer_fn=lambda *a: None, device="cpu")
    ObjectSlam(SlamConfig(debug_gt_kp=True), device="cpu")
    net = PkpNet(n_stack=1, n_modules=1, features=8)
    eng = ObjectSlam(SlamConfig(int8_inference=True), net=net, device="cpu")
    assert eng._infer.int8_state == {} and eng._infer.supports_no_prior
    with pytest.raises(ValueError, match="activation scales"):
        ObjectSlam(SlamConfig(int8_inference=True, int8_calib_frames=0), net=net,
                   device="cpu")
    for kw in ("viz_cov", "show_viz"):
        args = get_args([f"--{kw}"])
        assert getattr(args, kw) and not args.no_viz
    assert not hasattr(port_evaluate, "refuse_unported")
