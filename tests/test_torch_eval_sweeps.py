"""The port's paper sweeps (`suo_slam_tpu_torch/scripts/eval_all_ycbv.sh`,
`eval_all_tless.sh`) on the CPU.

- Each port script's list of runs equals its JAX counterpart's
  (`scripts/eval_all_*.sh`), parsed from the files.
- Both run end to end on generated YCB-V and T-LESS trees
  (`tests/helpers/synthetic_bop.py`) beside a narrow checkpoint from the
  port's writer, with `--debug_gt_kp --device cpu` passed through: each run
  writes its method folder, and the aggregation writes `table.txt` (the 5
  runs' summary.txt blocks) and `table_tless.txt` (the 4 runs' summary.txt
  and vsd_summary.txt blocks).
"""

import os
import re
import subprocess

import pytest

from tests.helpers.synthetic_bop import write_synthetic_bop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "suo_slam_tpu_torch", "scripts")
JAX = os.path.join(REPO, "scripts")


def _runs(path):
    return re.findall(r"^run (.*)$", open(path).read(), re.M)


@pytest.mark.parametrize("dataset", ["ycbv", "tless"])
def test_port_sweep_runs_the_jax_sweeps_runs(dataset):
    name = f"eval_all_{dataset}.sh"
    port, jax = _runs(os.path.join(PORT, name)), _runs(os.path.join(JAX, name))
    assert port == jax and len(port) == (5 if dataset == "ycbv" else 4)
    text = open(os.path.join(PORT, name)).read()
    assert "python -m suo_slam_tpu_torch.evaluate" in text and "evaluate.py" not in text


def _narrow_checkpoint(path):
    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.train import checkpoint as tck
    from suo_slam_tpu_torch.train import harness as th

    net = PkpNet(n_stack=1, n_modules=1, features=16)
    tck.save_checkpoint(str(path), th.TrainState(net, th.make_optimizer(net.parameters())), 0,
                        {"norm": "batch"}, 1.0, is_best=True)
    return str(path / "model_best")


@pytest.mark.parametrize("dataset", ["ycbv", "tless"])
def test_port_sweep_writes_its_table(dataset, tmp_path):
    root = tmp_path / "bop_datasets" / dataset
    write_synthetic_bop(str(root), n_scenes=1, n_views=2, seed=3, bop_dset=dataset,
                        **({"splits": ("test",)} if dataset == "ycbv" else {}))
    ck = _narrow_checkpoint(tmp_path / "run")
    script = os.path.join(PORT, f"eval_all_{dataset}.sh")
    # one intra-op thread a run: the suite's workers share the machine's CPUs
    env = {k: v for k, v in os.environ.items() if k not in ("DISPLAY", "WAYLAND_DISPLAY")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    r = subprocess.run(["bash", script, ck, "--debug_gt_kp", "--device", "cpu",
                        "--data_root", str(root),
                        "--kp_config_root", str(root / "kp_configs")],
                       cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.count("RUN: --nviews") == len(_runs(script))
    table = tmp_path / "run" / ("table.txt" if dataset == "ycbv" else "table_tless.txt")
    blocks = re.findall(r"^==== (.*) ====$", table.read_text(), re.M)
    if dataset == "ycbv":
        assert len(blocks) == 5 and all(b.endswith("/summary.txt") for b in blocks)
        methods = {os.path.basename(os.path.dirname(b)) for b in blocks}
        assert {m.split("_ycbv")[0].split("-GT-KP")[1] for m in methods} == {
            "", "-GT-CAM-POSE", "-NO-COV", "-NO-PRIOR-DET"}
    else:
        assert sorted(os.path.basename(b) for b in blocks) == (
            ["summary.txt"] * 4 + ["vsd_summary.txt"] * 4)
    for b in blocks:  # each run drew its frames
        assert os.listdir(os.path.join(os.path.dirname(b), "viz_images"))
