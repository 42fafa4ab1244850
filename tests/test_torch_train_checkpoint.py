"""Checkpoints in the JAX package's format, on the CPU:

- the numpy msgpack codec against flax's `to_bytes` / `msgpack_restore`
  (the same bytes for the same tree; each restores the other's; flax's
  chunked-array form);
- a checkpoint the port writes restored by the JAX package's
  `load_checkpoint`, and one JAX writes restored by the port, down to the
  bytes the port writes back;
- `find_resume_dir`;
- `load_eval_network` on a JAX `norm="batch"` checkpoint: the forward equal
  to the JAX net's (1e-4);
- the training CLI for 2 epochs x 2 steps (`--device cpu`, `SUO_TINY_NET=1`)
  and its auto-resume.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from suo_slam_tpu.models.pkpnet import PkpNet as JaxPkpNet
from suo_slam_tpu.train import checkpoint as jck
from suo_slam_tpu.train import harness as jh
from suo_slam_tpu_torch.models import convert
from suo_slam_tpu_torch.models.pkpnet import PkpNet
from suo_slam_tpu_torch.train import checkpoint as tck
from suo_slam_tpu_torch.train import harness as th
from suo_slam_tpu_torch.train import msgpack as mp
from tests.helpers.synthetic_bop import write_synthetic_bop

TINY = dict(n_stack=1, n_modules=1, features=16)
ARGS = {"norm": "batch", "no_network_cov": False, "dataset": "ycbv", "lr": 1e-3}


def _tree_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


def test_codec_matches_flax():
    rng = np.random.default_rng(0)
    tree = {"params": {"b": rng.normal(size=(3, 4)).astype(np.float32),
                       "a": {"k": np.arange(300, dtype=np.int64)}},
            "step": np.asarray(7, np.int32), "rng": np.array([1, 2**31], np.uint32),
            "epoch": np.asarray(3), "best_val": np.asarray(np.inf, np.float64),
            "args_json": json.dumps({"x": "y" * 40}), "empty": {}, "n": -3, "big": 70000,
            "f": 0.25, "flag": True, "none": None, "s": np.float32(2.5),
            "shape0": np.zeros((0, 2), np.float16)}  # (to_bytes turns lists into dicts)
    data = serialization.to_bytes(tree)
    assert mp.packb(tree) == data
    _tree_equal(mp.unpackb(data), serialization.msgpack_restore(data))
    back = serialization.msgpack_restore(mp.packb(tree))
    _tree_equal(back, mp.unpackb(data))
    # flax's chunked form of an array over 2^30 bytes joins back
    arr = rng.normal(size=(5, 3)).astype(np.float32)
    chunked = {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 5, "1": 3},
                     "chunks": {"0": arr.reshape(-1)[:8], "1": arr.reshape(-1)[8:]}}}
    assert np.array_equal(mp.unpackb(serialization.to_bytes(chunked))["w"], arr)
    with pytest.raises(TypeError):
        mp.packb({"x": object()})


@pytest.fixture(scope="module")
def jax_state():
    net = JaxPkpNet(**TINY)
    opt = optax.adam(1e-3)
    st = jh.init_state(net, jax.random.PRNGKey(0), opt, input_hw=(64, 64))
    rng = np.random.default_rng(1)
    noisy = lambda t: jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), t)
    adam = st.opt_state[0]._replace(count=jnp.asarray(3, jnp.int32), mu=noisy(st.params),
                                    nu=jax.tree.map(jnp.abs, noisy(st.params)))
    st = st._replace(params=noisy(st.params), opt_state=(adam, st.opt_state[1]),
                     batch_stats=jax.tree.map(lambda a: a + 0.5, st.batch_stats),
                     step=jnp.asarray(3, jnp.int32), rng=jax.random.PRNGKey(4))
    return net, opt, st


def _port_state():
    net = PkpNet(**TINY)
    return th.TrainState(net, th.make_optimizer(net.parameters()))


def test_jax_checkpoint_restores_in_the_port_and_back(jax_state, tmp_path):
    net, opt, st = jax_state
    jck.save_checkpoint(str(tmp_path / "jax"), st, 5, ARGS, 1.25, is_best=True, best_train=0.5)
    path = str(tmp_path / "jax" / "checkpoint-latest")
    state, epoch, args, best_val, best_train = tck.load_checkpoint(path, _port_state())
    assert (epoch, args, best_val, best_train, state.step) == (5, ARGS, 1.25, 0.5, 3)
    assert tck.peek_checkpoint_scalar(path, "best_train") == 0.5
    assert tck.peek_checkpoint_args(path) == ARGS
    want = convert.from_jax_variables(jax.tree.map(
        np.asarray, {"params": st.params, "batch_stats": st.batch_stats}))
    for k, v in state.net.state_dict().items():
        assert torch.equal(v, want[k]), k
    # written back by the port: the same bytes JAX wrote
    tck.save_checkpoint(str(tmp_path / "port"), state, 5, ARGS, 1.25, best_train=0.5)
    with open(path, "rb") as f, open(tmp_path / "port" / "checkpoint-5", "rb") as g:
        assert f.read() == g.read()


def test_port_checkpoint_restores_in_jax(jax_state, tmp_path):
    net, opt, st = jax_state
    state = _port_state()
    for p in state.net.parameters():
        p.grad = torch.randn_like(p)
    state.optimizer.step()
    state.optimizer.step()
    state.step, state.rng = 2, np.array([0, 9], np.uint32)
    tck.save_checkpoint(str(tmp_path), state, 1, ARGS, float("inf"), is_best=True)
    for name in ("checkpoint-1", "checkpoint-latest", "model_best"):
        assert os.path.isfile(tmp_path / name) and os.path.isfile(tmp_path / f"{name}.meta.json")
    restored, epoch, args, best_val, best_train = jck.load_checkpoint(
        str(tmp_path / "checkpoint-1"), st)
    assert (epoch, args, best_val, best_train) == (1, ARGS, float("inf"), float("inf"))
    assert int(restored.step) == 2 and np.asarray(restored.rng).tolist() == [0, 9]
    _tree_equal(jax.tree.map(np.asarray, restored.params), convert.to_jax_variables(state.net)["params"])
    _tree_equal(serialization.to_state_dict(jax.tree.map(np.asarray, restored.opt_state)),
                convert.adam_to_optax(state.net, state.optimizer))
    assert int(restored.opt_state[0].count) == 2


def test_find_resume_dir(tmp_path):
    root = tmp_path / "results"
    for stamp, has in (("01-02-2026@10-00-00", True), ("03-02-2026@10-00-00", True),
                       ("12-31-2026@23-59-59", False)):
        d = root / f"pkpnet_ycbv_real-synt_x_{stamp}"
        d.mkdir(parents=True)
        if has:
            (d / "checkpoint-latest").write_bytes(b"")
    (root / "pkpnet_tless_real-synt_x_09-09-2026@00-00-00").mkdir()
    got = tck.find_resume_dir(str(root), "ycbv", "real+synt", "x")
    assert got == jck.find_resume_dir(str(root), "ycbv", "real+synt", "x")
    assert got.endswith("03-02-2026@10-00-00")
    assert tck.find_resume_dir(str(tmp_path / "none"), "ycbv", "real") is None
    assert tck.output_dir_name("ycbv", "real+synt", "x").startswith("pkpnet_ycbv_real-synt_x_")


def test_eval_loader_reads_a_jax_checkpoint(jax_state, tmp_path):
    from suo_slam_tpu_torch.eval import loading

    net, _, st = jax_state
    jck.save_checkpoint(str(tmp_path), st, 2, ARGS, 1.0)
    tnet, epoch = loading.load_eval_network(str(tmp_path / "checkpoint-2"), bf16=False)
    assert epoch == 2 and tnet.prior_mode == "post_stem"
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = net.apply({"params": st.params, "batch_stats": st.batch_stats}, jnp.asarray(x))
    with torch.no_grad():
        got = tnet.eval()(torch.from_numpy(x), torch.zeros(2, 16, 16, 41))
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(want.uv), atol=1e-4)
    np.testing.assert_allclose(got.kp_mask.numpy(), np.asarray(want.kp_mask), atol=1e-4)


def test_training_cli_runs_and_auto_resumes(tmp_path, monkeypatch):
    from suo_slam_tpu_torch.train import __main__ as cli

    root = str(tmp_path / "bop_datasets" / "ycbv")
    write_synthetic_bop(root, n_scenes=1, n_views=10, splits=("train_real", "test"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SUO_TINY_NET", "1")
    argv = ["--device", "cpu", "--dataset", "ycbv", "--data_split", "real",
            "--no_augmentations", "--no_bf16", "--batch_size", "1", "--truncate_obj", "3",
            "--steps_per_epoch", "2",
            "--val_steps", "1", "--workers", "1", "--data_root", root,
            "--kp_config_root", os.path.join(root, "kp_configs")]
    assert cli.main(argv + ["--epochs", "2"]) == 0
    (outdir,) = (tmp_path / "results").iterdir()
    for name in ("checkpoint-0", "checkpoint-1", "checkpoint-latest", "model_best", "params.txt"):
        assert (outdir / name).is_file(), name
    assert json.loads((outdir / "checkpoint-latest.meta.json").read_text())["epoch"] == 1
    time.sleep(1.1)  # a new run would get a later timestamp
    assert cli.main(argv + ["--epochs", "3"]) == 0
    assert [p.name for p in (tmp_path / "results").iterdir()] == [outdir.name]
    meta = json.loads((outdir / "checkpoint-latest.meta.json").read_text())
    assert meta["epoch"] == 2 and (outdir / "checkpoint-2").is_file()
    state, epoch, _, _, _ = jck.load_checkpoint(str(outdir / "checkpoint-2"), jh.init_state(
        JaxPkpNet(**TINY), jax.random.PRNGKey(0), optax.adam(1e-3)))
    assert epoch == 2 and int(state.step) == 6 and int(state.opt_state[0].count) == 6
    # --pretrain: a fresh run (no resume) from the trained weights, unannealed
    monkeypatch.chdir(tmp_path / "bop_datasets")
    assert cli.main(argv + ["--epochs", "1", "--no_resume", "--no_val",
                            "--pretrain", str(outdir / "checkpoint-2")]) == 0
    (fresh,) = (tmp_path / "bop_datasets" / "results").iterdir()
    assert json.loads((fresh / "params.txt").read_text())["pretrain"].endswith("checkpoint-2")
    _, epoch, _, _, _ = tck.load_checkpoint(str(fresh / "checkpoint-latest"), _port_state())
    assert epoch == 0


def test_training_path_imports_no_jax_flax_msgpack_cv2_or_pil():
    """The card's machine has none of them: no module of the port imports
    them, and importing the training path loads none."""
    import ast
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(repo, "suo_slam_tpu_torch")
    banned = ("jax", "jaxlib", "flax", "msgpack", "cv2", "PIL", "suo_slam_tpu")
    bad = []
    for d, _, fs in os.walk(pkg):
        for f in fs:
            if f.endswith(".py"):
                for node in ast.walk(ast.parse(open(os.path.join(d, f)).read())):
                    names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                             [node.module] if isinstance(node, ast.ImportFrom)
                             and node.level == 0 and node.module else [])
                    bad += [(f, n) for n in names if n.split(".")[0] in banned]
    assert not bad, bad
    code = ("import sys\nfrom suo_slam_tpu_torch.train import __main__, checkpoint, harness, "
            "losses, msgpack\nfrom suo_slam_tpu_torch.data import loader, bop\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {banned!r})\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=repo), timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
