"""Data parallelism of the port (`parallel/mesh.py`,
`train/harness.make_sharded_train_step`, the training CLI across ranks)
against the JAX package's, on the CPU with gloo.

One module-scoped spawn of two ranks (`tests/helpers/dp_ranks.py`, a gloo
group through a file under tmp_path, one torch thread a rank) runs every
two-rank case once:

- the sharded step (SGD, lr 1e-2) of the tiny net (1 stack x 1 module x 16
  features, 64x64 crops) from JAX's initial weights, converted, on a batch
  of 4 frames x 2 object slots whose row mask is uneven and leaves rank 1
  no real row, with JAX's own dropout mask: against the JAX single-device
  `make_train_step` on the joined batch, with `tests/test_parallel.py`'s
  tolerances (loss rtol 5e-4, parameters and running statistics atol
  3e-4), in f64 on both sides (the port's plain versions compute in f64
  for f64 input; JAX's step traced with f64 where it names f32, as
  `tests/test_torch_train_step.py` does: measured 1.2e-7). In f32 the
  train-mode step at random weights is ill-conditioned — with 3 real rows
  the deepest norms average 48 values a channel — and the port's f32 step
  lies 0.04 from JAX's f32 step in a parameter, where the f64 steps agree
  to 1e-7. The same f64 step is held against the port's own one-process
  step on the joined batch, tighter: loss 1e-12 relative, parameters and
  running statistics 1e-10 absolute (measured 4e-14: the ranks' sums split
  in another order); the f32 path across ranks is the Adam case's and the
  CLI's;
- the same step with Adam: both ranks end with equal parameters, running
  statistics and Adam moments, bit for bit;
- K16 / K17's cross-rank plain versions (partial sums, all-reduce,
  finalize; sums, all-reduce, dx) on f64 activations against the unsplit
  plain versions on the joined rows, the same uneven mask: 1e-12 relative;
- sharded inference on 5 crops (padded to 6) against JAX `net.apply`
  (atol 1e-3, as `tests/test_parallel.py`).

Then `pad_to_multiple` and `shard_batch` against JAX's (the shards of the
8-device CPU mesh), the batch-size rule, and the training CLI under
`python -m torch.distributed.run --nproc_per_node 2` (gloo, `--device
cpu`) against its one-process run on the same flags: the running
statistics within 1e-6 relative, Adam's first moment (0.1 x the gradient)
within 1e-2 of its largest entry and a cosine of at least 0.9999 over the
whole gradient (the train-mode step's gradients at random weights move by
~1e-3 of their scale under reordered sums: `tests/test_torch_train_step.py`).
The card tests (`tests/test_torch_cuda_parallel.py`, `cuda`) hold K16 /
K17's cross-rank kernels to their plain versions and the fused kernels.
"""

import contextlib
import json
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from suo_slam_tpu.models.pkpnet import PkpNet as JaxPkpNet
from suo_slam_tpu.ops import heatmap as jhm
from suo_slam_tpu.ops import roi as jroi
from suo_slam_tpu.parallel import mesh as jmesh
from suo_slam_tpu.train import harness as jh
from suo_slam_tpu_torch.models import convert
from suo_slam_tpu_torch.models import hourglass as hg
from suo_slam_tpu_torch.parallel import mesh as pm
from suo_slam_tpu_torch.train import harness as th
from tests.helpers import dp_ranks
from tests.helpers.synthetic_bop import write_synthetic_bop
from tests.helpers.threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = dp_ranks.HW
EPOCH = 7.0
LR = 1e-2


def _batch_np(seed=0, B=4, O=2, K=41):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, 30, (B, O))
    y1 = rng.uniform(0, 20, (B, O))
    boxes = np.stack([x1, y1, x1 + rng.uniform(30, 60, (B, O)),
                      y1 + rng.uniform(30, 50, (B, O))], -1).astype(np.float32)
    return dict(
        images=rng.uniform(0, 1, (B, 80, 96, 3)).astype(np.float32),
        boxes=boxes,
        # rank 0 (frames 0, 1) holds 3 real rows of 4, rank 1 (frames 2, 3) none
        obj_mask=np.array([[1, 1], [1, 0], [0, 0], [0, 0]], bool),
        prior_uv=rng.uniform(-0.9, 0.9, (B, O, K, 2)).astype(np.float32),
        prior_mask=rng.uniform(size=(B, O, K)) < 0.3,
        uv_gt=rng.uniform(-1, 1, (B, O, K, 2)).astype(np.float32),
        kp_mask=rng.uniform(size=(B, O, K)) < 0.4,
    )


@partial(jax.jit, static_argnums=0)
def _jax_keep(net, variables, jb, key):
    """JAX's dropout keep mask in `_forward_loss` for this key (where relu
    of the pooled logit is 0 the mask has no effect: keep)."""
    b, o = jb.boxes.shape[:2]
    crops = jroi.roi_crop_batch(jb.images, jb.boxes, jb.obj_mask, HW)
    crops = crops.reshape((b * o,) + crops.shape[2:])
    phw = net.prior_hw(HW)
    prior = jhm.render_prior_heatmaps(jb.prior_uv.reshape(b * o, -1, 2),
                                      jb.prior_mask.reshape(b * o, -1), hw=phw,
                                      sigma_px=jhm.prior_sigma_for(phw))
    out, st = net.apply(variables, crops, prior, train=True, row_mask=jb.obj_mask.reshape(-1),
                        rngs={"dropout": key}, mutable=["batch_stats", "intermediates"],
                        capture_intermediates=True)
    d = st["intermediates"]["Dropout_0"]["__call__"][0]
    return (d != 0) | (jnp.maximum(jnp.mean(out.prob_logits, axis=(1, 2)), 0) == 0)


def _sd_np(variables, dtype=np.float32):
    return {k: v.numpy() for k, v in convert.from_jax_variables(
        jax.tree.map(np.asarray, variables), dtype).items()}


def _bn_payload():
    rng = np.random.default_rng(7)
    N, H, W, C = 6, 4, 4, 8
    return dict(x=rng.normal(size=(N, H, W, C)) * 1.5 + rng.normal(size=C),
                dy=rng.normal(size=(N, H, W, C)),
                mask=np.array([1, 1, 0, 0, 0, 0], np.uint8),
                scale=rng.uniform(0.5, 1.5, C), bias=rng.normal(size=C) * 0.3,
                run_mean=rng.normal(size=C) * 0.1, run_var=rng.uniform(0.5, 1.5, C))


def _f64(tree):
    up = lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f" else a
    return jax.tree.map(up, tree)


@contextlib.contextmanager
def _jax_in_f64():
    """JAX's functions traced here compute in f64 where they name f32."""
    f32 = jnp.float32
    jnp.float32 = jnp.float64
    try:
        yield
    finally:
        jnp.float32 = f32


@pytest.fixture(scope="module")
def jax_case():
    net = JaxPkpNet(**dp_ranks.TINY)
    opt = optax.sgd(LR)
    # `jh.init_state`'s state, its init jitted (eager flax init costs ~15 s of CPU)
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3), jnp.float32))
    state = jh.TrainState(variables["params"], variables["batch_stats"],
                          opt.init(variables["params"]), jnp.zeros((), jnp.int32),
                          jax.random.PRNGKey(0))
    b = _batch_np()
    net64 = JaxPkpNet(**dp_ranks.TINY, dtype=jnp.float64)
    s64 = state._replace(params=_f64(state.params), batch_stats=_f64(state.batch_stats))
    jb = jh.Batch(**{k: jnp.asarray(v) for k, v in _f64(b).items()})
    with _jax_in_f64():
        keep = np.array(_jax_keep(net64, {"params": s64.params, "batch_stats": s64.batch_stats},
                                  jb, jax.random.split(state.rng)[1]))
        s1, m1 = jax.jit(jh.make_train_step(net64, opt, input_hw=HW))(s64, jb,
                                                                      jnp.asarray(EPOCH))
    rng = np.random.default_rng(1)
    crops = rng.uniform(0, 1, (5, *HW, 3)).astype(np.float32)
    prior = rng.uniform(0, 1, (5, HW[0] // 4, HW[1] // 4, 41)).astype(np.float32)
    out = jax.jit(net.apply)(variables, jnp.asarray(crops), jnp.asarray(prior))
    return dict(sd=_sd_np(variables), batch=b, keep=keep, loss=float(m1["loss"]),
                new_sd=_sd_np({"params": s1.params, "batch_stats": s1.batch_stats}, np.float64),
                crops=crops, prior=prior,
                infer={k: np.asarray(getattr(out, k)) for k in ("uv", "cov", "kp_mask")})


@pytest.fixture(scope="module")
def ranks(jax_case, tmp_path_factory):
    """Both ranks' results of every two-rank case (one spawn)."""
    payload = dict(step=dict(sd=jax_case["sd"], batch=jax_case["batch"], keep=jax_case["keep"],
                             epoch=EPOCH, lr=LR),
                   bn=_bn_payload(),
                   infer=dict(sd=jax_case["sd"], crops=jax_case["crops"],
                              prior=jax_case["prior"]))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = str(tmp_path_factory.mktemp("pg") / "init")
    procs = [ctx.Process(target=dp_ranks.run_rank, args=(r, 2, init, payload, q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        out = sorted((q.get(timeout=300) for _ in procs), key=lambda r: r["rank"])
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    errors = [r["error"] for r in out if "error" in r]
    assert not errors, errors
    return out


def _one_process_step(jax_case):
    """The port's one-process f64 step on the joined batch."""
    net = dp_ranks.tiny_net({k: v.astype(np.float64) for k, v in jax_case["sd"].items()},
                            torch.float64)
    state = th.TrainState(net, torch.optim.SGD(net.parameters(), lr=LR))
    b = {k: v.astype(np.float64) if v.dtype == np.float32 else v
         for k, v in jax_case["batch"].items()}
    _, m = th.make_train_step(HW)(state, th.to_batch(b, "cpu"), EPOCH,
                                  dropout_mask=torch.from_numpy(jax_case["keep"]))
    return float(m["loss"]), {k: v.detach().numpy() for k, v in net.state_dict().items()}


def test_sharded_step_matches_the_jax_single_device_step(jax_case, ranks):
    for r in ranks:
        got = r["sgd64"]
        np.testing.assert_allclose(got["metrics"]["loss"], jax_case["loss"], rtol=5e-4)
        for k, want in jax_case["new_sd"].items():
            np.testing.assert_allclose(got["sd"][k], want, atol=3e-4, err_msg=k)


def test_sharded_step_matches_the_ports_one_process_step(jax_case, ranks):
    loss, sd = _one_process_step(jax_case)
    for r in ranks:
        got = r["sgd64"]
        assert abs(got["metrics"]["loss"] - loss) <= 1e-12 * abs(loss)
        for k, want in sd.items():
            np.testing.assert_allclose(got["sd"][k], want, atol=1e-10, rtol=0, err_msg=k)
    # one all-reduce of the counts, two a norm, one of the gradients, one of the metrics
    n_norms = sum(isinstance(m, hg.MaskedBatchNorm)
                  for m in dp_ranks.tiny_net(jax_case["sd"]).modules())
    assert ranks[0]["sgd64"]["collectives"] == {"all_reduce": 2 * n_norms + 3, "all_gather": 0,
                                              "broadcast": 0}


def test_ranks_stay_equal_after_an_adam_step(ranks):
    a, b = ranks[0]["adam"], ranks[1]["adam"]
    assert a["metrics"] == b["metrics"]
    for k in a["sd"]:
        np.testing.assert_array_equal(a["sd"][k], b["sd"][k], err_msg=k)
    assert set(a["adam"]) == set(b["adam"]) and a["adam"]
    for k in a["adam"]:
        np.testing.assert_array_equal(a["adam"][k], b["adam"][k], err_msg=k)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(b).max(), 1e-30))


def test_cross_rank_bn_split_matches_the_unsplit_plain_versions(ranks):
    p = _bn_payload()
    cl = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    x, dy, mask = cl(p["x"]), cl(p["dy"]), torch.from_numpy(p["mask"])
    scale, bias = torch.from_numpy(p["scale"]), torch.from_numpy(p["bias"])
    rm, rv = torch.from_numpy(p["run_mean"].copy()), torch.from_numpy(p["run_var"].copy())
    stats = hg.bn_train_stats_plain(x, mask, scale, bias, 1e-5, rm, rv, 0.9)
    mean, _, rstd, inv, shift = stats
    dx, sum_g, sum_gc, dscale = hg.norm_relu_bwd_plain(x, dy, inv, shift, mean, rstd, mask)
    for r in ranks:
        got = r["bn"]
        for g, w in zip(got["stats"] + got["run"], list(stats) + [rm, rv]):
            assert _rel(g, w.numpy()) <= 1e-12
    dx_joined = np.concatenate([r["bn"]["dx"] for r in ranks])
    assert _rel(dx_joined, dx.permute(0, 2, 3, 1).numpy()) <= 1e-12
    # each rank's parameter gradients are its share: their sum is the joined one
    for i, w in enumerate((sum_g, sum_gc, dscale)):
        assert _rel(ranks[0]["bn"]["sums"][i] + ranks[1]["bn"]["sums"][i], w.numpy()) <= 1e-12


def test_sharded_inference_matches_jax(jax_case, ranks):
    want = jax_case["infer"]
    for r in ranks:
        for k in ("uv", "cov", "kp_mask"):
            assert r["infer"][k].shape == want[k].shape
            np.testing.assert_allclose(r["infer"][k], want[k], atol=1e-3, err_msg=k)


def test_pad_to_multiple_and_shard_batch_match_jax():
    x = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    for m in (8, 5, 2):
        want, n = jmesh.pad_to_multiple(x, m)
        got, n2 = pm.pad_to_multiple(x, m)
        np.testing.assert_array_equal(got, want)
        gt, n3 = pm.pad_to_multiple(torch.from_numpy(x), m)
        np.testing.assert_array_equal(gt.numpy(), want)
        assert n == n2 == n3 == 5
    mesh = jmesh.data_parallel_mesh()
    tree = {"a": np.arange(16 * 2, dtype=np.float32).reshape(16, 2),
            "b": np.arange(16, dtype=np.int32)}
    sharded = jmesh.shard_batch(mesh, tree)
    for r, d in enumerate(mesh.devices.reshape(-1)):
        mine = pm.shard_batch(pm.Mesh(None, torch.device("cpu"), r, len(mesh.devices), "gloo"),
                              tree)
        for k in tree:
            (shard,) = [s for s in sharded[k].addressable_shards if s.device == d]
            np.testing.assert_array_equal(mine[k], np.asarray(shard.data))
    with pytest.raises(ValueError, match="pad_to_multiple"):
        pm.shard_batch(pm.Mesh(None, torch.device("cpu"), 0, 3, "gloo"), tree)


def test_batch_size_rule_trains_on_one_card(capsys, monkeypatch):
    from suo_slam_tpu_torch.train import __main__ as cli

    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert cli.plan_world(cuda, 4) == 2
    assert cli.plan_world(torch.device("cpu"), 4) == 1
    capsys.readouterr()
    assert cli.plan_world(cuda, 3) == 1
    assert "no multiple of the 2 visible cards: training on one card" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.plan_world(cuda, 2) == 1
    # under torchrun, a rank other than 0 leaves when the ranks do not divide the batch
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert cli.main(["--device", "cpu", "--batch_size", "3"]) == 0


def _payload(path):
    from suo_slam_tpu_torch.train import checkpoint as ck

    return ck._payload(path)


def _leaves(t, p=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, f"{p}/{k}")
    else:
        yield p, np.asarray(t, np.float64)


def test_training_cli_under_torchrun_matches_one_process(tmp_path, monkeypatch, capsys):
    root = str(tmp_path / "bop" / "ycbv")
    write_synthetic_bop(root, n_scenes=1, n_views=10, splits=("train_real", "test"))
    argv = ["--device", "cpu", "--dataset", "ycbv", "--data_split", "real",
            "--no_augmentations", "--no_bf16", "--batch_size", "2", "--truncate_obj", "3",
            "--steps_per_epoch", "1", "--epochs", "1", "--val_steps", "1", "--workers", "1",
            "--no_resume", "--data_root", root, "--kp_config_root",
            os.path.join(root, "kp_configs")]
    from suo_slam_tpu_torch.train import __main__ as cli

    runs = {}
    for name in ("one", "two"):
        work = tmp_path / name
        work.mkdir()
        if name == "one":  # in this process
            monkeypatch.chdir(work)
            monkeypatch.setenv("SUO_TINY_NET", "1")
            assert cli.main(argv) == 0
            out = capsys.readouterr().out
        else:
            env = dict(os.environ, SUO_TINY_NET="1", OMP_NUM_THREADS="1", PYTHONPATH=REPO)
            r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                "--nproc_per_node", "2", "-m", "suo_slam_tpu_torch.train"]
                               + argv, cwd=work, env=env, capture_output=True, text=True,
                               timeout=300)
            assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
            out = r.stdout
        (outdir,) = (work / "results").iterdir()
        for f in ("checkpoint-0", "params.txt", "viz_train_epoch_0/sample.png"):
            assert (outdir / f).is_file(), (name, f)
        runs[name] = (_payload(str(outdir / "checkpoint-latest")), out)
    assert "Data parallel: 2 ranks (gloo), 1 frames a rank" in runs["two"][1]
    assert json.loads((tmp_path / "two" / "results").glob("*/params.txt").__next__()
                      .read_text())["batch_size"] == 2
    one, two = runs["one"][0], runs["two"][0]
    stats1, stats2 = dict(_leaves(one["batch_stats"])), dict(_leaves(two["batch_stats"]))
    for k in stats1:
        assert _rel(stats2[k], stats1[k]) <= 1e-6, k
    mu1 = dict(_leaves(one["opt_state"]["0"]["mu"]))
    mu2 = dict(_leaves(two["opt_state"]["0"]["mu"]))
    scale = max(np.abs(v).max() for v in mu1.values())
    assert max(np.abs(mu2[k] - mu1[k]).max() for k in mu1) <= 1e-2 * scale
    a = np.concatenate([mu1[k].ravel() for k in mu1])
    b = np.concatenate([mu2[k].ravel() for k in mu1])
    assert a @ b / np.linalg.norm(a) / np.linalg.norm(b) >= 0.9999
    assert int(np.asarray(two["step"])) == int(np.asarray(one["step"])) == 1
