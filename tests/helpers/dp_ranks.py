"""The ranks of `tests/test_torch_parallel.py`'s data-parallel cases: each
spawned process joins a gloo group through a file under the test's tmp_path
and runs every case once, returning numpy results through a queue. It
imports torch and the port only (never JAX), on one intra-op thread."""

from __future__ import annotations

import numpy as np
import torch

TINY = dict(n_stack=1, n_modules=1, features=16)
HW = (64, 64)


def tiny_net(state_dict, dtype=torch.float32):
    from suo_slam_tpu_torch.models.pkpnet import PkpNet

    net = PkpNet(**TINY, dtype=dtype)
    if dtype == torch.float64:
        net = net.double()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    return net.to(memory_format=torch.channels_last)


def _sd(net):
    return {k: v.detach().clone().numpy() for k, v in net.state_dict().items()}


def step_case(mesh, p, optimizer: str, dtype=torch.float32):
    """One sharded step of the tiny net from p["sd"] on this rank's slice of
    p["batch"] with the global dropout mask p["keep"] (f64: parameters and
    batch in f64)."""
    from suo_slam_tpu_torch.parallel import mesh as pm
    from suo_slam_tpu_torch.train import harness as th

    f64 = dtype == torch.float64
    net = tiny_net({k: v.astype(np.float64) if f64 else v for k, v in p["sd"].items()}, dtype)
    opt = (torch.optim.SGD(net.parameters(), lr=p["lr"]) if optimizer == "sgd"
           else th.make_optimizer(net.parameters()))
    state = th.TrainState(net, opt)
    b = {k: v.astype(np.float64) if f64 and v.dtype == np.float32 else v
         for k, v in p["batch"].items()}
    batch = th.to_batch(pm.shard_batch(mesh, b), "cpu")
    pm.reset_counts()
    _, m = th.make_sharded_train_step(mesh, HW)(state, batch, p["epoch"],
                                                torch.from_numpy(p["keep"]))
    out = dict(metrics={k: float(v) for k, v in m.items()}, sd=_sd(net),
               collectives=pm.counts())
    if optimizer == "adam":
        out["adam"] = {f"{i}.{k}": v.numpy().copy() for i, s in enumerate(opt.state.values())
                       for k, v in s.items() if torch.is_tensor(v)}
    return out


def bn_case(mesh, p):
    """K16 / K17's cross-rank plain versions on this rank's rows of p["x"]
    (f64, NCHW channels_last) with this rank's rows of the row mask."""
    from suo_slam_tpu_torch.models import hourglass as hg
    from suo_slam_tpu_torch.parallel import mesh as pm

    cl = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    x, dy = (pm.shard_batch(mesh, cl(p[k])) for k in ("x", "dy"))
    mask = pm.shard_batch(mesh, torch.from_numpy(p["mask"]))
    scale, bias = torch.from_numpy(p["scale"]), torch.from_numpy(p["bias"])
    rm, rv = torch.from_numpy(p["run_mean"].copy()), torch.from_numpy(p["run_var"].copy())
    mean, var, rstd, inv, shift = hg.bn_train_stats_cross(x, mask, scale, bias, 1e-5, rm, rv,
                                                          0.9, mesh.group)
    dx, sum_g, sum_gc, dscale = hg.norm_relu_bwd_cross(x, dy, inv, shift, mean, rstd, mask,
                                                       mesh.group)
    t = lambda v: v.numpy().copy()
    return dict(stats=[t(v) for v in (mean, var, rstd, inv, shift)], run=[t(rm), t(rv)],
                dx=dx.permute(0, 2, 3, 1).numpy().copy(), sums=[t(sum_g), t(sum_gc), t(dscale)])


def inference_case(mesh, p):
    from suo_slam_tpu_torch.parallel import mesh as pm

    fn = pm.make_sharded_inference(tiny_net(p["sd"]), mesh, HW)
    uv, cov, kp = fn(torch.from_numpy(p["crops"]), torch.from_numpy(p["prior"]))
    return dict(uv=uv.numpy(), cov=cov.numpy(), kp_mask=kp.numpy())


def run_rank(rank: int, world: int, init_file: str, payload: dict, queue) -> None:
    torch.set_num_threads(1)
    from suo_slam_tpu_torch.parallel import mesh as pm

    mesh = pm.data_parallel_mesh(["cpu"] * world, rank=rank, init_method=f"file://{init_file}")
    try:
        out = dict(rank=rank, sgd64=step_case(mesh, payload["step"], "sgd", torch.float64),
                   adam=step_case(mesh, payload["step"], "adam"),
                   bn=bn_case(mesh, payload["bn"]), infer=inference_case(mesh, payload["infer"]))
        queue.put(out)
    except BaseException as e:  # the parent reports it
        queue.put(dict(rank=rank, error=repr(e)))
        raise
    finally:
        mesh.close()
