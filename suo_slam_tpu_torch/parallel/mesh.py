"""Data parallelism across cards: a process group, batch shards and sharded
inference.

Port of `suo_slam_tpu/parallel/mesh.py`. The JAX package lays a
`jax.sharding.Mesh` over its devices and lets XLA insert the collectives
into one program. Here every card runs its own process (a process keeps
one card: K11's launcher raises its shared-memory attribute once per
template, not once per device), and the collectives are
`torch.distributed`'s: NCCL where each rank has a card of its own; gloo on
the CPU, or where the caller hands one card to several ranks (NCCL refuses
one card twice). `Mesh` holds the group, this rank's device, its rank and
the world size. The sharded train step is `train/harness.py`
`make_sharded_train_step`; its masked BatchNorm takes the global batch's
statistics through K16 / K17's cross-rank modes (`models/hourglass.py`
`cross_rank`).

`all_reduce_sum` and `all_gather_rows` are the collectives the port makes;
each adds one to its count in `COLLECTIVES` (`counts()`, `reset_counts()`),
as the kernel wrappers count their launches.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVES: dict[str, int] = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
# how long a rank waits in a collective before the group gives up: the
# training CLI's ranks wait at a barrier while rank 0 runs the whole
# validation split, its checkpoint and its dumps (NCCL's default is 10 min)
GROUP_TIMEOUT = timedelta(hours=1)
_lock = threading.Lock()


def _count(name: str) -> None:
    with _lock:
        COLLECTIVES[name] += 1


def reset_counts() -> None:
    with _lock:
        for k in COLLECTIVES:
            COLLECTIVES[k] = 0


def counts() -> dict[str, int]:
    return dict(COLLECTIVES)


@dataclass
class Mesh:
    """This process's place in the data-parallel group."""

    group: object            # the torch.distributed process group
    device: torch.device     # this rank's device
    rank: int
    world_size: int
    backend: str
    owns_group: bool = False  # created here: `close()` destroys it

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def close(self) -> None:
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def data_parallel_mesh(devices=None, rank: int | None = None,
                       init_method: str | None = None) -> Mesh:
    """The data-parallel mesh of this process.

    Joins the default process group where one exists (set up by the caller,
    or by `torchrun`'s launch through `init_method="env://"`); otherwise
    creates it from `init_method` (`tcp://localhost:<port>` or
    `file://<path>`), with this process's `rank` and a world of
    `len(devices)`. `devices`: one device per rank, in rank order; this
    rank's is `devices[rank]` (without a list: the current card where there
    is one, else the CPU). The backend is NCCL where every device is a
    distinct card (or, without a list, where a card is visible), gloo on the
    CPU or where a card repeats. A created group waits `GROUP_TIMEOUT` in a
    collective."""
    devices = None if devices is None else [torch.device(d) for d in devices]
    owns = False
    if not dist.is_initialized():
        if init_method is None:
            raise ValueError("data_parallel_mesh: no process group exists; pass init_method")
        if init_method != "env://" and (devices is None or rank is None):
            raise ValueError("data_parallel_mesh: creating a group needs devices and rank")
        if devices is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        else:
            cuda = all(d.type == "cuda" for d in devices)
            distinct = len({d.index for d in devices}) == len(devices)
            backend = "nccl" if cuda and distinct else "gloo"
        kw = {} if init_method == "env://" else dict(rank=rank, world_size=len(devices))
        if devices is not None and rank is not None and devices[rank].type == "cuda":
            torch.cuda.set_device(devices[rank])  # NCCL binds the current card
        dist.init_process_group(backend, init_method=init_method, timeout=GROUP_TIMEOUT, **kw)
        owns = True
    r, w = dist.get_rank(), dist.get_world_size()
    if devices is not None and len(devices) != w:
        raise ValueError(f"data_parallel_mesh: {len(devices)} devices for a world of {w}")
    be = dist.get_backend()
    if devices is not None:
        dev = devices[r]
    elif be == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=dist.group.WORLD, device=dev, rank=r, world_size=w, backend=be,
                owns_group=owns)


def _rank_entry(rank: int, module: str, fn: str, args: tuple) -> None:
    import importlib

    getattr(importlib.import_module(module), fn)(rank, *args)


def spawn_ranks(world: int, module: str, fn: str, *args) -> None:
    """Start `world` processes, rank r calling `module.fn(r, *args)`, and
    wait for them all (a rank's failure raises here). The function is looked
    up by its module's name, so a `python -m` entry point (a `__main__`
    module, which a spawned process cannot import as such) can name itself."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_entry, args=(module, fn, args), nprocs=world)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over the ranks of `group`, in place (on the current stream's
    order for NCCL)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _count("all_reduce")
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' `t` (equal shapes) joined along the leading axis, in rank
    order."""
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    _count("all_gather")
    return torch.cat(parts)


def broadcast_module(module: torch.nn.Module, mesh: Mesh, src: int = 0) -> None:
    """Give every rank rank `src`'s parameters and buffers."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=mesh.group)
            _count("broadcast")


def pad_to_multiple(x, m: int):
    """Pad the leading axis to a multiple of m with zeros (returns padded,
    true_n); a numpy array or a torch tensor."""
    n = x.shape[0]
    r = (-n) % m
    if r == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((r,) + tuple(x.shape[1:]))]), n
    pad = np.zeros((r,) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad]), n


def _rows(x, mesh: Mesh):
    n = x.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"shard_batch: {n} rows do not split over {mesh.world_size} ranks "
                         "(pad_to_multiple)")
    k = n // mesh.world_size
    return x[mesh.rank * k:(mesh.rank + 1) * k]


def shard_batch(mesh: Mesh, tree):
    """This rank's contiguous slice of the leading axis of every leaf (tensor
    or array) of a batch: a NamedTuple, dict, list or tuple of them."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return _rows(tree, mesh)
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_batch(mesh, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    return tree


def make_sharded_inference(net, mesh: Mesh, input_hw=(256, 256)):
    """PkpNet's forward with the crop batch split over the ranks.

    Returns fn(images_roi [N, H, W, 3], prior [N, ph, pw, K] or None) ->
    (uv, cov, kp_mask) of all N crops on every rank: the batch is padded to
    a multiple of the world size, each rank runs its contiguous slice
    through `net` (inference, running statistics), the outputs are gathered
    in rank order and the padding cut. `net` is on `mesh.device`; cov is
    None for a net without the covariance head. `input_hw` is the crops'
    size, as in the JAX function."""

    @torch.no_grad()
    def fn(images_roi: torch.Tensor, prior: torch.Tensor | None = None):
        if tuple(images_roi.shape[1:3]) != tuple(input_hw):
            raise ValueError(f"sharded inference: crops of {tuple(input_hw)} expected, got "
                             f"{tuple(images_roi.shape)}")
        imgs, n = pad_to_multiple(images_roi, mesh.world_size)
        mine = _rows(imgs, mesh).to(mesh.device)
        p = None if prior is None else _rows(pad_to_multiple(prior, mesh.world_size)[0],
                                             mesh).to(mesh.device)
        was = net.training
        net.eval()
        try:
            out = net(mine, p)
        finally:
            net.train(was)
        uv = all_gather_rows(out.uv, mesh)[:n]
        cov = None if out.cov is None else all_gather_rows(out.cov, mesh)[:n]
        return uv, cov, all_gather_rows(out.kp_mask, mesh)[:n]

    return fn
