"""Carry PkpNet weights and optimizer state between the port and the JAX
package's flax trees.

`from_jax_variables(tree)` takes the flax `{"params", "batch_stats"}` tree
(nested dicts of numpy arrays, e.g. `jax.tree.map(np.asarray, variables)`)
and returns a `state_dict` for `models.pkpnet.PkpNet`; `to_jax_variables(net)`
is its inverse. Conv kernels go HWIO <-> OIHW, Dense kernels [in, out] <->
[out, in]. flax names submodules `<Class>_<k>` in call order; `_plan` walks
that order for a given structure (stacks, modules per stack, hourglass depth,
whether the post-stem prior projection exists), which `backbone_config` reads
from a tree and `_net_structure` from a net.

`adam_to_optax(net, optimizer)` / `adam_from_optax(net, optimizer, state)`
map `torch.optim.Adam`'s per-parameter state (`step`, `exp_avg`,
`exp_avg_sq`) onto optax's `adam` state as flax serializes it: the chain's
tuple `{"0": ScaleByAdamState{count, mu, nu}, "1": EmptyState{}}`, with
`mu` / `nu` trees shaped like the params and `count` an int32 scalar.
"""

from __future__ import annotations

import numpy as np
import torch


def _n(tree: dict, cls: str) -> int:
    return sum(1 for k in tree if k.rsplit("_", 1)[0] == cls)


# plan entries: (flax path under params / batch_stats, torch prefix, kind);
# kind "conv" (kernel, bias), "norm" (scale, bias | mean, var under
# MaskedBatchNorm_0), "dense" (kernel, bias)
def _residual(path: tuple, key: str, skip: bool) -> list:
    out = []
    for i in range(3):
        out.append((path + (f"Norm_{i}",), f"{key}.norm{i}", "norm"))
        out.append((path + (f"Conv_{i}",), f"{key}.conv{i}", "conv"))
    if skip:
        out.append((path + ("Conv_3",), f"{key}.skip", "conv"))
    return out


def _hourglass(path: tuple, key: str, m: int, depth: int) -> list:
    """In flax's creation order: up1, low1, the nested hourglass (or low2's
    residuals at the bottom), low3."""
    out, r = [], 0
    for g in ("up1", "low1", "low2", "low3"):
        if g == "low2" and depth > 1:
            out += _hourglass(path + ("Hourglass_0",), f"{key}.low2", m, depth - 1)
            continue
        for j in range(m):
            out += _residual(path + (f"Residual_{r}",), f"{key}.{g}.{j}", False)
            r += 1
    return out


def _plan(n_stack: int, m: int, depth: int, has_extra: bool, features: int) -> list:
    b, key = ("HourglassNet_0",), "backbone"
    out = [(b + ("Conv_0",), f"{key}.stem", "conv"), (b + ("Norm_0",), f"{key}.stem_norm", "norm")]
    for i, c_in in enumerate((64, 128, 128)):
        out += _residual(b + (f"Residual_{i}",), f"{key}.pre.{i}",
                         c_in != (128 if i < 2 else features))
    c = 1
    if has_extra:
        out.append((b + ("Conv_1",), f"{key}.extra_proj", "conv"))
        c = 2
    r = 3
    for i in range(n_stack):
        out += _hourglass(b + (f"Hourglass_{i}",), f"{key}.hgs.{i}", m, depth)
        for j in range(m):
            out += _residual(b + (f"Residual_{r}",), f"{key}.lls.{i}.{j}", False)
            r += 1
        out.append((b + (f"Conv_{c}",), f"{key}.ll_convs.{i}", "conv"))
        out.append((b + (f"Norm_{i + 1}",), f"{key}.ll_norms.{i}", "norm"))
        out.append((b + (f"Conv_{c + 1}",), f"{key}.heads.{i}", "conv"))
        c += 2
        if i < n_stack - 1:
            out.append((b + (f"Conv_{c}",), f"{key}.ll_merges.{i}", "conv"))
            out.append((b + (f"Conv_{c + 1}",), f"{key}.out_merges.{i}", "conv"))
            c += 2
    out.append((("Dense_0",), "classifier", "dense"))
    return out


def _depth(p: dict) -> int:
    d = 1
    while "Hourglass_0" in p:
        p, d = p["Hourglass_0"], d + 1
    return d


def backbone_config(tree: dict) -> dict:
    """PkpNet constructor arguments implied by a flax variables tree."""
    p = tree["params"]["HourglassNet_0"]
    n_stack = _n(p, "Hourglass")
    has_extra = _n(p, "Conv") - (4 * n_stack - 1) == 1
    return dict(
        n_stack=n_stack,
        n_modules=(_n(p, "Residual") - 3) // n_stack,
        features=int(np.asarray(p["Residual_2"]["Conv_2"]["kernel"]).shape[-1]),
        num_kp=int(np.asarray(tree["params"]["Dense_0"]["kernel"]).shape[0]),
        prior_mode="post_stem" if has_extra else "concat",
    )


def _tree_plan(tree: dict) -> list:
    cfg = backbone_config(tree)
    return _plan(cfg["n_stack"], cfg["n_modules"],
                 _depth(tree["params"]["HourglassNet_0"]["Hourglass_0"]),
                 cfg["prior_mode"] == "post_stem", cfg["features"])


def _net_structure(net) -> list:
    bb = net.backbone
    return _plan(bb.n_stack, len(bb.lls[0]), bb.depth, bb.extra_proj is not None,
                 bb.heads[0].in_channels)


def _get(tree: dict, path: tuple) -> dict:
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


# torch <-> flax array layout of each parameter kind
def _to_torch(kind: str, a: np.ndarray) -> np.ndarray:
    if kind == "conv":
        return np.transpose(a, (3, 2, 0, 1))
    return a.T if kind == "dense" else a


def _to_flax(kind: str, a: np.ndarray) -> np.ndarray:
    if kind == "conv":
        return np.transpose(a, (2, 3, 1, 0))
    return a.T if kind == "dense" else a


def _params_of(plan: list):
    """(flax param path, torch parameter name, layout kind) of every
    parameter, in plan order."""
    for path, key, kind in plan:
        if kind == "norm":
            for f in ("scale", "bias"):
                yield path + ("MaskedBatchNorm_0", f), f"{key}.{f}", "vector"
        else:
            yield path + ("kernel",), f"{key}.weight", "conv" if kind == "conv" else "dense"
            yield path + ("bias",), f"{key}.bias", "vector"


def _stats_of(plan: list):
    for path, key, kind in plan:
        if kind == "norm":
            for f in ("mean", "var"):
                yield path + ("MaskedBatchNorm_0", f), f"{key}.{f}"


def _sorted(tree):
    """Keys sorted at every level: the order of the trees flax's `init` and
    every jitted JAX step return, so they serialize to the same bytes."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _np(t, dtype=np.float32) -> np.ndarray:
    return np.array(t.detach().cpu() if isinstance(t, torch.Tensor) else t, dtype, copy=True)


def from_jax_variables(tree: dict, dtype=np.float32) -> dict[str, torch.Tensor]:
    """flax PkpNet variables {"params", "batch_stats"} -> PkpNet state_dict,
    its tensors in `dtype` (f32; f64 keeps an f64 tree exact)."""
    if "params" not in tree or "batch_stats" not in tree:
        raise ValueError("expected a flax {'params', 'batch_stats'} tree")
    plan = _tree_plan(tree)
    sd = {}
    for path, name, kind in _params_of(plan):
        a = _np(_get(tree["params"], path), dtype)
        sd[name] = torch.from_numpy(_to_torch(kind, a).copy())
    for path, name in _stats_of(plan):
        sd[name] = torch.from_numpy(_np(_get(tree["batch_stats"], path), dtype))
    return sd


def to_jax_variables(net) -> dict:
    """PkpNet -> flax variables {"batch_stats", "params"} (numpy f32, flax's
    auto-names, keys sorted as flax returns them), the tree
    `from_jax_variables` reads."""
    plan = _net_structure(net)
    sd = net.state_dict()
    out = {"params": {}, "batch_stats": {}}
    for path, name, kind in _params_of(plan):
        _put(out["params"], path, _to_flax(kind, _np(sd[name])))
    for path, name in _stats_of(plan):
        _put(out["batch_stats"], path, _np(sd[name]))
    return _sorted(out)


def adam_to_optax(net, optimizer: torch.optim.Optimizer) -> dict:
    """`torch.optim.Adam`'s state as optax `adam`'s serialized state dict
    (zeros and count 0 before the first step)."""
    plan = _net_structure(net)
    named = dict(net.named_parameters())
    mu, nu, count = {}, {}, 0
    for path, name, kind in _params_of(plan):
        p = named[name]
        st = optimizer.state.get(p, {})
        zero = np.zeros(tuple(p.shape), np.float32)
        _put(mu, path, _to_flax(kind, _np(st["exp_avg"]) if st else zero))
        _put(nu, path, _to_flax(kind, _np(st["exp_avg_sq"]) if st else zero))
        if st:
            count = int(st["step"])
    return {"0": {"count": np.asarray(count, np.int32), "mu": _sorted(mu), "nu": _sorted(nu)},
            "1": {}}


def adam_from_optax(net, optimizer: torch.optim.Optimizer, opt_state: dict) -> None:
    """Load optax `adam`'s serialized state into `torch.optim.Adam` (count 0
    leaves the optimizer fresh, as before its first step)."""
    st = opt_state["0"]
    count = int(np.asarray(st["count"]))
    optimizer.state.clear()
    if count == 0:
        return
    named = dict(net.named_parameters())
    for path, name, kind in _params_of(_net_structure(net)):
        p = named[name]
        t = lambda tree: torch.from_numpy(_to_torch(kind, _np(_get(tree, path))).copy()).to(
            device=p.device, dtype=p.dtype)
        optimizer.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                              "exp_avg": t(st["mu"]), "exp_avg_sq": t(st["nu"])}
