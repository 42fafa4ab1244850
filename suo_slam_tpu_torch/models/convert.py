"""Carry PkpNet weights and optimizer state between the port and the JAX
package's flax trees.

`from_jax_variables(tree)` takes the flax variables tree (nested dicts of
numpy arrays, e.g. `jax.tree.map(np.asarray, variables)`): "params", with
"batch_stats" for a `norm="batch"` net (a `norm="group"` net has none: its
norms are `Norm_k/GroupNorm_0/{scale, bias}`), and the quantized net's
"quant" collection (`Conv_k/act_absmax` of every convolution but the heads)
where present; it returns a `state_dict` for `models.pkpnet.PkpNet`.
`to_jax_variables(net)` is its inverse, with the collections the JAX net's
`init` makes. Conv kernels go HWIO <-> OIHW, Dense kernels [in, out] <->
[out, in]. flax names submodules `<Class>_<k>` in call order; `_plan` walks
that order for a given structure (stacks, modules per stack, hourglass depth,
whether the post-stem prior projection exists, the norm), which
`backbone_config` reads from a tree and `_net_structure` from a net.

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


# plan entries: (flax path under params / batch_stats / quant, torch prefix,
# kind); kind "conv" (kernel, bias; act_absmax in a quantized net), "head"
# (an f32 heatmap head: kernel, bias), "norm" (the path ends in the norm's
# module, MaskedBatchNorm_0: scale, bias | mean, var; GroupNorm_0: scale,
# bias), "dense" (kernel, bias)
_NORM_MODULE = {"batch": "MaskedBatchNorm_0", "group": "GroupNorm_0"}


def _residual(path: tuple, key: str, skip: bool, nm: str) -> list:
    out = []
    for i in range(3):
        out.append((path + (f"Norm_{i}", nm), f"{key}.norm{i}", "norm"))
        out.append((path + (f"Conv_{i}",), f"{key}.conv{i}", "conv"))
    if skip:
        out.append((path + ("Conv_3",), f"{key}.skip", "conv"))
    return out


def _hourglass(path: tuple, key: str, m: int, depth: int, nm: str) -> list:
    """In flax's creation order: up1, low1, the nested hourglass (or low2's
    residuals at the bottom), low3."""
    out, r = [], 0
    for g in ("up1", "low1", "low2", "low3"):
        if g == "low2" and depth > 1:
            out += _hourglass(path + ("Hourglass_0",), f"{key}.low2", m, depth - 1, nm)
            continue
        for j in range(m):
            out += _residual(path + (f"Residual_{r}",), f"{key}.{g}.{j}", False, nm)
            r += 1
    return out


def _plan(n_stack: int, m: int, depth: int, has_extra: bool, features: int,
          norm: str = "batch") -> list:
    b, key = ("HourglassNet_0",), "backbone"
    nm = _NORM_MODULE[norm]
    out = [(b + ("Conv_0",), f"{key}.stem", "conv"),
           (b + ("Norm_0", nm), f"{key}.stem_norm", "norm")]
    for i, c_in in enumerate((64, 128, 128)):
        out += _residual(b + (f"Residual_{i}",), f"{key}.pre.{i}",
                         c_in != (128 if i < 2 else features), nm)
    c = 1
    if has_extra:
        out.append((b + ("Conv_1",), f"{key}.extra_proj", "conv"))
        c = 2
    r = 3
    for i in range(n_stack):
        out += _hourglass(b + (f"Hourglass_{i}",), f"{key}.hgs.{i}", m, depth, nm)
        for j in range(m):
            out += _residual(b + (f"Residual_{r}",), f"{key}.lls.{i}.{j}", False, nm)
            r += 1
        out.append((b + (f"Conv_{c}",), f"{key}.ll_convs.{i}", "conv"))
        out.append((b + (f"Norm_{i + 1}", nm), f"{key}.ll_norms.{i}", "norm"))
        out.append((b + (f"Conv_{c + 1}",), f"{key}.heads.{i}", "head"))
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
        norm="group" if "GroupNorm_0" in p["Norm_0"] else "batch",
    )


def _tree_plan(tree: dict) -> list:
    cfg = backbone_config(tree)
    return _plan(cfg["n_stack"], cfg["n_modules"],
                 _depth(tree["params"]["HourglassNet_0"]["Hourglass_0"]),
                 cfg["prior_mode"] == "post_stem", cfg["features"], cfg["norm"])


def _net_structure(net) -> list:
    bb = net.backbone
    return _plan(bb.n_stack, len(bb.lls[0]), bb.depth, bb.extra_proj is not None,
                 bb.heads[0].in_channels, bb.norm)


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
                yield path + (f,), f"{key}.{f}", "vector"
        else:
            yield path + ("kernel",), f"{key}.weight", "dense" if kind == "dense" else "conv"
            yield path + ("bias",), f"{key}.bias", "vector"


def _stats_of(plan: list):
    for path, key, kind in plan:
        if kind == "norm" and path[-1] == _NORM_MODULE["batch"]:
            for f in ("mean", "var"):
                yield path + (f,), f"{key}.{f}"


def _quant_of(plan: list):
    """(flax path under "quant", torch name) of each quantized convolution's
    act_absmax: every convolution but the heads."""
    for path, key, kind in plan:
        if kind == "conv":
            yield path + ("act_absmax",), f"{key}.act_absmax"


def _sorted(tree):
    """Keys sorted at every level: the order of the trees flax's `init` and
    every jitted JAX step return, so they serialize to the same bytes."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _np(t, dtype=np.float32) -> np.ndarray:
    return np.array(t.detach().cpu() if isinstance(t, torch.Tensor) else t, dtype, copy=True)


def from_jax_variables(tree: dict, dtype=np.float32) -> dict[str, torch.Tensor]:
    """flax PkpNet variables ({"params"}, with "batch_stats" for a BatchNorm
    net, and "quant" for a quantized one) -> PkpNet state_dict, its tensors
    in `dtype` (f32; f64 keeps an f64 tree exact)."""
    if "params" not in tree:
        raise ValueError("expected a flax variables tree with 'params'")
    plan = _tree_plan(tree)
    stats = list(_stats_of(plan))
    if stats and "batch_stats" not in tree:
        raise ValueError("a norm='batch' tree needs its 'batch_stats'")
    sd = {}
    for path, name, kind in _params_of(plan):
        a = _np(_get(tree["params"], path), dtype)
        sd[name] = torch.from_numpy(_to_torch(kind, a).copy())
    for path, name in stats:
        sd[name] = torch.from_numpy(_np(_get(tree["batch_stats"], path), dtype))
    if tree.get("quant"):
        for path, name in _quant_of(plan):
            sd[name] = torch.from_numpy(_np(_get(tree["quant"], path), dtype))
    return sd


def to_jax_variables(net) -> dict:
    """PkpNet -> flax variables (numpy f32, flax's auto-names, keys sorted
    as flax returns them): "params", "batch_stats" for a BatchNorm net and
    "quant" for a quantized one, the collections the JAX net's `init` makes
    and the tree `from_jax_variables` reads."""
    plan = _net_structure(net)
    sd = net.state_dict()
    out = {"params": {}}
    for path, name, kind in _params_of(plan):
        _put(out["params"], path, _to_flax(kind, _np(sd[name])))
    for path, name in _stats_of(plan):
        _put(out.setdefault("batch_stats", {}), path, _np(sd[name]))
    for path, name in _quant_of(plan):
        if name in sd:
            _put(out.setdefault("quant", {}), path, _np(sd[name]))
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
