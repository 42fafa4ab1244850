"""Carry PkpNet weights across from the JAX package's flax variables.

`from_jax_variables(tree)` takes the flax `{"params", "batch_stats"}` tree
(nested dicts of numpy arrays, e.g. `jax.tree.map(np.asarray, variables)`)
and returns a `state_dict` for `models.pkpnet.PkpNet`. Conv kernels go HWIO
-> OIHW, Dense kernels [in, out] -> [out, in]. The structure is read from the
tree itself: flax names submodules `<Class>_<k>` in call order, so the counts
of `Hourglass_*`, `Residual_*` and `Conv_*` under the backbone give n_stack,
n_modules and whether the post-stem prior projection exists.
"""

from __future__ import annotations

import numpy as np
import torch


def _n(tree: dict, cls: str) -> int:
    return sum(1 for k in tree if k.rsplit("_", 1)[0] == cls)


class _Walker:
    def __init__(self, params: dict, stats: dict):
        self.sd: dict[str, torch.Tensor] = {}
        self.params = params
        self.stats = stats

    def put(self, key: str, a) -> None:
        self.sd[key] = torch.from_numpy(np.array(a, np.float32, copy=True))

    def conv(self, p: dict, key: str) -> None:
        self.put(f"{key}.weight", np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        self.put(f"{key}.bias", p["bias"])

    def norm(self, p: dict, s: dict, key: str) -> None:
        p, s = p["MaskedBatchNorm_0"], s["MaskedBatchNorm_0"]
        self.put(f"{key}.scale", p["scale"])
        self.put(f"{key}.bias", p["bias"])
        self.put(f"{key}.mean", s["mean"])
        self.put(f"{key}.var", s["var"])

    def residual(self, p: dict, s: dict, key: str) -> None:
        for i in range(3):
            self.norm(p[f"Norm_{i}"], s[f"Norm_{i}"], f"{key}.norm{i}")
            self.conv(p[f"Conv_{i}"], f"{key}.conv{i}")
        if "Conv_3" in p:
            self.conv(p["Conv_3"], f"{key}.skip")

    def hourglass(self, p: dict, s: dict, key: str, m: int) -> None:
        nested = "Hourglass_0" in p
        groups = ["up1", "low1"] + ([] if nested else ["low2"]) + ["low3"]
        r = 0
        for g in groups:
            for j in range(m):
                self.residual(p[f"Residual_{r}"], s[f"Residual_{r}"], f"{key}.{g}.{j}")
                r += 1
        if nested:
            self.hourglass(p["Hourglass_0"], s["Hourglass_0"], f"{key}.low2", m)

    def backbone(self, p: dict, s: dict, key: str) -> None:
        n_stack = _n(p, "Hourglass")
        m = (_n(p, "Residual") - 3) // n_stack
        has_extra = _n(p, "Conv") - (4 * n_stack - 1) == 1
        self.conv(p["Conv_0"], f"{key}.stem")
        self.norm(p["Norm_0"], s["Norm_0"], f"{key}.stem_norm")
        for i in range(3):
            self.residual(p[f"Residual_{i}"], s[f"Residual_{i}"], f"{key}.pre.{i}")
        c = 1
        if has_extra:
            self.conv(p["Conv_1"], f"{key}.extra_proj")
            c = 2
        r = 3
        for i in range(n_stack):
            self.hourglass(p[f"Hourglass_{i}"], s[f"Hourglass_{i}"], f"{key}.hgs.{i}", m)
            for j in range(m):
                self.residual(p[f"Residual_{r}"], s[f"Residual_{r}"], f"{key}.lls.{i}.{j}")
                r += 1
            self.conv(p[f"Conv_{c}"], f"{key}.ll_convs.{i}")
            self.norm(p[f"Norm_{i + 1}"], s[f"Norm_{i + 1}"], f"{key}.ll_norms.{i}")
            self.conv(p[f"Conv_{c + 1}"], f"{key}.heads.{i}")
            c += 2
            if i < n_stack - 1:
                self.conv(p[f"Conv_{c}"], f"{key}.ll_merges.{i}")
                self.conv(p[f"Conv_{c + 1}"], f"{key}.out_merges.{i}")
                c += 2


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


def from_jax_variables(tree: dict) -> dict[str, torch.Tensor]:
    """flax PkpNet variables {"params", "batch_stats"} -> PkpNet state_dict."""
    if "params" not in tree or "batch_stats" not in tree:
        raise ValueError("expected a flax {'params', 'batch_stats'} tree")
    w = _Walker(tree["params"], tree["batch_stats"])
    w.backbone(tree["params"]["HourglassNet_0"],
               tree["batch_stats"]["HourglassNet_0"], "backbone")
    dense = tree["params"]["Dense_0"]
    w.put("classifier.weight", np.asarray(dense["kernel"]).T)
    w.put("classifier.bias", dense["bias"])
    return w.sd
