"""Read a reference PyTorch PkpNet checkpoint (`.pth.tar`).

The port's own numpy copy of `suo_slam_tpu/train/torch_convert.py`. The
reference ships trained checkpoints (`checkpoint-59` YCB-V, `checkpoint-88`
T-LESS) as `.pth.tar` with `{args, epoch, model, best_val, optimizer}`.
`convert_state_dict` maps the reference state_dict onto the JAX package's
flax variables tree (params / batch_stats), layer for layer:

  reference state_dict key                flax tree
  backbone.conv1_.{weight,bias}        -> HourglassNet_0/Conv_0
  backbone.bn1.*                       -> HourglassNet_0/Norm_0/MaskedBatchNorm_0
  backbone.r1|r4|r5.*                  -> HourglassNet_0/Residual_0|1|2
  backbone.hourglass.N.*               -> HourglassNet_0/Hourglass_N (recursive)
  backbone.Residual.{i*nM+j}.*         -> HourglassNet_0/Residual_{3+i*nM+j}
  backbone.lin_.N.{0,1}.*              -> Conv_{lin} + Norm_{N+1}
  backbone.tmpOut.N / ll_.N / tmpOut_.N-> the per-stack head/reinjection convs
  classifier.2.{weight,bias}           -> Dense_0

and `models.convert.from_jax_variables` carries that tree into the port's
`PkpNet(prior_mode="concat", transpose_heatmaps=True)` (`eval/loading.py`
composes the two). The reference's soft-argmax meshgrid is transposed (u
along heatmap rows), hence `transpose_heatmaps`.
"""

from __future__ import annotations

import numpy as np


def _conv(sd, key):
    w = np.asarray(sd[f"{key}.weight"], np.float32)
    return {
        "kernel": np.transpose(w, (2, 3, 1, 0)),  # OIHW -> HWIO
        "bias": np.asarray(sd[f"{key}.bias"], np.float32),
    }


def _bn(sd, key):
    params = {
        "scale": np.asarray(sd[f"{key}.weight"], np.float32),
        "bias": np.asarray(sd[f"{key}.bias"], np.float32),
    }
    stats = {
        "mean": np.asarray(sd[f"{key}.running_mean"], np.float32),
        "var": np.asarray(sd[f"{key}.running_var"], np.float32),
    }
    return {"MaskedBatchNorm_0": params}, {"MaskedBatchNorm_0": stats}


def _residual(sd, key, has_skip):
    """reference Residual: bn, conv1, bn1, conv2, bn2, conv3[, conv4]."""
    p, s = {}, {}
    for i, bn_name in enumerate(["bn", "bn1", "bn2"]):
        p[f"Norm_{i}"], s[f"Norm_{i}"] = _bn(sd, f"{key}.{bn_name}")
    for i, cv in enumerate(["conv1", "conv2", "conv3"]):
        p[f"Conv_{i}"] = _conv(sd, f"{key}.{cv}")
    if has_skip:
        p["Conv_3"] = _conv(sd, f"{key}.conv4")
    return p, s


def _has(sd, key):
    return f"{key}.weight" in sd


def _hourglass(sd, key, n, n_modules):
    """reference Hourglass: up1_ x nM, low1 pool, low1_ x nM,
    low2 (recursive | low2_ x nM), low3_ x nM — the flax tree names
    Residual_0.. in the order up1, low1, [inner], low3."""
    p, s = {}, {}
    r = 0
    for j in range(n_modules):  # up1_
        p[f"Residual_{r}"], s[f"Residual_{r}"] = _residual(
            sd, f"{key}.up1_.{j}", _has(sd, f"{key}.up1_.{j}.conv4"))
        r += 1
    for j in range(n_modules):  # low1_
        p[f"Residual_{r}"], s[f"Residual_{r}"] = _residual(
            sd, f"{key}.low1_.{j}", _has(sd, f"{key}.low1_.{j}.conv4"))
        r += 1
    if n > 1:
        p["Hourglass_0"], s["Hourglass_0"] = _hourglass(
            sd, f"{key}.low2", n - 1, n_modules)
    else:
        for j in range(n_modules):  # low2_
            p[f"Residual_{r}"], s[f"Residual_{r}"] = _residual(
                sd, f"{key}.low2_.{j}", _has(sd, f"{key}.low2_.{j}.conv4"))
            r += 1
    for j in range(n_modules):  # low3_
        p[f"Residual_{r}"], s[f"Residual_{r}"] = _residual(
            sd, f"{key}.low3_.{j}", _has(sd, f"{key}.low3_.{j}.conv4"))
        r += 1
    return p, s


def convert_state_dict(sd, n_stack=2, n_modules=2, depth=4):
    """torch state_dict (name -> array-like) -> (params, batch_stats) trees
    for `PkpNet(norm="batch", prior_mode="concat",
    transpose_heatmaps=True)`."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    hp, hs = {}, {}  # HourglassNet trees
    hp["Conv_0"] = _conv(sd, "backbone.conv1_")
    hp["Norm_0"], hs["Norm_0"] = _bn(sd, "backbone.bn1")
    for i, name in enumerate(["r1", "r4", "r5"]):
        hp[f"Residual_{i}"], hs[f"Residual_{i}"] = _residual(
            sd, f"backbone.{name}", _has(sd, f"backbone.{name}.conv4"))

    conv_i = 1  # concat mode: no prior-injection conv
    res_i = 3
    for i in range(n_stack):
        hp[f"Hourglass_{i}"], hs[f"Hourglass_{i}"] = _hourglass(
            sd, f"backbone.hourglass.{i}", depth, n_modules)
        for j in range(n_modules):
            k = f"backbone.Residual.{i * n_modules + j}"
            hp[f"Residual_{res_i}"], hs[f"Residual_{res_i}"] = _residual(
                sd, k, _has(sd, f"{k}.conv4"))
            res_i += 1
        # lin_ = Sequential(Conv2d, BatchNorm2d, ReLU)
        hp[f"Conv_{conv_i}"] = _conv(sd, f"backbone.lin_.{i}.0")
        conv_i += 1
        hp[f"Norm_{i + 1}"], hs[f"Norm_{i + 1}"] = _bn(sd, f"backbone.lin_.{i}.1")
        hp[f"Conv_{conv_i}"] = _conv(sd, f"backbone.tmpOut.{i}")
        conv_i += 1
        if i < n_stack - 1:
            hp[f"Conv_{conv_i}"] = _conv(sd, f"backbone.ll_.{i}")
            conv_i += 1
            hp[f"Conv_{conv_i}"] = _conv(sd, f"backbone.tmpOut_.{i}")
            conv_i += 1

    params = {
        "HourglassNet_0": hp,
        "Dense_0": {
            "kernel": np.asarray(sd["classifier.2.weight"], np.float32).T,
            "bias": np.asarray(sd["classifier.2.bias"], np.float32),
        },
    }
    return params, {"HourglassNet_0": hs}


def load_torch_checkpoint(path):
    """Unpickle a reference `.pth.tar` -> (flax-layout variables, epoch,
    train_args); the variables are `{"params", "batch_stats"}` numpy trees."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.numpy() for k, v in ckpt["model"].items()}
    params, stats = convert_state_dict(sd)
    args = ckpt.get("args")
    return (
        {"params": params, "batch_stats": stats},
        int(ckpt.get("epoch", -1)),
        args,
    )
