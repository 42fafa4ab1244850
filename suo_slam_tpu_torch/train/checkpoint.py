"""Checkpoints in the JAX package's format, with its directory contract.

Port of `suo_slam_tpu/train/checkpoint.py`: results directories
`results/pkpnet_<dataset>_<split>_<ext>_<MM-DD-YYYY@HH-MM-SS>/` hold
`checkpoint-<epoch>`, `checkpoint-latest` and `model_best`, each the flax
msgpack bytes (`train/msgpack.py`) of

    {"params", "batch_stats": the flax variables tree (`models/convert.py`;
     "batch_stats" is {} for a norm="group" net, as the JAX package writes it),
     "opt_state": optax adam's state {"0": {count, mu, nu}, "1": {}},
     "step": int32, "rng": uint32[2] (the dropout key), "epoch": int64,
     "best_val", "best_train": float64, "args_json": the CLI's arguments}

beside a `.meta.json` sidecar with the epoch, the two selection metrics and
the arguments. The JAX package's `load_checkpoint` restores a file written
here and the reverse: the trees have the same structure, dtypes and bytes.
"""

from __future__ import annotations

import json
import os
import re
import time

import numpy as np

from ..models import convert
from . import msgpack


def output_dir_name(dataset: str, split: str, ext: str = "") -> str:
    stamp = time.strftime("%m-%d-%Y@%H-%M-%S")
    parts = ["pkpnet", dataset, split.replace("+", "-")]
    if ext:
        parts.append(ext)
    return "_".join(parts) + "_" + stamp


def find_resume_dir(results_root: str, dataset: str, split: str, ext: str = "") -> str | None:
    """The newest matching results directory (by its timestamp) that holds a
    `checkpoint-latest`, or None."""
    if not os.path.isdir(results_root):
        return None
    prefix = "_".join(["pkpnet", dataset, split.replace("+", "-")] + ([ext] if ext else []))
    pat = re.compile(re.escape(prefix) + r"_(\d{2}-\d{2}-\d{4}@\d{2}-\d{2}-\d{2})$")
    best, best_t = None, None
    for name in os.listdir(results_root):
        m = pat.match(name)
        if not m:
            continue
        t = time.strptime(m.group(1), "%m-%d-%Y@%H-%M-%S")
        if (best_t is None or t > best_t) and os.path.exists(
                os.path.join(results_root, name, "checkpoint-latest")):
            best, best_t = os.path.join(results_root, name), t
    return best


def save_checkpoint(outdir: str, state, epoch: int, args: dict, best_val: float,
                    is_best: bool = False, best_train: float = float("inf")) -> None:
    """Write `checkpoint-<epoch>`, `checkpoint-latest` and, if `is_best`,
    `model_best`, each with its `.meta.json`, atomically (tmp + rename)."""
    variables = convert.to_jax_variables(state.net)
    payload = {  # the JAX package's key order
        "params": variables["params"],
        "batch_stats": variables.get("batch_stats", {}),
        "opt_state": convert.adam_to_optax(state.net, state.optimizer),
        "step": np.asarray(state.step, np.int32),
        "rng": np.asarray(state.rng, np.uint32),
        "epoch": np.asarray(epoch, np.int64),
        "best_val": np.asarray(best_val, np.float64),
        "best_train": np.asarray(best_train, np.float64),
        "args_json": json.dumps(args),
    }
    data = msgpack.packb(payload)
    meta = json.dumps({"epoch": int(epoch), "best_val": float(best_val),
                       "best_train": float(best_train), "args": args})
    os.makedirs(outdir, exist_ok=True)
    for name in [f"checkpoint-{epoch}", "checkpoint-latest"] + (["model_best"] if is_best else []):
        for path, body, mode in ((os.path.join(outdir, name), data, "wb"),
                                 (os.path.join(outdir, name + ".meta.json"), meta, "w")):
            with open(path + ".tmp", mode) as f:
                f.write(body)
            os.replace(path + ".tmp", path)


def _read_meta(path: str) -> dict | None:
    try:
        with open(path + ".meta.json") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _payload(path: str) -> dict:
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def load_checkpoint(path: str, state):
    """Restore a checkpoint into `state` (its net, optimizer, step and key)
    in place. Returns (state, epoch, args_dict, best_val, best_train);
    `best_train` is inf in a checkpoint that predates it."""
    payload = _payload(path)
    sd = convert.from_jax_variables({"params": payload["params"],
                                     "batch_stats": payload["batch_stats"]})
    state.net.load_state_dict(sd)
    convert.adam_from_optax(state.net, state.optimizer, payload["opt_state"])
    state.step = int(np.asarray(payload["step"]))
    state.rng = np.asarray(payload["rng"], np.uint32).reshape(-1)[:2]
    args = json.loads(payload.get("args_json", "") or "{}")
    best_train = float(np.asarray(payload.get("best_train", np.inf)))
    return (state, int(np.asarray(payload["epoch"])), args, float(np.asarray(payload["best_val"])),
            best_train)


def peek_checkpoint_scalar(path: str, key: str):
    """A top-level scalar of a checkpoint (None if absent): the sidecar's
    when there is one, else from the whole file."""
    meta = _read_meta(path)
    if meta is not None:
        return float(meta[key]) if key in meta else None
    payload = _payload(path)
    return float(np.asarray(payload[key])) if key in payload else None


def peek_checkpoint_args(path: str) -> dict:
    """The training arguments a checkpoint records ({} if none)."""
    meta = _read_meta(path)
    if meta is not None:
        return meta.get("args", {}) or {}
    return json.loads(_payload(path).get("args_json", "") or "{}")


def load_model_only(path: str):
    """The model variables of a checkpoint, for evaluation or --pretrain:
    ({"params", "batch_stats"} numpy trees, epoch, args)."""
    payload = _payload(path)
    variables = {"params": payload["params"], "batch_stats": payload.get("batch_stats") or {}}
    epoch = int(np.asarray(payload.get("epoch", -1)))
    return variables, epoch, json.loads(payload.get("args_json", "") or "{}")

