"""Checkpoint -> PkpNet loading for the evaluation CLIs (`evaluate`,
`calibrate_int8`), and the int8 scales sidecar's place beside a checkpoint.

Port of `suo_slam_tpu/eval/loading.py`. A reference PyTorch checkpoint
(`.pth.tar`) converts layer for layer (`train/torch_convert.py`) into
`PkpNet(prior_mode="concat", transpose_heatmaps=True)`. The JAX package's own
checkpoints are flax msgpack files (`flax.serialization.to_bytes` of the
params, batch statistics and optimizer state) with a `.meta.json` sidecar
whose `args.norm` picks the architecture (`suo_slam_tpu/train/checkpoint.py`
`save_checkpoint`); numpy can read them, and the port's reader comes with
ROADMAP A18. Until then they raise.
"""

from __future__ import annotations

import os

import torch

from ..models.pkpnet import PkpNet


def load_eval_network(chkpt_path, bf16=True, norm="batch", no_network_cov=False):
    """Load a PkpNet with its weights for inference, in bf16 (the default)
    or f32. Returns (net, model_epoch)."""
    if chkpt_path.endswith((".pth.tar", ".pth")):
        from ..models.convert import backbone_config, from_jax_variables
        from ..train.torch_convert import load_torch_checkpoint

        variables, model_epoch, _ = load_torch_checkpoint(chkpt_path)
        # the reference net: concat prior mode (no post-stem projection)
        net = PkpNet(
            **backbone_config(variables), calc_cov=not no_network_cov, norm="batch",
            transpose_heatmaps=True, dtype=torch.bfloat16 if bf16 else torch.float32,
        )
        net.load_state_dict(from_jax_variables(variables))
        return net, model_epoch
    raise NotImplementedError(
        f"{chkpt_path!r}: the JAX package's checkpoints (flax msgpack files with a "
        ".meta.json sidecar) load with their reader, ROADMAP A18 (a reference "
        ".pth.tar loads now)")


def default_scales_path(chkpt_path):
    """The int8 scales sidecar of a checkpoint: a file inside a checkpoint
    directory, a sibling of a checkpoint file."""
    if os.path.isdir(chkpt_path):
        return os.path.join(chkpt_path, "int8_scales.npz")
    return chkpt_path + ".int8_scales.npz"
