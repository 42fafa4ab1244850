"""Checkpoint -> PkpNet loading for the evaluation CLIs (`evaluate`,
`calibrate_int8`), and the int8 scales sidecar's place beside a checkpoint.

Port of `suo_slam_tpu/eval/loading.py`. A reference PyTorch checkpoint
(`.pth.tar`) converts layer for layer (`train/torch_convert.py`) into
`PkpNet(prior_mode="concat", transpose_heatmaps=True)`. The JAX package's own
checkpoints — and the port's training CLI's, the same format — are flax
msgpack files (the params, batch statistics and optimizer state) with a
`.meta.json` sidecar whose `args.norm` records the architecture
(`train/checkpoint.py`); they load through `load_model_only`, the net's
structure — stacks, width, prior mode, BatchNorm or GroupNorm — read from
the tree. The checkpoint's norm wins over the `norm` argument, announced, as
in the JAX package.
"""

from __future__ import annotations

import os

import torch

from ..models.convert import backbone_config, from_jax_variables
from ..models.pkpnet import PkpNet


def load_eval_network(chkpt_path, bf16=True, norm="batch", no_network_cov=False):
    """Load a PkpNet with its weights for inference, in bf16 (the default)
    or f32. Returns (net, model_epoch)."""
    if chkpt_path.endswith((".pth.tar", ".pth")):
        from ..train.torch_convert import load_torch_checkpoint

        variables, model_epoch, _ = load_torch_checkpoint(chkpt_path)
        # the reference net: concat prior mode (no post-stem projection)
        net = PkpNet(
            **backbone_config(variables), calc_cov=not no_network_cov,
            transpose_heatmaps=True, dtype=torch.bfloat16 if bf16 else torch.float32,
        )
        net.load_state_dict(from_jax_variables(variables))
        return net, model_epoch
    from ..train.checkpoint import load_model_only

    # the architecture recorded at train time wins over the flag
    variables, model_epoch, _ = load_model_only(chkpt_path)
    cfg = backbone_config(variables)
    if cfg["norm"] != norm:
        print(f"[load_eval_network] checkpoint was trained with norm={cfg['norm']!r}; "
              f"overriding norm={norm!r}")
    net = PkpNet(**cfg, calc_cov=not no_network_cov,
                 dtype=torch.bfloat16 if bf16 else torch.float32)
    net.load_state_dict(from_jax_variables(variables))
    return net, model_epoch


def default_scales_path(chkpt_path):
    """The int8 scales sidecar of a checkpoint: a file inside a checkpoint
    directory, a sibling of a checkpoint file."""
    if os.path.isdir(chkpt_path):
        return os.path.join(chkpt_path, "int8_scales.npz")
    return chkpt_path + ".int8_scales.npz"
