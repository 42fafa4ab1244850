"""The training step: ROI crop (K1), prior render (K5), PkpNet in train mode,
the loss, backward and Adam, on one device.

Port of `suo_slam_tpu/train/harness.py:29-155` (the mesh functions, data
parallelism over several cards, are ROADMAP A15). JAX's state is immutable
and its step pure; here the net's parameters and running statistics and the
optimizer's moments are updated in place, and `TrainState` holds the net,
the optimizer, the step count and the dropout key. The step keeps its
metrics on the device (no host sync), so a loop can sum them without
waiting.

Dropout draws from a `torch.Generator` on the net's device, seeded for each
step from the state's key (two uint32 words, kept in the checkpoint as JAX
keeps its PRNG key) and the step count: a resumed run draws what the
uninterrupted run would have. It cannot replay flax's key chain; the tests
inject JAX's mask through `dropout_mask`.

Adam is `torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`, the update
rule of `optax.adam(lr)` (tested on equal gradients).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..models import convert
from ..models.pkpnet import PkpNet
from ..ops import heatmap as hm
from ..ops import roi as roi_ops
from . import losses


class Batch(NamedTuple):
    """Dense padded training batch on the device (`collate` makes it on the
    host). B images per step, O object slots per image, K = 41."""

    images: torch.Tensor      # [B, H, W, 3] f32 full frames in [0, 1]
    boxes: torch.Tensor       # [B, O, 4] pixel xyxy
    obj_mask: torch.Tensor    # [B, O] bool slot validity
    prior_uv: torch.Tensor    # [B, O, K, 2] NDC prior keypoints (for rendering)
    prior_mask: torch.Tensor  # [B, O, K] bool
    uv_gt: torch.Tensor       # [B, O, K, 2] NDC targets
    kp_mask: torch.Tensor     # [B, O, K] bool labeled-channel mask


def to_batch(np_batch: dict, device, o_pad: int | None = None) -> Batch:
    """A `collate` dict -> `Batch` on `device`, the object axis padded (or
    cut) to `o_pad` slots (the JAX CLI's `to_device_batch`)."""

    def pad_obj(a):
        if o_pad is None or a.shape[1] == o_pad:
            return a
        out = np.zeros((a.shape[0], o_pad) + a.shape[2:], a.dtype)
        out[:, : a.shape[1]] = a[:, :o_pad]
        return out

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)
    return Batch(
        images=t(np_batch["images"]),
        boxes=t(pad_obj(np_batch["boxes"])),
        obj_mask=t(pad_obj(np_batch["obj_mask"])),
        prior_uv=t(pad_obj(np_batch["prior_uv"])),
        prior_mask=t(pad_obj(np_batch["prior_mask"])),
        uv_gt=t(pad_obj(np_batch["uv_gt"])),
        kp_mask=t(pad_obj(np_batch["kp_mask"])),
    )


@dataclass
class TrainState:
    net: PkpNet
    optimizer: torch.optim.Optimizer
    step: int = 0
    rng: np.ndarray = field(default_factory=lambda: np.zeros(2, np.uint32))  # dropout key


def make_optimizer(params, lr: float = 1e-3) -> torch.optim.Adam:
    """Adam(lr=1e-3), the reference default, with optax's constants."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def init_like_flax(net: PkpNet, seed: int = 0) -> PkpNet:
    """flax's initial values: convolution and dense kernels LeCun normal
    (variance 1 / fan_in, truncated at 2 sigma), biases 0, norms scale 1,
    bias 0, mean 0, var 1."""
    g = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)
            m.weight.copy_(w)
            m.bias.zero_()
    for name, b in net.named_buffers():
        b.fill_(1.0 if name.endswith(".var") else 0.0)
    for name, p in net.named_parameters():
        if name.endswith(".scale"):
            p.fill_(1.0)
    return net


def init_state(net: PkpNet, seed: int = 0, lr: float = 1e-3) -> TrainState:
    """The net (on its device, channels_last, flax's initial values), Adam,
    step 0 and the dropout key of `seed`."""
    init_like_flax(net, seed)
    net.to(memory_format=torch.channels_last)
    rng = np.asarray([0, seed], np.uint32)
    return TrainState(net=net, optimizer=make_optimizer(net.parameters(), lr), step=0, rng=rng)


def model_variables(net: PkpNet) -> dict:
    """The net's weights as the JAX package's flax variables tree."""
    return convert.to_jax_variables(net)


def dropout_generator(state: TrainState, device) -> torch.Generator:
    """This step's dropout generator: seeded from the key and the step."""
    k0, k1 = (int(v) for v in np.asarray(state.rng, np.uint32))
    seed = ((k0 << 32) | k1) ^ (state.step * 0x9E3779B97F4A7C15)
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def forward_loss(net: PkpNet, batch: Batch, epoch, train: bool,
                 input_hw: tuple[int, int] = (256, 256), do_anneal: bool = True,
                 generator: torch.Generator | None = None,
                 dropout_mask: torch.Tensor | None = None):
    """(loss, aux) of one batch: crops, rendered priors, the net (train mode:
    batch statistics over the real object slots, dropout), the annealed
    objective (without the covariance head: L2 + the readout's spread, so
    K2 and K19 carry it and no probability map is formed)."""
    b, o = batch.boxes.shape[:2]
    crops = roi_ops.roi_crop_batch(batch.images, batch.boxes, batch.obj_mask, input_hw)
    crops = crops.reshape((b * o,) + crops.shape[2:])
    phw = net.prior_hw(input_hw)
    prior = hm.render_prior_heatmaps(batch.prior_uv.reshape(b * o, -1, 2),
                                     batch.prior_mask.reshape(b * o, -1), hw=phw,
                                     sigma_px=hm.prior_sigma_for(phw), dtype=net.prior_dtype)
    row_mask = batch.obj_mask.reshape(b * o)
    out = net(crops, prior, train=train, row_mask=row_mask, generator=generator,
              dropout_mask=dropout_mask)
    uv_gt = batch.uv_gt.reshape(b * o, -1, 2)
    # labeled channels of real (non-padded) object slots only
    kp_mask = (batch.kp_mask & batch.obj_mask[..., None]).reshape(b * o, -1)
    return losses.total_loss(out.uv, out.cov, out.spread, out.kp_mask_logits, uv_gt, kp_mask,
                             epoch, do_anneal=do_anneal)


def make_train_step(input_hw: tuple[int, int] = (256, 256), do_anneal: bool = True):
    """Returns a (state, batch, epoch, dropout_mask=None) -> (state, metrics)
    step. The gradients stay in the parameters' `.grad` until the next step;
    metrics are 0-d device tensors. `do_anneal=False` pins the var / mask
    loss weights to 1 (as from `--pretrain`)."""

    def step(state: TrainState, batch: Batch, epoch, dropout_mask=None):
        net, opt = state.net, state.optimizer
        gen = None if dropout_mask is not None else dropout_generator(state, batch.images.device)
        opt.zero_grad(set_to_none=True)
        loss, aux = forward_loss(net, batch, epoch, True, input_hw, do_anneal, gen, dropout_mask)
        loss.backward()
        opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["loss"] = loss.detach()
        return state, metrics

    return step


def make_eval_step(input_hw: tuple[int, int] = (256, 256), do_anneal: bool = True):
    """(net, batch, epoch) -> metrics with the running statistics, no dropout,
    no gradient."""

    @torch.no_grad()
    def step(net: PkpNet, batch: Batch, epoch):
        loss, aux = forward_loss(net, batch, epoch, False, input_hw, do_anneal)
        return dict(aux, loss=loss)

    return step
