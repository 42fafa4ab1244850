"""int8-resident inference forward for PkpNet: activations live as s8 codes.

Port of `suo_slam_tpu/models/int8_forward.py`. Every tensor materialised
between fused steps is s8 with a calibrated scale: per-tensor at convolution
inputs (so that the scale factors out of the convolution) and per-channel on
the residual trunk. The engine's device steps are the hand-written kernels of
`models/int8_kernels.py`: K11 (convolution + folded dequant / BatchNorm /
ReLU / requantize epilogue), K12 (quant, nrq and the dual-output quant_pair
of every chained block boundary, behind a prologue that forms JAX's bf16
dequantize-and-add of the residual, projection, injection and junction
sums: the engine's `sum` hands it the operands instead of computing the
sum in torch). K12 also takes the s8 max-pool, fused with the nrq that
follows it (`maxpool(act, norm)`), and the junction, whose sum (a `_Sum`
with its second activation read at half resolution) its next quantize
forms; K13, their earlier kernel, is off this path. The
stem convolution stays f32 (`F.conv2d`, TF32 off), and so do the readout's
moments and the validity head (`ops/heatmap.py`, K2 on the bf16 logits).

The traversal walks the port's own module tree (`models/hourglass.py`:
`stem`, `stem_norm`, `pre`, `extra_proj`, `hgs[i].up1 / low1 / low2 / low3`,
`lls`, `ll_convs`, `ll_norms`, `heads`, `ll_merges`, `out_merges`) and
consumes calibration points in the JAX package's order, so a scales sidecar
written by either package serves the other (`save_scales` / `load_scales`,
the same `.npz` layout).

Calibration (`calibrate`) runs the same traversal with a recording engine in
f32 and returns the per-point absmax tuple. `make_int8_apply(net)` returns
the int8 program; `make_f32_reference_apply(net)` the full-precision
traversal (a test oracle with the int8 program's graph).

Every per-channel vector an operation needs (the divisor of a quantize, the
folded multiplier and offset of an epilogue, the bf16 scales of a junction)
depends on the scales and the weights alone. The int8 program computes each
on the host in f32, in JAX's order of operations, the first time it runs
with a scales tuple, uploads it once and reuses it until the scales change.

Inference only; norm="batch"; prior_mode "post_stem" or "concat".
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import int8_kernels as ik
from .hourglass import Hourglass, MaskedBatchNorm, Residual
from .pkpnet import PkpNet, PkpNetOutput

BN_EPS = 1e-5


class QT(NamedTuple):
    """s8 codes (NHWC) + their dequantization scale (x ~= q * s; s is an f32
    host tensor, [] or [C])."""

    q: torch.Tensor
    s: torch.Tensor


def _bn_affine(norm: MaskedBatchNorm, device=None):
    """(a, b) of a BatchNorm at inference, a = scale * rsqrt(var + eps),
    b = bias - mean * a, in f32 on `device` (default: the host)."""
    f = lambda t: t.detach().to(device or "cpu", torch.float32)
    a = f(norm.scale) * torch.rsqrt(f(norm.var) + BN_EPS)
    return a, f(norm.bias) - f(norm.mean) * a


class _Sum(NamedTuple):
    """The int8 engine's `sum`: JAX's bf16 dequantize-and-add, formed by the
    next quantize's prologue (K12) instead of being materialised. `up`: the
    second activation is read nearest-2x upsampled (the junction)."""

    acts: tuple
    add: torch.Tensor | None
    up: bool = False


class _CalAct(NamedTuple):
    """Calibration-engine activation: f32 NHWC tensor + per-channel tag (keeps
    the structural path, and so the point indices, equal to the int8
    engine's)."""

    x: torch.Tensor
    pc: bool


def _conv_f32(x: torch.Tensor, weight: torch.Tensor, bias, stride, pad) -> torch.Tensor:
    """NHWC f32 convolution (weights OIHW) with the bias added afterwards,
    as `jax.lax.conv_general_dilated(...) + bias`."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.detach().to(torch.float32), None, stride, pad)
    y = y.permute(0, 2, 3, 1)
    return y if bias is None else y + bias.detach().to(torch.float32)


def _conv_params(conv, cin_lo: int):
    """(weight OIHW f32, bias or None) of `conv`; cin_lo > 0 takes the input
    channels from cin_lo on with no bias (the concat stem's prior half)."""
    if cin_lo:
        return conv.weight[:, cin_lo:], None
    return conv.weight, conv.bias


class _CalibEngine:
    """Records per-point absmax; all math in f32 (the exact reference for
    int8)."""

    int8 = False

    def __init__(self):
        self.absmax = []

    def _record(self, xf, pc):
        if pc:
            self.absmax.append(torch.amax(torch.abs(xf), dim=tuple(range(xf.dim() - 1))))
        else:
            self.absmax.append(torch.amax(torch.abs(xf)))

    def quant(self, xf, pc=False, pad=False):
        self._record(xf, pc)
        return _CalAct(xf, pc)

    def quant_pair(self, xf, norm, pc=True):
        """The raw trunk tensor and the next block's normed conv input, two
        calibration points in the order of the quant + nrq they replace."""
        a, b = _bn_affine(norm, xf.device)
        raw = self.quant(xf, pc)
        normed = self.quant(torch.relu(xf * a + b))
        return raw, normed

    def sum(self, *terms):
        """The f32 sum, left to right, of activations and tensors."""
        out = None
        for t in terms:
            v = t.x if isinstance(t, _CalAct) else t
            out = v if out is None else out + v
        return out

    def is_per_channel(self, act):
        return act.pc

    def nrq(self, act, norm):
        a, b = _bn_affine(norm, act.x.device)
        y = torch.relu(act.x * a + b)
        self._record(y, False)
        return _CalAct(y, False)

    def conv_raw(self, act, conv, cin_lo=0):
        if act.pc:
            raise ValueError("conv inputs must be per-tensor quantized")
        w, bias = _conv_params(conv, cin_lo)
        return _conv_f32(act.x.to(torch.float32), w, bias, conv.stride, conv.padding)

    def conv_nrq(self, act, conv, norm):
        y = self.conv_raw(act, conv)
        a, b = _bn_affine(norm, y.device)
        y = torch.relu(y * a + b)
        self._record(y, False)
        return _CalAct(y, False)

    def maxpool(self, act, norm=None):
        """The 2x2 max-pool; with `norm`, (pooled, its nrq)."""
        p = _CalAct(F.max_pool2d(act.x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1), act.pc)
        return p if norm is None else (p, self.nrq(p, norm))

    def upsample_add(self, up1, low):
        lo = low.x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return up1.x + lo


def quantize_conv(conv, cin_lo: int = 0, device=None) -> ik.QConv:
    """Per-output-channel s8 weights of a convolution, as JAX's
    `_quantize_kernel`: s_w = max(max |w|, 1e-12) / 127, codes clip(round(w /
    s_w), -127, 127), in f32 with true division; arranged [Cout, KH, KW,
    Cin_p] for K11 on `device` (default: the weights')."""
    w, bias = _conv_params(conv, cin_lo)
    w = w.detach().to("cpu", torch.float32)
    s_w = torch.clamp(torch.amax(torch.abs(w), dim=(1, 2, 3)), min=1e-12) / 127.0
    wq = torch.clamp(torch.round(w / s_w[:, None, None, None]), -127, 127).to(torch.int8)
    cout, cin = wq.shape[:2]
    cin_p = -(-cin // ik.CIN_ALIGN) * ik.CIN_ALIGN
    wq = F.pad(wq.permute(0, 2, 3, 1), (0, cin_p - cin)).contiguous()
    b = (torch.zeros(cout) if bias is None else bias.detach().to("cpu", torch.float32))
    stride, pad = conv.stride[0], conv.padding[0]
    return ik.QConv(wq.to(device or conv.weight.device), s_w, b, stride, pad, cin)


class _Int8Engine:
    """Executes with s8-resident activations using calibrated scales.

    `scales`: the absmax tuple (host f32 tensors, [] or [C]); `qweights`: the
    `quantize_weights` dict (convolutions missing from it are quantized on
    first use); `plan`: a dict that keeps each operation's device vectors by
    its index in the program (pass the same dict for the same scales and
    program, a new one otherwise)."""

    int8 = True

    def __init__(self, scales, qweights=None, plan=None):
        self.scales = scales
        self.qw = {} if qweights is None else qweights
        self.plan = {} if plan is None else plan
        self.i = 0    # next calibration point
        self.op = 0   # next operation with device vectors

    def _next_point(self) -> int:
        if self.i >= len(self.scales):
            raise ValueError(
                f"int8 scale-sequence drift: traversal needs more than the "
                f"{len(self.scales)} calibration points in `scales` — the "
                "scales tuple does not match this network architecture")
        self.i += 1
        return self.i - 1

    def _s(self, point: int) -> torch.Tensor:
        """Dequantization scale of a calibration point (host f32):
        max(absmax, 1e-6) / 127."""
        key = ("s", point)
        s = self.plan.get(key)
        if s is None:
            s = self.plan[key] = torch.clamp(
                self.scales[point].to("cpu", torch.float32), min=1e-6) / 127.0
        return s

    def _vecs(self, dev, make):
        """This operation's per-channel vectors on `dev`: made on the host
        by `make()` the first time, then taken from the plan."""
        k = self.op
        self.op += 1
        v = self.plan.get(k)
        if v is None:
            v = self.plan[k] = tuple(t.contiguous().to(dev) for t in make())
        return v

    def _qconv(self, conv, cin_lo, dev) -> ik.QConv:
        qc = self.qw.get((conv, cin_lo))
        if qc is None:
            qc = self.qw[(conv, cin_lo)] = quantize_conv(conv, cin_lo, dev)
        return qc

    def skip_scale(self):
        """Consume the calibration point whose math is absent (the prior
        quant of the prior-free program)."""
        self._next_point()

    def sum(self, *terms):
        """JAX's `dequant(a) [+ dequant(b)] [+ t]`, left to right, left for
        the next quantize's prologue (K12) to form: one or two activations,
        then at most one bf16 tensor or [C] vector."""
        acts = tuple(t for t in terms if isinstance(t, QT))
        rest = terms[len(acts):]
        if not 1 <= len(acts) <= 2 or len(rest) > 1 or any(isinstance(t, QT) for t in rest):
            raise ValueError("int8 sum: one or two activations, then at most one addend")
        return _Sum(acts, rest[0] if rest else None)

    def _quant(self, xf, points, make_norm=None, c_out=None):
        """K12 on xf (a tensor or a `sum`): raw codes at points[0]; with
        make_norm(dt) -> (m, c) the normed codes at points[1] too."""
        dt = torch.bfloat16 if isinstance(xf, _Sum) else ik.op_dtype(xf)
        acts = xf.acts if isinstance(xf, _Sum) else ()
        C = (acts[0].q if acts else xf).shape[-1]
        dev = (acts[0].q if acts else xf).device

        def make():
            deq = tuple(a.s.to(torch.bfloat16).float().expand(C) for a in acts)
            norm = make_norm(dt) if make_norm else ()
            return (self._s(points[0]).to(dt).float().expand(C),) + tuple(norm) + deq

        v = self._vecs(dev, make)
        n_norm = 2 if make_norm else 0
        div, mc, deq = v[0], v[1:1 + n_norm], v[1 + n_norm:]
        if acts:
            x = ik.Deq(acts[0].q, deq[0])
            x2 = ik.Deq(acts[1].q, deq[1], xf.up) if len(acts) > 1 else None
            return ik.int8_quant(x, div, *mc, x2=x2, add=xf.add, c_out=c_out)
        return ik.int8_quant(xf, div, *mc, c_out=c_out)

    def quant(self, xf, pc=False, pad=False):
        """Codes of xf (a tensor or a `sum`); pad=True (a convolution's
        input: the prior, the heads' logits) stores them K11's CIN_ALIGN
        channels wide, 41 -> 48, zero beyond."""
        p = self._next_point()
        C = (xf.acts[0].q if isinstance(xf, _Sum) else xf).shape[-1]
        q, _ = self._quant(xf, (p,), c_out=ik.padded(C) if pad else C)
        return QT(q, self._s(p))

    def quant_pair(self, xf, norm, pc=True):
        """The raw trunk tensor AND the next block's normed conv input from
        one pass (JAX's multi-output fusion): the norm applies to the value
        before its quantization."""
        p, pn = self._next_point(), self._next_point()

        def make_norm(dt):
            a, b = _bn_affine(norm)
            s_n = self._s(pn)
            return (a / s_n).to(dt).float(), (b / s_n).to(dt).float()

        q, qn = self._quant(xf, (p, pn), make_norm)
        return QT(q, self._s(p)), QT(qn, self._s(pn))

    def is_per_channel(self, act: QT):
        return act.s.dim() > 0

    def _nrq_vecs(self, act: QT, norm):
        """(point, m, c) of an nrq of act: folded, relu(deq(q) * a + b) /
        s_out -> max(q * m + c, 0) in bf16."""
        po = self._next_point()

        def make():
            a, b = _bn_affine(norm)
            s_out = self._s(po)
            return (((act.s * a) / s_out).to(torch.bfloat16).float(),
                    (b / s_out).to(torch.bfloat16).float())

        return (po,) + self._vecs(act.q.device, make)

    def nrq(self, act: QT, norm):
        po, m, c = self._nrq_vecs(act, norm)
        _, q = ik.int8_quant(act.q, None, m, c)
        return QT(q, self._s(po))

    def conv_raw(self, act: QT, conv, cin_lo=0):
        if act.s.dim() != 0:
            raise ValueError("conv inputs must be per-tensor quantized")
        qc = self._qconv(conv, cin_lo, act.q.device)
        e1, e2 = self._vecs(act.q.device, lambda: (
            (act.s * qc.s_w).to(torch.bfloat16).float(), qc.bias.to(torch.bfloat16).float()))
        return ik.int8_conv(act.q, qc, e1, e2, out_s8=False)

    def conv_bias(self, conv, act: QT):
        """What `conv_raw` gives for all-zero codes: the bias in bf16, as
        an f32 [C] vector (a `sum` addend)."""
        (b,) = self._vecs(act.q.device, lambda: (
            conv.bias.detach().to("cpu", torch.float32).to(torch.bfloat16).float(),))
        return b

    def conv_nrq(self, act: QT, conv, norm):
        if act.s.dim() != 0:
            raise ValueError("conv inputs must be per-tensor quantized")
        qc = self._qconv(conv, 0, act.q.device)
        po = self._next_point()

        def make():
            # folded: relu((y * s_acc + bias) * a + b) / s_out = max(y * m + c, 0)
            a, b = _bn_affine(norm)
            s_out = self._s(po)
            s_acc = act.s * qc.s_w
            return (((s_acc * a) / s_out).to(torch.bfloat16).float(),
                    ((qc.bias * a + b) / s_out).to(torch.bfloat16).float())

        m, c = self._vecs(act.q.device, make)
        return QT(ik.int8_conv(act.q, qc, m, c, out_s8=True), self._s(po))

    def maxpool(self, act: QT, norm=None):
        """The 2x2 max-pool of the codes (the scale is positive, so the max
        commutes with dequantization), one K12 call in its pool mode; with
        `norm`, fused with the nrq that reads the pooled tensor: returns
        (pooled, normed), the nrq's calibration point and vectors taken in
        its place of the order."""
        if norm is None:
            q, _ = ik.int8_quant(act.q, None, pool=True)
            return QT(q, act.s)
        po, m, c = self._nrq_vecs(act, norm)  # the pooled tensor keeps act's scale
        q, qn = ik.int8_quant(act.q, None, m, c, pool=True)
        return QT(q, act.s), QT(qn, self._s(po))

    def upsample_add(self, up1: QT, low: QT):
        """The junction bf16(up1) + bf16(upsample2x(low)), left for the next
        quantize's prologue (K12's junction mode): `low` is read at half
        resolution, the bf16 sum never written."""
        return _Sum((up1, low), None, up=True)


def _residual(eng, m: Residual, act_x, out_pc=True, pre_norm=None, pair_norm=None):
    """A bottleneck Residual with s8-resident staging (`int8_forward.py:303`).

    out_pc=False when the output feeds a convolution directly (per-tensor
    scale); pre_norm: the block's normed input already emitted by its
    producer's quant_pair; pair_norm: the NEXT block's first norm — then the
    block returns (raw_out, normed_out) from one quant_pair."""
    act1 = eng.nrq(act_x, m.norm0) if pre_norm is None else pre_norm
    act2 = eng.conv_nrq(act1, m.conv0, m.norm1)
    act3 = eng.conv_nrq(act2, m.conv1, m.norm2)
    if m.skip is not None:
        # the projection skip reads the RAW block input; conv2 requantizes on
        # its own so that one convolution feeds the add (`:324-330`)
        y = eng.quant(eng.conv_raw(act3, m.conv2))
        skip = eng.conv_raw(_per_tensor(eng, act_x), m.skip)
        out = eng.sum(y, skip)
    else:
        out = eng.sum(act_x, eng.conv_raw(act3, m.conv2))
    if pair_norm is None:
        return eng.quant(out, pc=out_pc)
    return eng.quant_pair(out, pair_norm, pc=out_pc)


def _res_chain(eng, blocks, act, pre_norm=None, last_out_pc=True, tail_norm=None):
    """Consecutive Residual blocks, each boundary's first norm fused into the
    producer's quant_pair. tail_norm pairs the last output with a downstream
    norm too. Returns (act, pre_norm or None)."""
    blocks = list(blocks)
    for j, blk in enumerate(blocks):
        last = j == len(blocks) - 1
        nxt = tail_norm if last else blocks[j + 1].norm0
        res = _residual(eng, blk, act, out_pc=(last_out_pc if last else True),
                        pre_norm=pre_norm, pair_norm=nxt)
        if nxt is None:
            act, pre_norm = res, None
        else:
            act, pre_norm = res
    return act, pre_norm


def _pool(eng, act, blocks):
    """The max-pool of act and, where a Residual chain reads the pooled
    tensor, its first block's nrq in the same call (that block then takes it
    as its pre_norm): (pooled, normed or None)."""
    blocks = list(blocks)
    if not blocks:
        return eng.maxpool(act), None
    return eng.maxpool(act, blocks[0].norm0)


def _per_tensor(eng, act):
    """Requantize a per-channel trunk tensor for direct conv consumption."""
    if eng.is_per_channel(act):
        return eng.quant(eng.sum(act))
    return act


def _hourglass(eng, hg: Hourglass, act_x, pre_norm=None, ret_norm=None):
    """pre_norm: act_x's normed form, used by the up1 chain's first block (the
    max-pool branch reads the raw tensor). ret_norm: the return junction
    dual-emits the caller's next norm input too."""
    up1, _ = _res_chain(eng, hg.up1, act_x, pre_norm=pre_norm)
    if isinstance(hg.low2, Hourglass):
        # the pooled chain runs straight into the inner hourglass's first up1
        # block; the inner return junction dual-emits low3's first norm
        low, pn = _pool(eng, act_x, hg.low1)
        low, pn = _res_chain(eng, hg.low1, low, pre_norm=pn, tail_norm=hg.low2.up1[0].norm0)
        low, pn = _hourglass(eng, hg.low2, low, pre_norm=pn, ret_norm=hg.low3[0].norm0)
        low, _ = _res_chain(eng, hg.low3, low, pre_norm=pn)
    else:
        chain = list(hg.low1) + list(hg.low2) + list(hg.low3)
        low, pn = _pool(eng, act_x, chain)
        low, _ = _res_chain(eng, chain, low, pre_norm=pn)
    out = eng.upsample_add(up1, low)
    if ret_norm is None:
        return eng.quant(out, pc=True)
    return eng.quant_pair(out, ret_norm, pc=True)


def _traverse(eng, net: PkpNet, images_roi, prior_kp, no_prior=False):
    """Shared calibration / int8 traversal; mirrors `HourglassNet.forward`.

    no_prior=True (int8 engine only: calibration always runs with a prior)
    runs the program with the prior path statically absent while still
    consuming the prior's calibration point, so one scales tuple
    serves both programs; it equals the with-prior program on an all-zero
    prior, the post-stem projection's bias included. Returns the n_stack
    NHWC head logits."""
    bb = net.backbone
    n, h, w, _ = images_roi.shape
    concat = net.prior_mode == "concat"
    phw = (h, w) if concat else (h // 4, w // 4)
    if prior_kp is None and not no_prior:
        prior_kp = images_roi.new_zeros((n,) + phw + (net.num_kp,), dtype=torch.float32)

    # the stem convolution stays f32 for the image channels
    stem = bb.stem
    x = _conv_f32(images_roi.to(torch.float32), stem.weight[:, :3] if concat else stem.weight,
                  stem.bias, stem.stride, stem.padding)
    if concat:
        # conv(cat(img, prior), W) == conv(img, W[:, :3]) + conv(prior, W[:, 3:]),
        # with the prior half on the int8 path (`:434-452`)
        if no_prior:
            eng.skip_scale()
        else:
            prior_act = eng.quant(prior_kp.to(torch.float32).contiguous(), pad=True)
            x = x + eng.conv_raw(prior_act, stem, cin_lo=3).to(torch.float32)
    a0, b0 = _bn_affine(bb.stem_norm, x.device)
    x = torch.relu(x * a0 + b0).contiguous()
    act, pn = eng.quant_pair(x, bb.pre[0].norm0, pc=False)
    act = _residual(eng, bb.pre[0], act, pre_norm=pn)
    act, pn = eng.maxpool(act, bb.pre[1].norm0)
    act, pn = _residual(eng, bb.pre[1], act, pre_norm=pn, pair_norm=bb.pre[2].norm0)
    hg0 = bb.hgs[0].up1[0].norm0
    if concat:
        act, pn = _residual(eng, bb.pre[2], act, pre_norm=pn, pair_norm=hg0)
    else:
        act = _residual(eng, bb.pre[2], act, pre_norm=pn)
        if no_prior:
            # a zero prior's codes add the projection's bias alone (JAX's
            # prior-free program drops it: see ROADMAP C)
            eng.skip_scale()
            inj = eng.sum(act, eng.conv_bias(bb.extra_proj, act))
        else:
            prior_act = eng.quant(prior_kp.to(torch.float32).contiguous(), pad=True)
            inj = eng.sum(act, eng.conv_raw(prior_act, bb.extra_proj))
        act, pn = eng.quant_pair(inj, hg0, pc=True)

    outs = []
    for i in range(bb.n_stack):
        # the return junction dual-emits the ll chain's first norm
        hg, pn = _hourglass(eng, bb.hgs[i], act, pre_norm=pn, ret_norm=bb.lls[i][0].norm0)
        # the last block's output feeds a convolution: per-tensor
        ll, _ = _res_chain(eng, bb.lls[i], hg, pre_norm=pn, last_out_pc=False)
        ll_act = eng.conv_nrq(ll, bb.ll_convs[i], bb.ll_norms[i])
        raw = eng.conv_raw(ll_act, bb.heads[i])
        outs.append(raw)
        if i < bb.n_stack - 1:
            # 3-way junction: one convolution requantizes on its own
            ll_q = eng.quant(eng.conv_raw(ll_act, bb.ll_merges[i]))
            raw_act = eng.quant(raw, pad=True)
            tmp_ = eng.conv_raw(raw_act, bb.out_merges[i])
            act, pn = eng.quant_pair(eng.sum(act, ll_q, tmp_),
                                     bb.hgs[i + 1].up1[0].norm0, pc=True)
    return outs


def _readout(net: PkpNet, outs) -> PkpNetOutput:
    """The heatmap readout (K2, bf16 logits for the int8 engine) and the f32
    validity head (`PkpNet.readout`)."""
    return net.readout(outs[-1], tuple(outs[:-1]))


def _check_net(net: PkpNet) -> None:
    if net.prior_mode not in ("post_stem", "concat"):
        raise ValueError(f"int8 executor: unsupported prior_mode {net.prior_mode!r}")


def calibrate(net: PkpNet, batches, prior_batches=None):
    """Run calibration batches ([N, H, W, 3] crops on the net's device);
    returns the per-point absmax tuple (host f32 tensors).

    prior_batches=None calibrates with a WORST-CASE all-ones prior (the
    prior's range is [0, 1] by construction): a zero prior would record
    absmax 0 for the prior point and clip every real prior to noise."""
    _check_net(net)
    scales = None
    with torch.inference_mode():
        for i, x in enumerate(batches):
            if prior_batches is None:
                ph, pw = net.prior_hw(tuple(x.shape[1:3]))
                prior = torch.ones((x.shape[0], ph, pw, net.num_kp), dtype=torch.float32,
                                   device=x.device)
            else:
                prior = prior_batches[i]
            eng = _CalibEngine()
            _traverse(eng, net, x, prior)
            s = tuple(a.to("cpu", torch.float32) for a in eng.absmax)
            scales = s if scales is None else tuple(map(torch.maximum, scales, s))
    return scales


def save_scales(path, scales):
    """Persist a calibration-scale tuple as an .npz sidecar: entries under
    zero-padded indices (order is the contract) plus their count `n`."""
    arrays = {f"s{i:04d}": np.asarray(torch.as_tensor(s, dtype=torch.float32).cpu())
              for i, s in enumerate(scales)}
    arrays["n"] = np.asarray(len(scales), np.int64)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_scales(path):
    """A `save_scales` sidecar (of either package) back as the tuple the
    int8 program consumes. A wrong count raises at the program's run."""
    with np.load(path) as z:
        n = int(z["n"])
        return tuple(torch.from_numpy(np.asarray(z[f"s{i:04d}"], np.float32)) for i in range(n))


def quantize_weights(net: PkpNet, device=None) -> dict:
    """Pre-quantize every engine-consumed convolution once: {(conv, cin_lo):
    QConv} for `make_int8_apply`. The stem's image half stays f32; the concat
    stem's prior half (cin_lo=3) is quantized like any engine convolution."""
    _check_net(net)
    out = {}
    for m in net.backbone.modules():
        if isinstance(m, torch.nn.Conv2d) and m is not net.backbone.stem:
            out[(m, 0)] = quantize_conv(m, 0, device)
    if net.prior_mode == "concat":
        out[(net.backbone.stem, 3)] = quantize_conv(net.backbone.stem, 3, device)
    return out


def make_int8_apply(net: PkpNet, no_prior=False):
    """Returns apply(qweights, scales, images_roi, prior_kp=None) ->
    PkpNetOutput, the s8-resident forward (bf16 logits).

    `qweights` from `quantize_weights` (None quantizes on first use),
    `scales` from `calibrate` / `load_scales`. no_prior=True is the
    statically prior-free program, equal to the default one on an all-zero
    prior; both consume the same scales tuple. The program keeps the device
    vectors it folds from a scales tuple until it is called with another."""
    _check_net(net)
    cache = {"scales": None, "qweights": None, "plan": {}}

    def apply(qweights, scales, images_roi, prior_kp=None):
        if cache["scales"] is not scales or cache["qweights"] is not qweights:
            cache.update(scales=scales, qweights=qweights, plan={})
        eng = _Int8Engine(scales, qweights, cache["plan"])
        with torch.inference_mode():
            outs = _traverse(eng, net, images_roi, prior_kp, no_prior=no_prior)
            # every calibration point consumed once, in order
            if eng.i != len(scales):
                raise ValueError(
                    f"int8 scale-sequence drift: traversal consumed {eng.i} "
                    f"calibration points but `scales` has {len(scales)} — the "
                    "scales tuple does not match this network architecture")
            return _readout(net, outs)

    return apply


def make_f32_reference_apply(net: PkpNet):
    """The calibration traversal as a plain f32 forward (test oracle with
    the int8 program's graph)."""
    _check_net(net)

    def apply(images_roi, prior_kp=None):
        with torch.inference_mode():
            eng = _CalibEngine()
            return _readout(net, _traverse(eng, net, images_roi, prior_kp))

    return apply
