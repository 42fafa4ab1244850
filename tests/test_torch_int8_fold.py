"""K12's pool and junction modes (the int8 hourglass's max-pool and junction
folded into the quantize pass) against the JAX package's eager
`_Int8Engine`, bit for bit, on the CPU (the modes' plain versions), and
K12's host-side plan of them.

- pool: JAX's `maxpool` then `nrq` against the port's one
  `maxpool(act, norm)` call — the pooled codes and the normed codes equal,
  per-tensor and per-channel scales of the pooled activation, C of 16 and
  48, even and odd extents (VALID drops the last row and column);
- junction: JAX's `upsample_add` then `quant` (per channel) or
  `quant_pair` against the port's `quant(upsample_add(...))` /
  `quant_pair(...)` of the `_Sum` that reads the low branch at half
  resolution, at the four junction levels of a depth-4 hourglass on 16 x 16
  (up1 16, 8, 4, 2), per-tensor and per-channel scales of `low`, C of 16
  and 48;
- `plan_quant`: the mode, the output pixels, the extents it passes, when
  the vector path is taken (C % 16 == 0, c_out == C, every address 16-byte
  aligned) and the shapes and operands it refuses, with the plain version
  refusing the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.models import int8_forward as ji8
from suo_slam_tpu_torch.models import hourglass as thg
from suo_slam_tpu_torch.models import int8_forward as ti8
from suo_slam_tpu_torch.models import int8_kernels as ik

f32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a, f32))


def _norm(rng, C):
    m = thg.MaskedBatchNorm(C)
    with torch.no_grad():
        m.scale.copy_(_t(rng.uniform(-1.5, 1.5, C)))
        m.bias.copy_(_t(rng.normal(size=C)))
        m.mean.copy_(_t(rng.normal(size=C) * 0.3))
        m.var.copy_(_t(rng.uniform(0.5, 1.5, C)))
    a, b = ti8._bn_affine(m)
    return m, jnp.asarray(a.numpy()), jnp.asarray(b.numpy())


def _qt(q, s):
    return ji8.QT(jnp.asarray(q), jnp.asarray(np.asarray(s, f32))), ti8.QT(
        torch.from_numpy(q), _t(s))


def _same(j, t):
    jv, tv = np.asarray(j.astype(jnp.float32)), t.to(torch.float32).numpy()
    assert jv.shape == tv.shape and np.array_equal(jv, tv), np.abs(jv - tv).max()


def _scale(rng, C, per):
    return (rng.uniform(0.005, 0.05, C).astype(f32) if per == "pc" else f32(0.02))


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
@pytest.mark.parametrize("per", ["pt", "pc"])
@pytest.mark.parametrize("C", [16, 48])
def test_pool_mode_equals_jax_maxpool_then_nrq(C, per, hw):
    rng = np.random.default_rng(C + len(per) + hw[1])
    q = rng.integers(-127, 128, (2,) + hw + (C,)).astype(np.int8)
    qj, qt = _qt(q, _scale(rng, C, per))
    norm, a, b = _norm(rng, C)
    s_out = f32(3.0)  # the normed values' absmax, about
    ej, et = ji8._Int8Engine((jnp.asarray(s_out),)), ti8._Int8Engine((_t(s_out),))
    pj = ej.maxpool(qj)
    nj = ej.nrq(pj, a, b)
    pt, nt = et.maxpool(qt, norm)
    _same(pj.q, pt.q)
    _same(nj.q, nt.q)
    assert torch.equal(pt.s, qt.s) and float(nt.s) == float(np.asarray(nj.s))
    assert et.i == 1 and et.op == 1  # the nrq's point and vectors, in its place
    assert len(np.unique(nt.q.numpy())) > 8 and len(np.unique(pt.q.numpy())) > 8
    # the raw-only pool (a pool no Residual chain reads) is the max alone
    _same(pj.q, ti8._Int8Engine(()).maxpool(qt).q)


@pytest.mark.parametrize("op", ["quant", "quant_pair"])
@pytest.mark.parametrize("per", ["pt", "pc"])
@pytest.mark.parametrize("H", [16, 8, 4, 2])
@pytest.mark.parametrize("C", [16, 48])
def test_junction_mode_equals_jax_upsample_add_then_quant(C, H, per, op):
    rng = np.random.default_rng(C * H + len(per) + len(op))
    up = rng.integers(-127, 128, (2, H, H, C)).astype(np.int8)
    low = rng.integers(-127, 128, (2, H // 2, H // 2, C)).astype(np.int8)
    uj, ut = _qt(up, rng.uniform(0.005, 0.05, C).astype(f32))  # the trunk: per channel
    lj, lt = _qt(low, _scale(rng, C, per))
    v = np.asarray(ji8._Int8Engine(()).upsample_add(uj, lj).astype(jnp.float32))
    s = (np.abs(v).max(axis=(0, 1, 2)) * 0.8).astype(f32)  # clips some values
    if op == "quant":
        ej, et = ji8._Int8Engine((jnp.asarray(s),)), ti8._Int8Engine((_t(s),))
        outs = [(ej.quant(ej.upsample_add(uj, lj), pc=True).q,
                 et.quant(et.upsample_add(ut, lt), pc=True).q)]
    else:
        norm, a, b = _norm(rng, C)
        sn = f32(np.abs(v).max() * 0.5)
        ej = ji8._Int8Engine((jnp.asarray(s), jnp.asarray(sn)))
        et = ti8._Int8Engine((_t(s), _t(sn)))
        j = ej.quant_pair(ej.upsample_add(uj, lj), a, b, pc=True)
        t = et.quant_pair(et.upsample_add(ut, lt), norm, pc=True)
        outs = [(j[0].q, t[0].q), (j[1].q, t[1].q)]
    for j, t in outs:
        _same(j, t)
        assert len(np.unique(t.numpy())) > 8
    # the junction is a `_Sum`: no operation, no vectors until its quantize
    assert isinstance(et.upsample_add(ut, lt), ti8._Sum)


def _codes(shape):
    return torch.zeros(shape, dtype=torch.int8)


def test_plan_quant_modes_and_the_vector_path():
    x = _codes((2, 8, 6, 48))
    p = ik.plan_quant(x.shape, pool=True, ptrs=[x.data_ptr(), 0])
    assert (p.mode, p.P, p.C, p.c_out, p.H, p.W, p.vec) == (ik.QUANT_POOL, 2 * 4 * 3, 48, 48,
                                                           8, 6, True)
    p = ik.plan_quant((2, 7, 5, 16), pool=True)  # VALID: 3 x 2 windows
    assert (p.P, p.H, p.W, p.vec) == (2 * 3 * 2, 7, 5, True)
    p = ik.plan_quant((2, 8, 6, 48), up_shape=(2, 4, 3, 48), ptrs=[0, 16, 32])
    assert (p.mode, p.P, p.H, p.W, p.vec) == (ik.QUANT_UP, 2 * 8 * 6, 8, 6, True)
    p = ik.plan_quant((2, 8, 6, 48))
    assert (p.mode, p.P, p.H, p.W, p.vec) == (ik.QUANT_PLAIN, 96, 0, 0, True)
    # the vector path: C % 16, c_out == C and 16-byte addresses
    assert not ik.plan_quant((2, 8, 6, 40), pool=True).vec
    assert not ik.plan_quant((2, 8, 6, 41), 48).vec
    assert not ik.plan_quant((2, 8, 6, 48), up_shape=(2, 4, 3, 48), ptrs=[0, 8]).vec
    assert not ik.plan_quant((2, 8, 6, 48), pool=True, ptrs=[4]).vec


@pytest.mark.parametrize("case", ["pool 1 row", "pool 3-d", "pool and junction",
                                  "junction odd", "junction not half", "C"])
def test_plan_quant_refusals(case):
    kw = {"pool 1 row": dict(shape=(2, 1, 8, 16), pool=True),
          "pool 3-d": dict(shape=(8, 8, 16), pool=True),
          "pool and junction": dict(shape=(2, 8, 8, 16), pool=True, up_shape=(2, 4, 4, 16)),
          "junction odd": dict(shape=(2, 7, 8, 16), up_shape=(2, 3, 4, 16)),
          "junction not half": dict(shape=(2, 8, 8, 16), up_shape=(2, 8, 8, 16)),
          "C": dict(shape=(2, 8, 8, 2048))}[case]
    with pytest.raises(ValueError, match="K12"):
        ik.plan_quant(kw.pop("shape"), **kw)


def test_mode_operands_refused_by_the_plain_version():
    q = _codes((2, 8, 8, 16))
    s = torch.full((16,), 0.02)
    m = c = torch.ones(16)
    bad = [lambda: ik.int8_quant(q, s, pool=True),                       # a divisor
           lambda: ik.int8_quant(ik.Deq(q, s), None, m, c, pool=True),   # a prologue
           lambda: ik.int8_quant(q.float(), None, m, c, pool=True),      # not codes
           lambda: ik.int8_quant(q, None, m, c, pool=True, f32_ops=True),
           lambda: ik.int8_quant(ik.Deq(q, s), s, x2=ik.Deq(q, s, up=True)),  # not half
           lambda: ik.int8_quant(ik.Deq(q[:, :7], s), s,
                                 x2=ik.Deq(q[:, :3, :4].contiguous(), s, up=True))]
    for f in bad:
        with pytest.raises(ValueError, match="int8_quant"):
            f()
    raw, norm = ik.int8_quant(q, None, pool=True)  # the pool alone: its codes
    assert raw.shape == (2, 4, 4, 16) and norm is None
    raw, norm = ik.int8_quant(q, None, m, c, pool=True, c_out=32)  # padded rows
    assert raw.shape == norm.shape == (2, 4, 4, 32) and not raw[..., 16:].any()
    assert not norm[..., 16:].any()
