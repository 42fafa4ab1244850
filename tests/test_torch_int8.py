"""The port's int8 serving path (`suo_slam_tpu_torch/models/int8_forward.py`,
the plain versions of K11-K13, `make_frame_inference(int8=True)`, the
engine's `int8_inference`, `--int8` and `calibrate_int8`) against the JAX
package's `models/int8_forward.py` on the CPU.

- Each engine operation (quant, quant_pair, nrq, conv_nrq, conv_raw,
  maxpool, upsample_add) takes the same s8 codes, scales and BatchNorm
  affines in both packages; the codes and the bf16 bits must be equal (JAX
  eager, whose per-operation bf16 rounding the port reproduces).
- `quantize_weights`: equal codes and scales for `from_jax_variables`
  weights.
- Calibration: the full-width point structure (255 points, JAX by
  `eval_shape`, the port on the meta device); at the small size the same
  count and ranks, values within 1e-5 of each point's largest entry (two
  f32 traversals summing in another order; a small channel's absmax can sit
  a few 1e-5 of itself apart).
- The whole int8 forward against JAX's `make_int8_apply` (eager) on the same
  weights, scales and crops, both prior modes, with and without a prior.
  The stem convolution is f32 in both and may differ in its last bit, which
  can flip a code by 1 downstream; the port's logits are held to a tenth of
  JAX's own int8-vs-f32 error (relative RMS) and its uv to a tenth of JAX's
  int8-vs-f32 uv error. Measured here: equal logits.
- The engine in single-view mode with `int8_inference` (online calibration
  over its first two frames) against the JAX engine, and the CLI in a
  subprocess with a sidecar written by `python -m
  suo_slam_tpu_torch.calibrate_int8`.

Sizes: JAX's `TINY` of tests/test_int8_forward.py (2 stacks, 1 module, 32
features, 64 x 64 crops); one JAX net per prior mode, shared by module
fixtures.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.models import PkpNet as JaxPkpNet
from suo_slam_tpu.models import int8_forward as ji8
from suo_slam_tpu.slam import ObjectSlam as JaxSlam
from suo_slam_tpu.slam import SlamConfig as JaxConfig
from suo_slam_tpu_torch import evaluate as port_evaluate
from suo_slam_tpu_torch.models import hourglass as thg
from suo_slam_tpu_torch.models import int8_forward as ti8
from suo_slam_tpu_torch.models import int8_kernels as ik
from suo_slam_tpu_torch.models.convert import backbone_config, from_jax_variables
from suo_slam_tpu_torch.models.pkpnet import PkpNet
from suo_slam_tpu_torch.slam import kernels as tk
from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig
from tests.helpers.synthetic_bop import write_synthetic_bop
from tests.helpers.synthetic_scene import StubMeshDb, make_scene
from tests.test_torch_pkpnet import _variables
from tests.test_torch_slice import _compare, _run, jax_key_chain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_stack=2, n_modules=1, features=32)
f32 = np.float32


class _NumpyInit:
    """`net.init` from shapes alone (`eval_shape`: no init program to
    compile), flax's defaults drawn by numpy: LeCun-normal kernels, zero
    biases, unit scales and variances (`_variables` then draws the
    BatchNorm statistics and affine)."""

    def __init__(self, net, seed):
        self.net, self.rng = net, np.random.default_rng(seed)

    def init(self, key, x):
        def value(path, s):
            if path[-1].key == "kernel":
                return (self.rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(f32)
            return (np.ones if path[-1].key in ("scale", "var") else np.zeros)(s.shape, f32)

        return jax.tree_util.tree_map_with_path(value, jax.eval_shape(self.net.init, key, x))


def _pair(prior_mode):
    jnet = JaxPkpNet(**TINY, prior_mode=prior_mode)
    v = _variables(_NumpyInit(jnet, 1), (64, 64), seed=1)
    tnet = PkpNet(**backbone_config(v))
    tnet.load_state_dict(from_jax_variables(v), strict=True)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(f32)
    prior = (rng.uniform(0, 1, (2,) + jnet.prior_hw((64, 64)) + (41,)) * 0.5).astype(f32)
    scales = ji8.calibrate(jnet, v, [jnp.asarray(x)], [jnp.asarray(prior)])
    return jnet, v, tnet.eval(), x, prior, scales


@pytest.fixture(scope="module")
def post_stem():
    return _pair("post_stem")


@pytest.fixture(scope="module")
def concat():
    return _pair("concat")


def _t(a):
    return torch.from_numpy(np.array(a, f32))  # a copy, 0-d stays 0-d


def _tscales(scales):
    return tuple(_t(s) for s in scales)


# the engine's operations, one by one ---------------------------------------------
def _norm(rng, C):
    m = thg.MaskedBatchNorm(C)
    with torch.no_grad():
        m.scale.copy_(_t(rng.uniform(-1.5, 1.5, C)))  # negative scales too
        m.bias.copy_(_t(rng.normal(size=C)))
        m.mean.copy_(_t(rng.normal(size=C) * 0.3))
        m.var.copy_(_t(rng.uniform(0.5, 1.5, C)))
    a, b = ti8._bn_affine(m)
    return m, jnp.asarray(a.numpy()), jnp.asarray(b.numpy())


def _conv(rng, cin, cout, k, stride=1):
    c = torch.nn.Conv2d(cin, cout, k, stride, k // 2)
    with torch.no_grad():
        c.weight.copy_(_t(rng.normal(size=(cout, cin, k, k)) * 0.1))
        c.bias.copy_(_t(rng.normal(size=cout) * 0.3))
    p = {"kernel": jnp.asarray(c.weight.detach().numpy().transpose(2, 3, 1, 0)),
         "bias": jnp.asarray(c.bias.detach().numpy())}
    return c, p


def _codes(rng, shape, lo=-127):
    return rng.integers(lo, 128, shape).astype(np.int8)


def _same(j, t):
    """Equal s8 codes, or equal bf16 bits (bf16 -> f32 is exact)."""
    jv, tv = np.asarray(j.astype(jnp.float32)), t.to(torch.float32).numpy()
    assert jv.shape == tv.shape and np.array_equal(jv, tv), np.abs(jv - tv).max()


def _qt(q, s):
    return ji8.QT(jnp.asarray(q), jnp.asarray(np.asarray(s, f32))), ti8.QT(
        torch.from_numpy(q), _t(s))


def _op_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    C = 32
    x = (rng.normal(size=(2, 6, 6, C)) * 3).astype(f32)
    pt = f32(np.abs(x).max() * 0.8)                       # clips some values
    pc = (np.abs(x).max(axis=(0, 1, 2)) * 0.9).astype(f32)
    if name.startswith("quant_"):
        dt, per = name.split("_")[1:]
        s = pc if per == "pc" else pt
        xj = jnp.asarray(x).astype(jnp.bfloat16 if dt == "bf16" else jnp.float32)
        xt = _t(x).to(torch.bfloat16 if dt == "bf16" else torch.float32)
        j = ji8._Int8Engine((jnp.asarray(s),)).quant(xj, pc=per == "pc")
        t = ti8._Int8Engine((_t(s),)).quant(xt, pc=per == "pc")
        return [(j.q, t.q)]
    if name.startswith("quant_pair_"):
        dt = name.split("_")[2]
        norm, a, b = _norm(rng, C)
        s = (pc, f32(pt * 1.7)) if dt == "bf16" else (pt, f32(pt * 1.7))
        xj = jnp.asarray(x).astype(jnp.bfloat16 if dt == "bf16" else jnp.float32)
        xt = _t(x).to(torch.bfloat16 if dt == "bf16" else torch.float32)
        j = ji8._Int8Engine(tuple(map(jnp.asarray, s))).quant_pair(xj, a, b, pc=dt == "bf16")
        t = ti8._Int8Engine(_tscales(s)).quant_pair(xt, norm, pc=dt == "bf16")
        return [(j[0].q, t[0].q), (j[1].q, t[1].q)]
    if name.startswith("nrq_"):
        norm, a, b = _norm(rng, C)
        qj, qt = _qt(_codes(rng, x.shape), pc * 0.01 if name == "nrq_pc" else pt * 0.01)
        s_out = (f32(1.3),)
        j = ji8._Int8Engine(tuple(map(jnp.asarray, s_out))).nrq(qj, a, b)
        t = ti8._Int8Engine(_tscales(s_out)).nrq(qt, norm)
        return [(j.q, t.q)]
    if name.startswith("conv_"):
        kind, k = name.split("_")[1:]
        k = int(k)
        if k == 7:  # the concat stem's prior half: 41 channels, stride 2
            conv, p = _conv(rng, 44, 16, 7, 2)
            p = {"kernel": p["kernel"][:, :, 3:, :], "bias": jnp.zeros((), jnp.float32)}
            qj, qt = _qt(_codes(rng, (2, 16, 16, 41), lo=0), f32(1.0 / 127))
            j = ji8._Int8Engine(()).conv_raw(qj, p, (2, 2), [(3, 3), (3, 3)])
            t = ti8._Int8Engine(()).conv_raw(qt, conv, cin_lo=3)
            return [(j, t)]
        conv, p = _conv(rng, C, 24, k)
        pad = [(1, 1), (1, 1)] if k == 3 else "SAME"
        qj, qt = _qt(_codes(rng, x.shape, lo=0), f32(0.02))
        if kind == "raw":
            return [(ji8._Int8Engine(()).conv_raw(qj, p, padding=pad),
                     ti8._Int8Engine(()).conv_raw(qt, conv))]
        norm, a, b = _norm(rng, 24)
        s_out = (f32(5.0),)
        j = ji8._Int8Engine(tuple(map(jnp.asarray, s_out))).conv_nrq(qj, p, a, b, padding=pad)
        t = ti8._Int8Engine(_tscales(s_out)).conv_nrq(qt, conv, norm)
        return [(j.q, t.q)]
    if name == "maxpool":
        qj, qt = _qt(_codes(rng, (2, 8, 8, C), lo=-128), pc)
        return [(ji8._Int8Engine(()).maxpool(qj).q, ti8._Int8Engine(()).maxpool(qt).q)]
    if name.startswith("upsample_add"):
        s_low = pt * 0.01 if name.endswith("pt") else pc * 0.02
        uj, ut = _qt(_codes(rng, (2, 8, 8, C)), pc * 0.01)
        lj, lt = _qt(_codes(rng, (2, 4, 4, C)), s_low)
        return [(ji8._Int8Engine(()).upsample_add(uj, lj),
                 ti8._Int8Engine(()).upsample_add(ut, lt))]
    raise AssertionError(name)


@pytest.mark.parametrize("name", [
    "quant_f32_pt", "quant_f32_pc", "quant_bf16_pt", "quant_bf16_pc",
    "quant_pair_f32", "quant_pair_bf16", "nrq_pt", "nrq_pc",
    "conv_nrq_1", "conv_nrq_3", "conv_raw_1", "conv_raw_3", "conv_raw_7",
    "maxpool", "upsample_add_pc", "upsample_add_pt",
])
def test_engine_operation_matches_jax(name):
    outs = _op_case(name)
    for j, t in outs:
        _same(j, t)
    # the operation does real work: not all codes saturated or zero
    assert any(len(np.unique(t.to(torch.float32).numpy())) > 8 for _, t in outs)


def test_s32_to_bf16_rounds_once():
    """Integers past 2^24 (the 7x7 prior convolution's sums reach 3.2e7):
    one round to nearest even, not f32 then bf16."""
    ints = [2 ** 24 + 2 ** 16 + 1, 2 ** 24 + 2 ** 16 - 1, -(2 ** 24 + 3 * 2 ** 16 + 1),
            2 ** 24 + 2 ** 16, 2 ** 24 + 3 * 2 ** 16, 255, 257, 259, -259, 0]

    def rne(x):  # the nearest bf16 (8 significant bits), ties to even
        e = max(abs(x).bit_length() - 8, 0)
        q, r = divmod(abs(x), 1 << e)
        up = e > 0 and (r > 1 << (e - 1) or (r == 1 << (e - 1) and q % 2 == 1))
        return (-1 if x < 0 else 1) * (q + up) * (1 << e)

    got = ik.s32_to_bf16(torch.tensor(ints, dtype=torch.int64)).to(torch.float64).tolist()
    assert got == [float(rne(x)) for x in ints]
    # f32 first would round the first two to the tie 2^24 + 2^16, then to even
    assert got[0] != got[1]


def test_quantize_weights_matches_jax(post_stem, concat):
    for jnet, v, tnet, *_ in (post_stem, concat):
        qw = ti8.quantize_weights(tnet)
        sd = from_jax_variables(ji8.quantize_weights(jnet, v))  # codes as f32
        names = {m: n for n, m in tnet.named_modules()}
        n_checked = 0
        for (conv, lo), qc in qw.items():
            name = names[conv]
            codes = qc.wq[..., : qc.cin].permute(0, 3, 1, 2).to(torch.float32)
            w = conv.weight.detach()[:, lo:].numpy()
            wq_j, s_j = ji8._quantize_kernel(jnp.asarray(w.transpose(2, 3, 1, 0)))
            assert torch.equal(codes, _t(np.asarray(wq_j).transpose(3, 2, 0, 1))), name
            assert np.array_equal(qc.s_w.numpy(), np.asarray(s_j)), name
            if lo == 0:  # the tree walk maps JAX's codes onto this module
                assert torch.equal(codes, sd[f"{name}.weight"]), name
            n_checked += 1
        assert n_checked == sum(isinstance(m, torch.nn.Conv2d) for m in tnet.modules()) - (
            jnet.prior_mode == "post_stem")


def test_calibration_structure_matches_jax(post_stem):
    """255 points at full width (2 stacks x 2 modules x 256 features),
    scalars at convolution inputs and [C] on the trunk, in JAX's order; at
    the small size the values agree within 1e-5 of each point's largest."""
    jnet = JaxPkpNet(n_stack=2, n_modules=2, features=256)
    x = jax.ShapeDtypeStruct((1, 256, 256, 3), jnp.float32)
    pr = jax.ShapeDtypeStruct((1, 64, 64, 41), jnp.float32)
    vs = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x)

    def calib(v, x, p):
        eng = ji8._CalibEngine()
        ji8._traverse(eng, v, x, p, jnet)
        return tuple(eng.absmax)

    want = [s.shape for s in jax.eval_shape(calib, vs, x, pr)]
    with torch.device("meta"):
        tnet = PkpNet(n_stack=2, n_modules=2, features=256)
        eng = ti8._CalibEngine()
        ti8._traverse(eng, tnet, torch.zeros((1, 256, 256, 3)), torch.zeros((1, 64, 64, 41)))
    got = [tuple(a.shape) for a in eng.absmax]
    assert len(want) == 255 and got == want
    jnet, v, tnet, x, prior, scales = post_stem
    mine = ti8.calibrate(tnet, [_t(x)], [_t(prior)])
    assert [s.dim() for s in mine] == [s.ndim for s in scales]
    for a, b in zip(scales, mine):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-5 * np.abs(a).max())


def test_launches_per_forward_of_the_full_architecture(monkeypatch):
    """K11 / K12 / K13 calls per forward at the full architecture (2 stacks
    x 2 modules, depth 4; the width does not change the counts): 186 / 85 /
    17 with a prior, 185 / 84 / 17 without. JAX's traversal makes 120
    conv_nrq + 66 conv_raw, 26 quant + 50 quant_pair + 9 nrq (its quant_pair
    calls quant for the raw output: 76 quant calls in all), 9 maxpool + 8
    upsample_add."""
    calls = {}
    for fn in ("int8_conv", "int8_quant", "int8_maxpool", "int8_upsample_add"):
        orig = getattr(ik, fn)

        def spy(*a, _orig=orig, _fn=fn, **kw):
            calls[_fn] = calls.get(_fn, 0) + 1
            return _orig(*a, **kw)

        monkeypatch.setattr(ik, fn, spy)
    torch.manual_seed(0)
    net = PkpNet(n_stack=2, n_modules=2, features=8).eval()
    x = torch.rand(1, 64, 64, 3)
    scales = ti8.calibrate(net, [x])
    assert len(scales) == 255
    qw = ti8.quantize_weights(net)
    for no_prior, want in ((False, (186, 85)), (True, (185, 84))):
        calls.clear()
        out = ti8.make_int8_apply(net, no_prior=no_prior)(qw, scales, x)
        assert (calls["int8_conv"], calls["int8_quant"]) == want
        assert calls["int8_maxpool"] + calls["int8_upsample_add"] == 17
        assert out.prob_logits.dtype == torch.bfloat16 and torch.isfinite(out.uv).all()


def test_sidecars_interoperate(post_stem, tmp_path):
    jnet, v, tnet, x, prior, scales = post_stem
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    ji8.save_scales(pj, scales)
    mine = ti8.calibrate(tnet, [_t(x)], [_t(prior)])
    ti8.save_scales(pt, mine)
    for a, b in zip(scales, ti8.load_scales(pj)):
        assert np.array_equal(np.asarray(a), b.numpy()) and b.dtype == torch.float32
    back = ji8.load_scales(pt)
    assert len(back) == len(mine)
    for a, b in zip(mine, back):
        assert np.array_equal(a.numpy(), np.asarray(b)) and np.asarray(b).shape == a.shape
    apply = ti8.make_int8_apply(tnet)
    ref = apply(None, ti8.load_scales(pj), _t(x), _t(prior))
    again = apply(ti8.quantize_weights(tnet), ti8.load_scales(pj), _t(x), _t(prior))
    assert torch.equal(ref.prob_logits, again.prob_logits)
    with pytest.raises(ValueError, match="needs more than"):
        apply(None, ti8.load_scales(pj)[:-2], _t(x), _t(prior))
    with pytest.raises(ValueError, match="consumed"):
        apply(None, ti8.load_scales(pj) + (torch.ones(()),), _t(x), _t(prior))


@pytest.mark.parametrize("mode", ["post_stem", "concat"])
def test_f32_reference_apply_matches_the_port_net(mode, post_stem, concat):
    """The f32 traversal adds each convolution's bias after its sum (as JAX)
    and normalises in one place; the net adds the bias inside the
    convolution: 2e-4 on uv, as tests/test_torch_pkpnet.py, and 5e-4 on the
    logits."""
    jnet, v, tnet, x, prior, _ = post_stem if mode == "post_stem" else concat
    ref = ti8.make_f32_reference_apply(tnet)(_t(x), _t(prior))
    with torch.inference_mode():
        out = tnet(_t(x), _t(prior))
    assert (ref.uv - out.uv).abs().max().item() <= 2e-4
    assert (ref.prob_logits - out.prob_logits).abs().max().item() <= 5e-4
    assert (ref.kp_mask - out.kp_mask).abs().max().item() <= 2e-4


@pytest.mark.parametrize("mode,with_prior", [("post_stem", True), ("post_stem", False),
                                             ("concat", True), ("concat", False)])
def test_int8_forward_matches_jax(mode, with_prior, post_stem, concat):
    jnet, v, tnet, x, prior, scales = post_stem if mode == "post_stem" else concat
    # the port's prior-free program against JAX's program on a zero prior
    # (what JAX's prior-free program promises; see the next test)
    pj = jnp.asarray(prior if with_prior else 0 * prior)
    oj = ji8.make_int8_apply(jnet)(v, scales, jnp.asarray(x), pj)
    ref = jnet.apply(v, jnp.asarray(x), pj)
    ot = ti8.make_int8_apply(tnet, no_prior=not with_prior)(
        ti8.quantize_weights(tnet), _tscales(scales), _t(x), _t(prior) if with_prior else None)
    lj = np.asarray(oj.prob_logits.astype(jnp.float32))
    lt = ot.prob_logits.to(torch.float32).numpy()
    lr = np.asarray(ref.prob_logits)
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    gap = rms(lj - lr) / rms(lr)  # JAX's own int8 error
    assert gap > 0.005
    assert rms(lt - lj) / rms(lr) <= 0.1 * gap
    uv_gap = np.abs(np.asarray(oj.uv) - np.asarray(ref.uv)).max()
    assert np.abs(ot.uv.numpy() - np.asarray(oj.uv)).max() <= 0.1 * uv_gap
    np.testing.assert_allclose(ot.kp_mask.numpy(), np.asarray(oj.kp_mask), atol=1e-3)


@pytest.mark.parametrize("mode", ["post_stem", "concat"])
def test_prior_free_program_equals_the_zero_prior_program(mode, post_stem, concat):
    """Bit for bit, the post-stem projection's bias included. JAX's
    prior-free program drops that bias (`int8_forward.py:473-475`), so with
    a nonzero bias it differs from JAX's own zero-prior program."""
    jnet, v, tnet, x, prior, scales = post_stem if mode == "post_stem" else concat
    s, qw = _tscales(scales), ti8.quantize_weights(tnet)
    zero = ti8.make_int8_apply(tnet)(qw, s, _t(x), torch.zeros(prior.shape))
    free = ti8.make_int8_apply(tnet, no_prior=True)(qw, s, _t(x))
    assert torch.equal(zero.prob_logits, free.prob_logits)
    assert torch.equal(zero.uv, free.uv) and torch.equal(zero.kp_mask, free.kp_mask)
    if mode == "post_stem":
        assert np.abs(v["params"]["HourglassNet_0"]["Conv_1"]["bias"]).max() > 0
        xj = jnp.asarray(x)
        zj = ji8.make_int8_apply(jnet)(v, scales, xj, jnp.zeros(prior.shape, jnp.float32))
        fj = ji8.make_int8_apply(jnet, no_prior=True)(v, scales, xj)
        assert not np.array_equal(np.asarray(zj.prob_logits.astype(jnp.float32)),
                                  np.asarray(fj.prob_logits.astype(jnp.float32)))


def test_frame_inference_needs_scales_or_calibration_frames(post_stem):
    with pytest.raises(ValueError, match="activation scales"):
        tk.make_frame_inference(post_stem[2], (64, 64), "cpu", int8=True, int8_calib_frames=0)


@pytest.fixture(scope="module")
def engines(post_stem):
    """Both engines, single-view mode with int8 inference and online
    calibration over the first two frames, three views of a 3-object
    scene (loose filter thresholds, as tests/test_torch_slice.py, so that
    PnP and BA run on the random net's keypoints). Single view runs the
    prior-free program, so the post-stem projection's bias is zeroed here,
    where JAX's prior-free program and the port's agree (see above)."""
    jnet = post_stem[0]
    v = jax.tree.map(np.array, post_stem[1])
    v["params"]["HourglassNet_0"]["Conv_1"]["bias"][:] = 0
    tnet = PkpNet(**backbone_config(v))
    tnet.load_state_dict(from_jax_variables(v), strict=True)
    kw = dict(single_view_mode=True, input_hw=(64, 64), mask_thresh=-1.0,
              kp_var_thresh=10.0, bbox_thresh=1.5, int8_inference=True, int8_calib_frames=2)
    mesh = StubMeshDb(8)
    eng_j = JaxSlam(JaxConfig(**kw), mesh_db=mesh, net=jnet, params=v)
    eng_t = ObjectSlam(SlamConfig(**kw), mesh_db=mesh, net=tnet, hyp_sampler=jax_key_chain,
                       device="cpu")
    runs = _run([eng_j, eng_t], make_scene(n_obj=3, n_views=3, seed=1))
    return eng_j, eng_t, runs


def test_engine_with_int8_inference_matches_jax(engines):
    """Poses, scores, inlier and validity masks as tests/test_torch_slice.py;
    uv within 2e-3 NDC: the two ROI stages' crops differ in their last bits
    and so do the online scales, which moves a few int8 codes by one
    (measured after the last view: 3.0e-4 at most, 15 of 10,496 coordinates
    above 1e-4; JAX's own int8-vs-f32 uv error on this net's crops is
    0.6-1.7)."""
    eng_j, eng_t, runs = engines
    for rj, rt in runs:
        _compare(eng_j, eng_t, rj, rt)
        np.testing.assert_allclose(eng_j.uv, eng_t.uv, atol=2e-3)
    assert eng_t.avg_std_n == eng_j.avg_std_n > 0


def test_frame_inference_online_calibration_matches_jax(engines):
    """The scales the two engines' frame inference calibrated online (two
    frames, worst-case prior, tree-max) agree within 1e-5 of each point's
    largest entry; then the with-prior int8 program on another frame agrees
    within 2e-3 on uv, as the engine's (measured: 1.1e-3 at most, 35 of 328
    coordinates above 1e-4), and within 2e-2 on the validity (measured
    2.9e-3: the flipped codes move the pooled logits, which the random Dense
    layer mixes; JAX's own test holds its int8 validity to 0.2 of f32's)."""
    eng_j, eng_t, _ = engines
    sj, st = eng_j._infer.int8_state["scales"], eng_t._infer.int8_state["scales"]
    assert eng_t._infer.int8_state["n_calib"] == 2 and len(st) == len(sj) == 143
    for a, b in zip(sj, st):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-5 * np.abs(a).max())
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (240, 320, 3)).astype(f32)
    boxes = np.array([[20, 30, 120, 130], [100, 40, 220, 200], [0, 0, 16, 16], [0, 0, 16, 16]],
                     f32)
    valid = np.array([True, True, False, False])
    puv = rng.uniform(-0.6, 0.6, (4, 41, 2)).astype(f32)
    pv = rng.uniform(size=(4, 41)) < 0.5
    oj = eng_j._infer(jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(valid),
                      jnp.asarray(puv), jnp.asarray(pv))
    ot = eng_t._infer(_t(img), _t(boxes), torch.from_numpy(valid), _t(puv), torch.from_numpy(pv))
    np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]), atol=2e-3)
    np.testing.assert_allclose(ot[2].numpy(), np.asarray(oj[2]), atol=2e-2)


def _reference_checkpoint(path):
    """A small reference `.pth.tar` (concat prior mode) of seeded weights."""
    from tests.test_torch_evaluate import _reference_state_dict

    net = JaxPkpNet(n_stack=2, n_modules=2, features=8, prior_mode="concat",
                    transpose_heatmaps=True)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(0)
    v = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(f32) * 0.3, shapes)
    v["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, v["batch_stats"])
    sd = _reference_state_dict(v["params"], v["batch_stats"])
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in sd.items()},
                "epoch": 3, "args": None}, path)


def test_cli_int8_with_a_calibrated_sidecar(tmp_path):
    root = tmp_path / "bop_datasets" / "ycbv"
    write_synthetic_bop(str(root), n_scenes=1, n_views=2, seed=3, splits=("test",))
    ck = str(tmp_path / "ck" / "checkpoint-3.pth.tar")
    os.makedirs(os.path.dirname(ck))
    _reference_checkpoint(ck)
    env = dict(os.environ, PYTHONPATH=REPO)
    common = ["--device", "cpu", "--dataset", "ycbv", "--data_root", str(root),
              "--kp_config_root", str(root / "kp_configs"), "--checkpoint_path", ck]
    r = subprocess.run([sys.executable, "-m", "suo_slam_tpu_torch.calibrate_int8", *common,
                        "--n_frames", "2"], cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    side = ck + ".int8_scales.npz"
    scales = ti8.load_scales(side)
    # concat prior mode: 254 points (no quant_pair after a post-stem injection)
    assert len(scales) == 254 and all(torch.isfinite(s).all() for s in scales)
    assert len(ji8.load_scales(side)) == 254  # the JAX package reads it too
    r = subprocess.run([sys.executable, "-m", "suo_slam_tpu_torch.evaluate", *common, "--int8",
                        "--nviews", "1", "--no_viz", "--detection_type", "gt"],
                       cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert f"int8 scales sidecar: {side}" in r.stdout
    outdir = tmp_path / "ck" / "pkpnet-epoch=3-nviews=1-det=gt_ycbv-test"
    assert (outdir / "summary.txt").is_file()
    assert re.search(r"AUC of ADD\(-S\): [\d.]+", (outdir / "summary.txt").read_text())


def test_cli_int8_refusals(tmp_path, post_stem):
    root = tmp_path / "bop_datasets" / "ycbv"
    write_synthetic_bop(str(root), n_scenes=1, n_views=2, seed=3, splits=("test",))
    kw = dict(nviews=1, detection_type="gt", no_viz=True, device="cpu",
              kp_config_root=str(root / "kp_configs"))
    net = post_stem[2]
    with pytest.raises(SystemExit, match="--int8_scales not found"):
        port_evaluate.Evaluator("ycbv", str(root), "", int8=True, net=net,
                                int8_scales=str(tmp_path / "missing.npz"), **kw)
    with pytest.raises(SystemExit, match="ROADMAP A13"):
        port_evaluate.Evaluator("ycbv", str(root), "", int8=True, batched=True, net=net, **kw)
    with pytest.raises(SystemExit, match="norm='batch' network"):
        port_evaluate.Evaluator("ycbv", str(root), "", int8=True, debug_gt_kp=True, **kw)
    # no sidecar: online calibration, announced
    ev = port_evaluate.Evaluator("ycbv", str(root), "", int8=True, net=net, **kw)
    assert ev.object_slam.cfg.int8_inference and ev.object_slam.cfg.int8_scales_path is None
    assert "scales" not in ev.object_slam._infer.int8_state
