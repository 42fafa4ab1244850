"""The quantized PkpNet (`quant="calib" | "int8"`, B12) against the JAX
package's, on the CPU (K11's f32 epilogue and K12's f32 mode through their
plain versions).

- one `QuantConv` in int8 mode is bit-equal to JAX's `Conv(mode="int8")` on
  the same f32 input and on the same bf16 input: a 1x1, a 3x3 and the 7x7
  stride-2 stem on 3 channels (its codes 16 wide);
- `calibrate` gives every `act_absmax` of JAX's "quant" collection within
  1e-6 relative with both sides in f64, and within 1e-5 in f32 (the two f32
  nets sum their convolutions in other orders: measured 2e-6); the prior
  projection's stays 0 without a prior;
- the whole int8 net in f32 with JAX's calibrated scales (carried by
  `convert.from_jax_variables`): `uv` within 1e-3 and `prob_logits` within
  1e-3 relative RMS of JAX's `PkpNet(quant="int8")` (see the test for the
  measured gaps and why f32 takes flax's initial weights); in bf16 within
  2e-2 (uv) and 1e-2 (RMS);
- with its own calibration the int8 net lands where a change of 1e-6 in the
  scales puts JAX's own (a code at a rounding boundary flips): held to the
  JAX test's own int8-vs-float bound, 0.03 relative RMS of the logits;
- the prior-free program's projection gives exactly its bias, the float
  checkpoint loads into the quantized net, `to_jax_variables` writes the
  "quant" collection JAX's tree has, and train mode raises;
- K11's planner takes every convolution of the full-width quantized net to
  its wgmma route in both f32-epilogue modes (meta device).

Sizes: `tests/test_quant.py`'s TINY net (2 stacks x 1 module x 32
features), 64x64 crops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.models import PkpNet as JaxPkpNet
from suo_slam_tpu.models.quant import Conv as JaxConv
from suo_slam_tpu.models.quant import calibrate as jax_calibrate
from suo_slam_tpu_torch.models import int8_kernels as ik
from suo_slam_tpu_torch.models import quant
from suo_slam_tpu_torch.models.convert import (backbone_config, from_jax_variables,
                                               to_jax_variables)
from suo_slam_tpu_torch.models.pkpnet import PkpNet
from tests.test_torch_train_step import _jax_in_f64

TINY = dict(n_stack=2, n_modules=1, features=32)
HW = 64


def _crops(seed, n=4):
    return np.random.default_rng(seed).uniform(0, 1, (n, HW, HW, 3)).astype(np.float32)


def _rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def _calibrate_jax(v, x):
    jc = JaxPkpNet(quant="calib", **TINY)
    return jax.tree.map(np.asarray, jax_calibrate(jc, v, [jnp.asarray(x[:2]),
                                                          jnp.asarray(x[2:])]))


def _jax_init():
    jc = JaxPkpNet(quant="calib", **TINY)
    return jax.tree.map(np.asarray, jc.init(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3))))


@pytest.fixture(scope="module")
def calibrated():
    """JAX's calib net initialised, with non-trivial BatchNorm statistics and
    conv biases, calibrated on two batches of two crops."""
    v = _jax_init()
    rng = np.random.default_rng(1)

    def perturb(path, a):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
        return a

    v = {"params": jax.tree_util.tree_map_with_path(perturb, v["params"]),
         "batch_stats": jax.tree_util.tree_map_with_path(perturb, v["batch_stats"]),
         "quant": v["quant"]}
    x = _crops(2)
    return v, _calibrate_jax(v, x), x


def _port(variables, dtype=torch.float32, quant_mode="int8"):
    net = PkpNet(**backbone_config(variables), quant=quant_mode, dtype=dtype)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return net.eval().to(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cin,cout,k,stride,pad", [(32, 16, 1, 1, 0), (16, 16, 3, 1, 1),
                                                    (3, 64, 7, 2, 3)])
def test_quant_conv_is_bit_equal_to_jax(cin, cout, k, stride, pad, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(cin + k)
    hw = 32 if k == 7 else 16
    x = jnp.asarray((rng.normal(size=(2, hw, hw, cin)) * 1.5).astype(np.float32)).astype(jdt)
    m = JaxConv(cout, (k, k), strides=(stride, stride), padding=pad or "SAME", dtype=jdt,
                mode="int8")
    p = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(k), x)["params"])
    p["bias"] = rng.normal(0.0, 0.1, cout).astype(np.float32)
    absmax = np.float32(float(jnp.max(jnp.abs(x.astype(jnp.float32)))) * 0.8)  # some clip
    want = np.asarray(m.apply({"params": p, "quant": {"act_absmax": absmax}}, x)
                      .astype(jnp.float32))
    t = quant.QuantConv(cin, cout, k, stride=stride, padding=pad)
    with torch.no_grad():
        t.weight.copy_(torch.from_numpy(np.transpose(p["kernel"], (3, 2, 0, 1)).copy()))
        t.bias.copy_(torch.from_numpy(p["bias"]))
        t.act_absmax.fill_(float(absmax))
        xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(tdt)
        got = t(xt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(), want)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_calibration_matches_jax(calibrated, dtype):
    """f64 on both sides: every act_absmax within 1e-6 relative (the
    composition; measured ~1e-16). f32: within 1e-5 relative, a bound
    f32 decides — the two nets sum their convolutions in other orders and
    the maxima inherit a few ulps per layer (measured 2e-6)."""
    v, vc, x = calibrated
    batches = [x[:2], x[2:]]
    if dtype == "f64":
        up = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
        with _jax_in_f64():
            jc = JaxPkpNet(quant="calib", dtype=jnp.float64, **TINY)
            want = jax_calibrate(jc, up(v), [jnp.asarray(b, jnp.float64) for b in batches])
        want = jax.tree.map(np.asarray, want["quant"])
        net = PkpNet(**backbone_config(v), quant="int8", dtype=torch.float64).double()
        net.load_state_dict(from_jax_variables(v, np.float64), strict=True)
        net = net.eval().to(memory_format=torch.channels_last)
        tol = 1e-6
    else:
        want, net, tol = vc["quant"], _port(v), 1e-5
    assert all(float(m.act_absmax) == 0 for m in quant.quant_convs(net))  # uncalibrated
    quant.calibrate(net, [torch.from_numpy(b).to(net.dtype) for b in batches])
    assert net.quant == "int8" and all(m.mode == "int8" for m in quant.quant_convs(net))
    mine = to_jax_variables(net)["quant"]
    assert jax.tree.structure(mine) == jax.tree.structure(want)
    proj = want["HourglassNet_0"]["Conv_1"]["act_absmax"]  # the post-stem prior projection
    assert float(proj) == 0 and float(mine["HourglassNet_0"]["Conv_1"]["act_absmax"]) == 0
    rel = [abs(float(a) - float(b)) / float(b)
           for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)) if float(b) > 0]
    assert len(rel) == len(jax.tree.leaves(want)) - 1 and max(rel) <= tol, max(rel)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_net_matches_jax_on_its_scales(calibrated, dtype):
    """The whole int8 net on JAX's scales. f32: flax's initial weights
    (norms at unit statistics, zero biases), where the float layers between
    the quantized convolutions round as JAX's do, so no code flips: uv
    within 1e-3, logits within 1e-3 relative RMS (measured 1.4e-6 and
    8e-8). With the perturbed norms a one-ulp difference of an f32 rsqrt or
    of a head's sum moves a code across a rounding boundary, as a 1e-6
    change of the scales does in JAX alone (uv 0.17 on these crops): that
    case is the next test's. bf16 on the perturbed net: casts absorb those
    ulps; uv within 2e-2, logits 1e-2 RMS (measured 5e-6, 8e-8)."""
    if dtype == "f32":
        x = calibrated[2]
        vc, jdt, tdt = _calibrate_jax(_jax_init(), x), jnp.float32, torch.float32
    else:
        _, vc, x = calibrated
        jdt, tdt = jnp.bfloat16, torch.bfloat16
    out_j = JaxPkpNet(quant="int8", dtype=jdt, **TINY).apply(vc, x)
    net = _port(vc, tdt)
    with torch.no_grad():
        out_t = net(torch.from_numpy(x))
    uv_tol, rms_tol = (1e-3, 1e-3) if dtype == "f32" else (2e-2, 1e-2)
    assert np.abs(out_t.uv.numpy() - np.asarray(out_j.uv)).max() <= uv_tol
    assert _rms(out_t.prob_logits.numpy(), out_j.prob_logits) <= rms_tol


def test_int8_net_on_its_own_calibration(calibrated):
    """The perturbed net calibrated by the port against JAX's end to end:
    within the JAX test's own int8-vs-float bound, 0.03 relative RMS of the
    logits (measured 0.010; JAX's own int8 net moves as far when its scales
    change by 1e-6)."""
    v, vc, x = calibrated
    out_j = JaxPkpNet(quant="int8", **TINY).apply(vc, x)
    net = quant.calibrate(_port(v), [torch.from_numpy(x[:2]), torch.from_numpy(x[2:])])
    with torch.no_grad():
        out_t = net(torch.from_numpy(x))
    assert np.isfinite(out_t.uv.numpy()).all()
    assert _rms(out_t.prob_logits.numpy(), out_j.prob_logits) <= 0.03


def test_prior_free_projection_gives_its_bias(calibrated):
    """With no prior the int8 projection's codes are all zero, so the
    convolution is its bias, cast: the bias-only shortcut is exact."""
    _, vc, x = calibrated
    net = _port(vc)
    proj = net.backbone.extra_proj
    zero = torch.zeros((2, 41, HW // 4, HW // 4)).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = proj(zero)
        assert torch.equal(y, proj.bias[None, :, None, None].expand_as(y))
        a = net(torch.from_numpy(x[:2]))
        b = net(torch.from_numpy(x[:2]), torch.zeros((2, HW // 4, HW // 4, 41)))
    assert torch.equal(a.prob_logits, b.prob_logits)


def test_quantized_net_trees_and_modes(calibrated):
    v, vc, x = calibrated
    net = _port(vc, quant_mode="calib")
    assert net.quant == "calib"
    back = to_jax_variables(net)
    assert sorted(back) == ["batch_stats", "params", "quant"]
    for k in back:
        assert jax.tree.structure(back[k]) == jax.tree.structure(vc[k]), k
        for a, b in zip(jax.tree.leaves(back[k]), jax.tree.leaves(vc[k])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert "quant" not in to_jax_variables(PkpNet(**backbone_config(v)))
    with pytest.raises(ValueError, match="inference-only"):
        net(torch.from_numpy(x[:2]), train=True)
    with pytest.raises(ValueError):
        PkpNet(**TINY, quant="fp8")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k11_plan_takes_the_quantized_net_to_wgmma(dtype):
    """Every stride-1 convolution of the full-width quantized net (2 x 2 x
    256, 256x256 crops, 8 and 128 of them) takes K11's wgmma route in its
    f32-epilogue mode with a ring of at least 2 stages in the shared memory
    of one of two blocks on an SM; the stem (7x7 stride 2) the mma.sync
    route."""
    mode = ik.conv_mode(False, dtype)
    with torch.device("meta"):
        net = PkpNet(n_stack=2, n_modules=2, features=256, quant="int8")
    convs = [(k, m) for k, m in net.backbone.named_modules() if isinstance(m, quant.QuantConv)]
    n_conv = sum(isinstance(m, torch.nn.Conv2d) for m in net.modules())
    assert len(convs) == n_conv - 2  # all but the two f32 heads

    def size(name):  # the input's side at 256x256 crops
        if name == "stem":
            return 256
        if name.startswith("pre.0."):
            return 128
        return 64 >> sum(s in ("low1", "low2", "low3") for s in name.split("."))

    for n in (8, 128):
        routes = {}
        for name, m in convs:
            hw = size(name)
            plan = ik.plan_conv(n, hw, hw, ik.padded(m.in_channels), m.out_channels,
                                m.kernel_size[0], m.kernel_size[1], m.stride[0], m.padding[0],
                                mode)
            routes[plan.route] = routes.get(plan.route, 0) + 1
            if plan.route == "wgmma":
                assert 2 <= plan.stages and plan.smem <= ik.WG_SMEM, (name, plan)
        assert routes == {"mma_sync": 1, "wgmma": len(convs) - 1}, routes
