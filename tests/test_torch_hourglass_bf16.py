"""The backbone's working dtype and its fused epilogues (B4) on the CPU.

- The plain versions of K8 (norm-ReLU) and K9 (upsample-add) against the JAX
  package's unfused ops — `MaskedBatchNorm` then `nn.relu`, and
  `up1 + upsample2x(low)` — in f32 and bf16.
- A narrow PkpNet in bf16 against the JAX package's bf16 net, flax weights
  carried across (random BatchNorm statistics and affine). The two
  frameworks round bf16 at different places: flax adds a convolution's bias
  as a second bf16 rounding while PyTorch's convolution adds it before its
  one rounding, and the two CPU convolutions accumulate in another order. The
  two bf16 nets are independent roundings of one f32 net, and with random
  weights their flat heatmaps make uv sensitive (JAX's bf16 uv is up to 0.13
  NDC off its f32 uv here). So each output is held to the error JAX's own
  bf16 net makes: the port's bf16 against JAX's f32 within 1.25x JAX's
  bf16-vs-f32 gap (largest and mean absolute error), and against JAX's bf16
  within twice that gap (the triangle inequality). The f32 nets agree within
  2e-4 as in test_torch_pkpnet.py.
- Gradients after an inference call: a net first called under
  `torch.inference_mode`, then with autograd on, gives the convolutions'
  weights and the norms' scale / bias the gradients of a net that was never
  called before (the weight cast and the norm affine are made in the graph
  while autograd records the parameters, and cached only outside it).
- The call counts per forward of the full architecture (2 stacks x 2 modules,
  depth 4): 180 norm-ReLU passes (59 residuals x 3, the stem, 2 ll norms) and
  8 upsample-adds (4 levels x 2 stacks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.models import PkpNet as JaxPkpNet
from suo_slam_tpu.models import hourglass as jhg
from suo_slam_tpu_torch.models import hourglass as thg
from suo_slam_tpu_torch.models.convert import backbone_config, from_jax_variables
from suo_slam_tpu_torch.models.pkpnet import PkpNet
from tests.test_torch_pkpnet import _variables

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _to_torch(a, dt):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_norm_relu_plain_matches_jax_norm_then_relu(dt):
    rng = np.random.default_rng(0)
    C = 24
    x = rng.normal(size=(3, 5, 7, C)).astype(np.float32)        # NHWC
    scale, bias = rng.uniform(0.5, 1.5, C), rng.normal(size=C)
    mean, var = rng.normal(size=C) * 0.3, rng.uniform(0.5, 1.5, C)
    f32 = lambda a: np.asarray(a, np.float32)
    variables = {"params": {"scale": f32(scale), "bias": f32(bias)},
                 "batch_stats": {"mean": f32(mean), "var": f32(var)}}
    xj = jnp.asarray(x).astype(JDT[dt])
    ref = jax.nn.relu(jhg.MaskedBatchNorm().apply(variables, xj))
    m = thg.MaskedBatchNorm(C)
    with torch.no_grad():
        for name, a in (("scale", scale), ("bias", bias), ("mean", mean), ("var", var)):
            getattr(m, name).copy_(torch.from_numpy(f32(a)))
    xt = _to_torch(x, dt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    out = m(xt)
    assert out.dtype == dt and out.is_contiguous(memory_format=torch.channels_last)
    got = out.permute(0, 2, 3, 1).float().detach().numpy()  # the affine is in the graph
    want = np.asarray(ref.astype(jnp.float32))
    # f32: the same product and sum (XLA may contract them, 1 ulp); bf16: one
    # rounding of that f32 value, at most 1 bf16 ulp apart
    tol = 1e-6 if dt == torch.float32 else 2.0 ** -8
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert np.array_equal(got == 0, want == 0)
    # the cached affine follows a weight update
    with torch.no_grad():
        m.var.mul_(4.0)
    assert not torch.equal(m(xt), out)
    with pytest.raises(ValueError, match="channels_last"):
        m(_to_torch(x, dt).permute(0, 3, 1, 2).contiguous())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_upsample_add_plain_matches_jax(dt):
    rng = np.random.default_rng(1)
    up1 = rng.normal(size=(2, 8, 6, 12)).astype(np.float32)
    low = rng.normal(size=(2, 4, 3, 12)).astype(np.float32)
    ref = jnp.asarray(up1).astype(JDT[dt]) + jhg.upsample2x(jnp.asarray(low).astype(JDT[dt]))
    cl = lambda a: _to_torch(a, dt).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    out = thg.upsample_add(cl(up1), cl(low))
    assert out.dtype == dt
    assert np.array_equal(out.permute(0, 2, 3, 1).float().numpy(),
                          np.asarray(ref.astype(jnp.float32)))


class _JitInit:
    """`net.init` compiled once (the eager init dispatches op by op)."""

    def __init__(self, net):
        self.init = jax.jit(net.init)


def test_bf16_net_matches_jax_bf16():
    rng = np.random.default_rng(2)
    crops = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    prior = rng.uniform(0, 1, (4, 16, 16, 41)).astype(np.float32)
    kw = dict(n_stack=2, n_modules=1, features=16)
    v = _variables(_JitInit(JaxPkpNet(**kw)), (64, 64), seed=3)  # the same weights for both
    outs = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jnet = JaxPkpNet(**kw, dtype=jdt)
        tnet = PkpNet(**backbone_config(v), dtype=tdt)
        tnet.load_state_dict(from_jax_variables(v), strict=True)
        tnet.eval()
        oj = jax.jit(jnet.apply)(v, jnp.asarray(crops), jnp.asarray(prior))
        with torch.inference_mode():
            ot = tnet(torch.from_numpy(crops), torch.from_numpy(prior))
        assert tnet.dtype == tdt and ot.uv.dtype == torch.float32
        outs[name] = ({k: np.asarray(getattr(oj, k)) for k in ("uv", "cov", "kp_mask")},
                      {k: getattr(ot, k).numpy() for k in ("uv", "cov", "kp_mask")})
    (j32, t32), (j16, t16) = outs["f32"], outs["bf16"]
    for k in ("uv", "cov", "kp_mask"):
        np.testing.assert_allclose(t32[k], j32[k], atol=2e-4, rtol=0, err_msg=k)
        gap = np.abs(j16[k] - j32[k])  # JAX's own bf16 error
        err = np.abs(t16[k] - j32[k])
        assert gap.max() > 0, k
        assert err.max() <= 1.25 * gap.max() and err.mean() <= 1.25 * gap.mean(), (k, err, gap)
        assert np.abs(t16[k] - j16[k]).max() <= 2.0 * gap.max(), k


def test_launches_per_forward_of_the_full_architecture(monkeypatch):
    calls = {"norm_relu": 0, "upsample_add": 0}
    for name in calls:
        fn = getattr(thg, name)

        def spy(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(thg, name, spy)
    net = PkpNet(n_stack=2, n_modules=2, features=8, dtype=torch.bfloat16).eval()
    with torch.inference_mode():
        out = net(torch.rand(2, 64, 64, 3))
    assert calls == {"norm_relu": 180, "upsample_add": 8}
    assert torch.isfinite(out.uv).all() and out.uv.dtype == torch.float32


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gradients_after_an_inference_mode_call(dt):
    torch.manual_seed(0)
    kw = dict(n_stack=2, n_modules=1, features=8, dtype=dt)
    net = PkpNet(**kw)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, thg.MaskedBatchNorm):
                m.mean.normal_(0, 0.1)
                m.var.uniform_(0.5, 1.5)
                m.scale.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
    fresh = PkpNet(**kw)
    fresh.load_state_dict(net.state_dict())
    x, prior = torch.rand(2, 64, 64, 3), torch.rand(2, 16, 16, 41)
    with torch.inference_mode():
        before = net.backbone_logits(x, prior)

    def grads(m):
        m.zero_grad(set_to_none=True)
        loss = sum(o.float().square().mean() for o in m.backbone_logits(x, prior))
        loss.backward()
        return {n: p.grad for n, p in m.named_parameters()}

    got, want = grads(net), grads(fresh)
    checked = 0
    for name, g in want.items():
        if name.endswith(("weight", ".scale", ".bias")) and "classifier" not in name:
            assert g is not None and got[name] is not None, name
            assert torch.equal(got[name], g), name
            checked += 1
    assert checked > 100 and any(n.endswith(".scale") for n in want)
    # inference is unchanged: the same bits, and one cast per weight update
    with torch.inference_mode():
        again = net.backbone_logits(x, prior)
        casts = {m: m._cast_cache for m in net.modules() if hasattr(m, "_cast_cache")}
        net.backbone_logits(x, prior)
    assert all(torch.equal(a, b) for a, b in zip(before, again))
    assert all(m._cast_cache is c for m, c in casts.items())
    assert (len(casts) > 0) == (dt == torch.bfloat16)
