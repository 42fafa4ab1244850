"""The port's training step against the JAX package's, on the CPU.

- the losses of `train/losses.py` (value and gradient);
- the whole net's gradients with fixed (running) statistics, where the
  computation is well conditioned: loss 1e-5 relative, every gradient 1e-4
  of its tensor's largest magnitude;
- one `make_train_step` of a tiny net (2 stacks x 1 module x 16 features,
  64x64 crops) from converted JAX parameters, on a batch with a padded
  object slot and JAX's own dropout mask (recovered from
  `capture_intermediates`: keep where the dropout output is non-zero, or
  where relu(pooled) is 0 and the mask has no effect): loss and its terms,
  every gradient, the new running statistics;
- Adam against `optax.adam` on equal gradients, and the mapping of its state
  onto optax's;
- a 3-step loss trajectory, each step with JAX's dropout mask.

The train-mode step at flax's random initialization is ill-conditioned:
through ~100 batch-normalized layers a relative change of 1e-6 in the input
images moves its gradients by 5e-3 of a tensor's largest magnitude (median
over the tensors; up to 4e-2), and larger crops, widths or batches and
smaller norm scales did not help. Rounding alone therefore moves them far:
on this batch
JAX's own f32 step lies 4e-5 (loss), 3e-4 (terms), 4e-4 (statistics) and up
to 0.47 of a gradient tensor's largest magnitude (whole-gradient cosine
0.995) from the same step evaluated in f64; its bf16 step 2e-2, 0.16, 0.2
and cosine ~0 (`tests/helpers/train_step_conditioning.py` prints these
numbers). So the step is compared where the arithmetic decides it:

- f64: the port's step with f64 parameters and batch (its plain versions
  compute in f64 for f64 input) against JAX's step traced with f64 wherever
  it names f32 (`_jax_in_f64`). Both are then exact to ~1e-11 and are held
  far below the f32 tolerances of a well-conditioned step (loss 1e-5,
  gradients 1e-4 of each tensor's largest magnitude, statistics 1e-5): loss
  and terms 1e-10 relative, every gradient 1e-9, statistics 1e-10. This is
  the test of the composition: row masks, K16 / K17 through every norm, K18,
  K19, dropout, padded slots.
- f32: the port's f32 step against that f64 step (measured: loss 2e-5,
  terms 2e-5, statistics 7e-5, gradients 0.19 at worst, cosine 0.9987),
  within fixed bounds above what f32 decides here (JAX f32's own distances
  above): loss and terms 1e-3 relative, statistics 1e-3, every gradient 0.5
  of its tensor's largest magnitude (an all-zero or sign-flipped tensor is
  1 or 2 away) and the whole gradient's cosine at least 0.99.
- bf16: the port's bf16 step against JAX's bf16 step (measured: loss 4e-3,
  terms 0.1, statistics 0.14): loss and terms 0.2 relative, statistics 0.3,
  bounds at JAX bf16's own distance from f64. Its gradients
  (`test_train_step_gradients_match_jax[bf16]`) are held with fixed
  statistics, where bf16 decides them: loss 1e-2 relative, the whole
  gradient's cosine with JAX's bf16 one at least 0.99; the train-mode terms
  in bf16 are held per kernel in `tests/test_torch_train_kernels.py`.

In every case a convolution's bias that feeds a batch norm (all but the
last head's) has gradient 0, as the norm removes it: the port's must stay
below 1e-4 of its weight's largest gradient in f32 (1e-10 in f64). Adam's
first steps are lr * sign(g) where g is ~0, so the 3-step trajectory compares
losses, not parameters, within 1e-2 relative, while the loss falls by ~20%
over the three steps.
"""

import contextlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from suo_slam_tpu.models.pkpnet import PkpNet as JaxPkpNet
from suo_slam_tpu.ops import heatmap as jhm
from suo_slam_tpu.ops import roi as jroi
from suo_slam_tpu.train import harness as jh
from suo_slam_tpu.train import losses as jl
from suo_slam_tpu_torch.models import convert
from suo_slam_tpu_torch.models.pkpnet import PkpNet
from suo_slam_tpu_torch.ops import heatmap as thm
from suo_slam_tpu_torch.train import harness as th
from suo_slam_tpu_torch.train import losses as tl

HW = (64, 64)
TINY = dict(n_stack=2, n_modules=1, features=16)
EPOCH = 7.0
TOL = {  # fixed; see the module docstring
    "f64": dict(loss=1e-10, grad=1e-9, stats=1e-10, zero=1e-10),
    "f32": dict(loss=1e-3, grad=0.5, cos=0.99, stats=1e-3, zero=1e-4),
    "bf16": dict(loss=0.2, stats=0.3),
}


def _batch_np(seed=0):
    rng = np.random.default_rng(seed)
    B, O, K = 2, 4, 41
    x1 = rng.uniform(0, 60, (B, O))
    y1 = rng.uniform(0, 40, (B, O))
    boxes = np.stack([x1, y1, x1 + rng.uniform(30, 60, (B, O)),
                      y1 + rng.uniform(30, 50, (B, O))], -1).astype(np.float32)
    return dict(
        images=rng.uniform(0, 1, (B, 96, 128, 3)).astype(np.float32),
        boxes=boxes,
        obj_mask=np.array([[1, 1, 1, 1], [1, 1, 1, 0]], bool),
        prior_uv=rng.uniform(-0.9, 0.9, (B, O, K, 2)).astype(np.float32),
        prior_mask=rng.uniform(size=(B, O, K)) < 0.3,
        uv_gt=rng.uniform(-1, 1, (B, O, K, 2)).astype(np.float32),
        kp_mask=rng.uniform(size=(B, O, K)) < 0.4,
    )


def _f64(tree):
    """Float arrays of a batch dict or a variables tree in f64."""
    up = lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f" else a
    return jax.tree.map(up, tree)


@contextlib.contextmanager
def _jax_in_f64():
    """JAX's functions traced in this context compute in f64 wherever they
    name f32 (the norms' statistics, the f32 heads, the readout, the loss):
    with f64 parameters and inputs, the whole step is f64."""
    f32 = jnp.float32
    jnp.float32 = jnp.float64
    try:
        yield
    finally:
        jnp.float32 = f32


def _jbatch(b):
    return jh.Batch(**{k: jnp.asarray(v) for k, v in b.items()})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_dropout_keep(net, variables, jb, key):
    """JAX's dropout keep mask in `_forward_loss` for this key."""
    return np.asarray(_keep_jit(net, variables, jb, key))


@partial(jax.jit, static_argnums=0)
def _keep_jit(net, variables, jb, key):
    b, o = jb.boxes.shape[:2]
    crops = jroi.roi_crop_batch(jb.images, jb.boxes, jb.obj_mask, HW)
    crops = crops.reshape((b * o,) + crops.shape[2:])
    phw = net.prior_hw(HW)
    prior = jhm.render_prior_heatmaps(jb.prior_uv.reshape(b * o, -1, 2),
                                      jb.prior_mask.reshape(b * o, -1), hw=phw,
                                      sigma_px=jhm.prior_sigma_for(phw))
    out, st = net.apply(variables, crops, prior, train=True, row_mask=jb.obj_mask.reshape(-1),
                        rngs={"dropout": key}, mutable=["batch_stats", "intermediates"],
                        capture_intermediates=True)
    d = st["intermediates"]["Dropout_0"]["__call__"][0]
    pooled = jnp.mean(out.prob_logits, axis=(1, 2))
    return (d != 0) | (jnp.maximum(pooled, 0) == 0)


def _port_net(variables, dtype):
    net = PkpNet(**TINY, dtype=dtype)
    f64 = dtype == torch.float64
    sd = convert.from_jax_variables(jax.tree.map(np.asarray, variables),
                                    np.float64 if f64 else np.float32)
    if f64:
        net = net.double()
    net.load_state_dict(sd)
    return net.to(memory_format=torch.channels_last)


def _jax_step_grads(net, variables, key, jb):
    """jit of params -> (loss, aux, new stats, grads) of JAX's
    `_forward_loss` in train mode."""

    @jax.jit
    def f(params):
        (loss, (aux, stats)), grads = jax.value_and_grad(
            lambda p: jh._forward_loss(net, p, variables["batch_stats"], jb,
                                       jnp.asarray(EPOCH), key, True, HW),
            has_aux=True)(params)
        return loss, aux, stats, grads

    return f


def _flat(grads, stats, variables, dtype=np.float32):
    """JAX trees -> the port's state_dict names."""
    return convert.from_jax_variables(jax.tree.map(np.asarray, {
        "params": grads if grads is not None else variables["params"],
        "batch_stats": stats if stats is not None else variables["batch_stats"]}), dtype)


def _jax_step(jdt, variables, b, key):
    """JAX's train step of the tiny net in `jdt`: its dropout keep mask and
    (loss, aux, gradients, new statistics) under the port's names."""
    net = JaxPkpNet(**TINY, dtype=jdt)
    jb = _jbatch(b)
    keep = _jax_dropout_keep(net, variables, jb, key)
    loss, aux, stats, grads = _jax_step_grads(net, variables, key, jb)(variables["params"])
    npd = np.float64 if jdt == jnp.float64 else np.float32
    return keep, dict(loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                      grads={k: v.numpy() for k, v in _flat(grads, variables["batch_stats"],
                                                            variables, npd).items()},
                      stats={k: v.numpy() for k, v in _flat(None, stats, variables,
                                                            npd).items()})


@pytest.fixture(scope="module")
def init_and_batch():
    net = JaxPkpNet(**TINY)
    return net.init(jax.random.PRNGKey(1), jnp.zeros((1, *HW, 3))), _batch_np()


@pytest.fixture(scope="module")
def jax_f64_step(init_and_batch):
    """JAX's step in f64: the reference of the port's f64 and f32 steps."""
    variables, b = init_and_batch
    with _jax_in_f64():
        return _jax_step(jnp.float64, _f64(variables), _f64(b), jax.random.PRNGKey(5))


@pytest.fixture(scope="module", params=["f64", "f32", "bf16"])
def one_step(request, init_and_batch, jax_f64_step):
    """The port's step in one dtype and its JAX reference (see the module
    docstring)."""
    dt = request.param
    variables, b = init_and_batch
    if dt == "bf16":
        keep, ref = _jax_step(jnp.bfloat16, variables, b, jax.random.PRNGKey(5))
    else:
        keep, ref = jax_f64_step
    tdt = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}[dt]
    tnet = _port_net(variables, tdt)
    state = th.TrainState(tnet, th.make_optimizer(tnet.parameters()))
    step = th.make_train_step(HW)
    _, m = step(state, th.to_batch(_f64(b) if dt == "f64" else b, "cpu"), EPOCH,
                dropout_mask=torch.from_numpy(keep))
    return dict(dt=dt, ref=ref, net=tnet, metrics=m)


def test_train_step_loss_and_terms_match_jax(one_step):
    tol = TOL[one_step["dt"]]["loss"]
    ref, m = one_step["ref"], one_step["metrics"]
    assert abs(float(m["loss"]) - ref["loss"]) <= tol * abs(ref["loss"]), (
        float(m["loss"]), ref["loss"])
    for k, want in ref["aux"].items():
        assert abs(float(m[k]) - want) <= tol * max(abs(want), 1e-3), (k, float(m[k]), want)


def _conv_biases(named):
    """Biases of the convolutions that feed a batch norm (all but the last
    head's): the norm removes them, so their gradient is 0."""
    last_head = f"backbone.heads.{TINY['n_stack'] - 1}.bias"
    return [k for k in named if k.endswith(".bias") and k[:-5] + ".weight" in named
            and k not in ("classifier.bias", last_head)]


def _cos(x, y):
    return float(x @ y / np.linalg.norm(x) / np.linalg.norm(y))


def test_train_step_gradients_match_jax(one_step):
    dt, ref = one_step["dt"], one_step["ref"]
    if dt == "bf16":  # bf16 does not decide the train-mode gradients (docstring)
        _check_fixed_statistics_bf16_gradients()
        return
    tol = TOL[dt]
    named = dict(one_step["net"].named_parameters())
    want = ref["grads"]
    assert set(named) <= set(want)
    port = {k: p.grad.double().numpy() for k, p in named.items()}
    biases = _conv_biases(named)
    for k in biases:
        w = np.abs(want[k[:-5] + ".weight"]).max()
        assert np.abs(port[k]).max() <= tol["zero"] * w, k
    keys = [k for k in named if k not in biases]
    worst = max((_rel(port[k], want[k]), k) for k in keys)
    assert worst[0] <= tol["grad"], worst
    if "cos" in tol:
        cat = lambda g: np.concatenate([np.asarray(g[k], np.float64).ravel() for k in keys])
        assert _cos(cat(port), cat(want)) >= tol["cos"]


def test_train_step_running_statistics_match_jax(one_step):
    want = one_step["ref"]["stats"]
    sd = {k: v.double().numpy() for k, v in one_step["net"].state_dict().items()}
    keys = [k for k in want if k.endswith((".mean", ".var"))]
    worst = max((np.abs(sd[k] - want[k]).max() / max(np.abs(want[k]).max(), 1.0), k)
                for k in keys)
    assert worst[0] <= TOL[one_step["dt"]]["stats"], worst


def _fixed_statistics_case(jdt):
    """JAX's loss and gradients of the whole net with fixed (running)
    statistics, as `make_eval_step` runs it but with gradients."""
    net = JaxPkpNet(**TINY, dtype=jdt)
    v = net.init(jax.random.PRNGKey(4), jnp.zeros((1, *HW, 3)))
    rng = np.random.default_rng(0)
    v = {"params": v["params"], "batch_stats": jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        v["batch_stats"])}
    b = _batch_np(2)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jh._forward_loss(net, p, v["batch_stats"], _jbatch(b), jnp.asarray(EPOCH),
                                   jax.random.PRNGKey(0), False, HW), has_aux=True))(
        v["params"])
    return v, b, float(loss), _flat(grads, None, v)


def test_fixed_statistics_net_gradients_match_jax():
    """The whole net with fixed (running) statistics: K8's backward is K17
    with the statistics' terms off, K9's K18, K2's K19 — a well-conditioned
    computation, held to 1e-5 (loss) and 1e-4 of each gradient's largest
    magnitude."""
    v, b, loss, want = _fixed_statistics_case(jnp.float32)
    tnet = _port_net(v, torch.float32)
    lt, _ = th.forward_loss(tnet, th.to_batch(b, "cpu"), EPOCH, False, HW)
    lt.backward()
    assert abs(float(lt.detach()) - loss) <= 1e-5 * abs(loss)
    worst = max((_rel(p.grad.numpy(), want[k].numpy()), k) for k, p in tnet.named_parameters())
    assert worst[0] <= 1e-4, worst


def _check_fixed_statistics_bf16_gradients():
    """The whole net with fixed statistics in bf16 (activations rounded to
    bf16 after every operation, the norms and heads in f32): the loss within
    1e-2 relative and the whole gradient's cosine with JAX's at least 0.99,
    the biases the norms remove left out."""
    v, b, loss, want = _fixed_statistics_case(jnp.bfloat16)
    tnet = _port_net(v, torch.bfloat16)
    lt, _ = th.forward_loss(tnet, th.to_batch(b, "cpu"), EPOCH, False, HW)
    lt.backward()
    assert abs(float(lt.detach()) - loss) <= 1e-2 * abs(loss)
    named = dict(tnet.named_parameters())
    keys = [k for k in named if k not in _conv_biases(named)]
    cat = lambda g: np.concatenate([np.asarray(g[k], np.float64).ravel() for k in keys])
    cos = _cos(cat({k: named[k].grad.double().numpy() for k in keys}),
               cat({k: want[k].numpy() for k in keys}))
    assert cos >= 0.99, cos


@pytest.mark.parametrize("with_cov", [True, False])
def test_losses_match_jax_value_and_gradient(with_cov):
    rng = np.random.default_rng(2)
    N, H, W, K = 3, 8, 8, 41
    uv = rng.uniform(-1, 1, (N, K, 2)).astype(np.float32)
    a = rng.uniform(0.01, 0.2, (N, K)).astype(np.float32)
    cov = np.stack([np.stack([a, a * 0.3], -1), np.stack([a * 0.3, a * 1.5], -1)], -2)
    prob = jax.nn.softmax(jnp.asarray(rng.normal(size=(N, H * W, K)).astype(np.float32)), 1)
    prob = np.asarray(prob).reshape(N, H, W, K)
    logits = rng.normal(size=(N, K)).astype(np.float32) * 3
    uv_gt = rng.uniform(-1, 1, (N, K, 2)).astype(np.float32)
    mask = rng.uniform(size=(N, K)) < 0.5
    args = (uv, cov if with_cov else None, prob, logits)

    def jf(uv, cov, prob, logits):
        return jl.total_loss(uv, cov, prob, logits, jnp.asarray(uv_gt), jnp.asarray(mask),
                             EPOCH)

    (lj, auxj), gj = jax.value_and_grad(jf, argnums=(0, 2, 3), has_aux=True)(
        *(None if x is None else jnp.asarray(x) for x in args))
    ts = [None if x is None else torch.tensor(x, requires_grad=True) for x in args]
    # the port's no-covariance loss takes the spread term; from prob here
    spread = lambda t: t[2] if with_cov else thm.heatmap_variance(t[2], t[0])
    lt, auxt = tl.total_loss(ts[0], ts[1], spread(ts), ts[3], torch.from_numpy(uv_gt),
                             torch.from_numpy(mask), EPOCH)
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    for k in auxj:
        assert abs(float(auxt[k]) - float(auxj[k])) <= 1e-5 * max(abs(float(auxj[k])), 1e-3), k
    for t, g in zip((ts[0], ts[2], ts[3]), gj):
        if t.grad is None:  # prob does not enter the covariance loss
            assert not np.asarray(g).any()
        else:
            assert _rel(t.grad.numpy(), np.asarray(g)) <= 1e-5
    empty = torch.zeros(N, K, dtype=torch.bool)  # no labeled channel: every term 0
    td = [t.detach() if t is not None else None for t in ts]
    lz, _ = tl.total_loss(td[0], td[1], spread(td), td[3], torch.from_numpy(uv_gt), empty, EPOCH)
    assert float(lz) == 0.0


def test_adam_matches_optax_on_equal_gradients():
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    opt = optax.adam(1e-3)
    pj, sj = {k: jnp.asarray(v) for k, v in params.items()}, None
    sj = opt.init(pj)
    pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    ot = th.make_optimizer(list(pt.values()))
    for i in range(4):
        g = {k: (rng.normal(size=s) * 10.0 ** rng.uniform(-8, 1)).astype(np.float32)
             for k, s in shapes.items()}
        upd, sj = opt.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, upd)
        for k, p in pt.items():
            p.grad = torch.from_numpy(g[k])
        ot.step()
        for k in shapes:
            np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]), rtol=0,
                                       atol=2e-7, err_msg=f"step {i} {k}")
    adam_state = sj[0]
    for k, p in pt.items():
        st = ot.state[p]
        assert int(st["step"]) == int(adam_state.count)
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam_state.mu[k]),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam_state.nu[k]),
                                   rtol=1e-6, atol=1e-20)


def test_adam_state_maps_onto_optax_tree():
    """`adam_to_optax` / `adam_from_optax` on the net's parameters: the tree
    has optax's structure (as flax serializes it) and round-trips."""
    from flax import serialization

    jnet = JaxPkpNet(**TINY)
    variables = jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, *HW, 3)))
    want = serialization.to_state_dict(optax.adam(1e-3).init(variables["params"]))
    net = _port_net(variables, torch.float32)
    opt = th.make_optimizer(net.parameters())
    tree = convert.adam_to_optax(net, opt)
    same = jax.tree.structure(jax.tree.map(np.asarray, want))
    assert jax.tree.structure(tree) == same
    for p in net.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    tree = convert.adam_to_optax(net, opt)
    assert int(tree["0"]["count"]) == 1 and tree["0"]["count"].dtype == np.int32
    opt2 = th.make_optimizer(net.parameters())
    convert.adam_from_optax(net, opt2, tree)
    for p in net.parameters():
        a, b = opt.state[p], opt2.state[p]
        assert int(a["step"]) == int(b["step"])
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


def test_three_step_loss_trajectory_matches_jax():
    net = JaxPkpNet(**TINY)
    variables = net.init(jax.random.PRNGKey(3), jnp.zeros((1, *HW, 3)))
    opt = optax.adam(1e-3)
    state = jh.TrainState(variables["params"], variables["batch_stats"],
                          opt.init(variables["params"]), jnp.zeros((), jnp.int32),
                          jax.random.PRNGKey(9))
    jstep = jax.jit(jh.make_train_step(net, opt, input_hw=HW))
    b = _batch_np(1)
    jb = _jbatch(b)
    tnet = _port_net(variables, torch.float32)
    ts = th.TrainState(tnet, th.make_optimizer(tnet.parameters()))
    tstep = th.make_train_step(HW)
    tb = th.to_batch(b, "cpu")
    lj, lt = [], []
    for _ in range(3):
        _, key = jax.random.split(state.rng)
        keep = _jax_dropout_keep(net, {"params": state.params, "batch_stats": state.batch_stats},
                                 jb, key)
        state, m = jstep(state, jb, jnp.asarray(EPOCH))
        ts, mt = tstep(ts, tb, EPOCH, dropout_mask=torch.from_numpy(keep))
        lj.append(float(m["loss"]))
        lt.append(float(mt["loss"]))
    np.testing.assert_allclose(lt, lj, rtol=1e-2)
    assert lj[2] < 0.9 * lj[0] and lt[2] < 0.9 * lt[0]
