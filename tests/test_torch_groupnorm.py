"""The GroupNorm PkpNet (`norm="group"`, ROADMAP A18) against the JAX
package's, on the CPU (K20 and K21 through their plain versions).

- one norm + ReLU (`GroupNormRelu`) against flax's `Norm(kind="group")` and
  `nn.relu`: within 1e-5 of the output's largest magnitude in f32 (measured
  6e-7), one bf16 ulp of it in bf16; at group sizes 1 to 8;
- the plain K20 / K21 against `F.group_norm` + relu and its autograd in f64
  (1e-12): the forward, dx, dscale and dbias;
- the whole net's forward in f64 on both sides (JAX traced with f64 where it
  names f32): each output within 1e-9 of its largest magnitude (measured
  2e-12), the composition; in f32 within 5e-3 of JAX's f64 forward, a bound
  f32 decides: flax's fast variance E[x^2] - E[x]^2 in f32 cancels in the
  small groups of this narrow net's coarse levels (one channel of 2x2
  pixels), and JAX's own f32 forward lies 4e-4 from its f64 one;
- one train step (the method of `tests/test_torch_train_step.py`): in f64
  on both sides, loss and terms within 1e-8 relative (measured 7e-10: this
  net's coarsest groups hold one value at 64x64 crops, so var = 0 and
  rstd = 1 / sqrt(1e-6) = 1000 amplify the last bits) and every gradient
  within 1e-9 of its tensor's largest magnitude (a gradient that is 0 in
  exact arithmetic — a convolution bias that a norm of single-channel groups
  removes — within 1e-10 of the net's largest gradient, 1e-4 in f32); in
  f32 against JAX's f64
  step within the fixed bounds of the BatchNorm net's f32 step (loss and
  terms 1e-3, each gradient 0.5 of its largest magnitude, the whole
  gradient's cosine 0.99); in bf16 against JAX's bf16 step, loss and terms
  within 0.2 relative;
- checkpoints: a JAX `norm="group"` checkpoint restores in the port and is
  written back byte-equal; the training CLI with `--norm group` writes
  checkpoints (empty `batch_stats`) that the JAX package's
  `load_model_only` reads and the port's evaluation loader builds a group
  net from; `--int8` with a group net raises.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from suo_slam_tpu.models.hourglass import Norm as JaxNorm
from suo_slam_tpu.models.pkpnet import PkpNet as JaxPkpNet
from suo_slam_tpu.train import checkpoint as jck
from suo_slam_tpu.train import harness as jh
from suo_slam_tpu_torch.models import convert
from suo_slam_tpu_torch.models import hourglass as hg
from suo_slam_tpu_torch.models.pkpnet import PkpNet
from suo_slam_tpu_torch.train import checkpoint as tck
from suo_slam_tpu_torch.train import harness as th
from tests.helpers.synthetic_bop import write_synthetic_bop
from tests.test_torch_train_step import (EPOCH, HW, _batch_np, _f64, _jax_dropout_keep,
                                         _jax_in_f64, _jbatch, _rel)

NET = dict(n_stack=2, n_modules=1, features=32, norm="group")
STEP_NET = dict(n_stack=2, n_modules=1, features=16, norm="group")
CL = torch.channels_last


def _cl(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """NHWC numpy -> NCHW channels_last."""
    return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=CL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [16, 64, 256])
def test_group_norm_relu_matches_flax(C, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(C)
    x = jnp.asarray((rng.normal(size=(3, 16, 16, C)) * 2 + 0.5).astype(np.float32)).astype(jdt)
    m = JaxNorm("group")
    p = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
         "bias": rng.normal(0.0, 0.2, C).astype(np.float32)}
    want = np.asarray(jax.nn.relu(m.apply({"params": {"GroupNorm_0": p}}, x)).astype(jnp.float32))
    gn = hg.GroupNormRelu(C)
    assert gn.groups == min(32, C)
    with torch.no_grad():
        gn.scale.copy_(torch.from_numpy(p["scale"]))
        gn.bias.copy_(torch.from_numpy(p["bias"]))
        got = gn(_cl(np.asarray(x.astype(jnp.float32)), tdt))
    assert got.dtype == tdt and got.is_contiguous(memory_format=CL)
    got = got.permute(0, 2, 3, 1).float().numpy()
    tol = 1e-5 if dtype == "f32" else 2.0 ** -8
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_plain_k20_k21_match_torch_group_norm():
    """f64: `group_norm_relu_plain` and `group_norm_relu_bwd_plain` (through
    the autograd Function) against F.group_norm + relu and its autograd."""
    g = torch.Generator().manual_seed(0)
    for C, groups in ((8, 4), (32, 32), (64, 32)):
        x = (torch.randn(3, C, 5, 6, generator=g, dtype=torch.float64) * 2 + 1).contiguous(
            memory_format=CL).requires_grad_()
        sc = (torch.rand(C, generator=g, dtype=torch.float64) + 0.5).requires_grad_()
        b = (torch.randn(C, generator=g, dtype=torch.float64) * 0.2).requires_grad_()
        y = hg._GroupNormRelu.apply(x, sc, b, groups, hg.GN_EPS)
        ref = torch.relu(F.group_norm(x, groups, sc, b, hg.GN_EPS))
        assert (y - ref).abs().max().item() <= 1e-12
        dy = torch.randn(y.shape, generator=g, dtype=torch.float64)
        for a, r in zip(torch.autograd.grad(y, (x, sc, b), dy),
                        torch.autograd.grad(ref, (x, sc, b), dy)):
            assert (a - r).abs().max().item() <= 1e-12 * max(r.abs().max().item(), 1.0)


@pytest.fixture(scope="module")
def group_net_variables():
    """flax-initialised group net with non-trivial norm and conv biases,
    three crops and JAX's forward of them in f64."""
    v = jax.tree.map(np.asarray, JaxPkpNet(**NET).init(jax.random.PRNGKey(0),
                                                       jnp.zeros((1, 64, 64, 3))))
    assert sorted(v) == ["params"]
    rng = np.random.default_rng(3)

    def perturb(path, a):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "bias":
            return (a + rng.normal(0.0, 0.05, a.shape)).astype(np.float32)
        return a

    v = {"params": jax.tree_util.tree_map_with_path(perturb, v["params"])}
    x = np.random.default_rng(4).uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    with _jax_in_f64():  # the reference of both the f64 and the f32 forward
        want = JaxPkpNet(**NET, dtype=jnp.float64).apply(_f64(v), x.astype(np.float64))
    return v, x, want


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_group_net_forward_matches_jax(group_net_variables, dtype):
    v, x, want = group_net_variables
    cfg = convert.backbone_config(v)
    assert cfg["norm"] == "group"
    tdt = torch.float64 if dtype == "f64" else torch.float32
    net = PkpNet(**cfg, dtype=tdt).to(tdt)
    net.load_state_dict(convert.from_jax_variables(v, np.float64 if dtype == "f64"
                                                   else np.float32), strict=True)
    net = net.eval().to(memory_format=CL)
    assert all(isinstance(m, hg.GroupNormRelu) for m in net.modules()
               if isinstance(m, (hg.GroupNormRelu, hg.MaskedBatchNorm)))
    with torch.no_grad():
        got = net(torch.from_numpy(x).to(tdt))
    tol = 1e-9 if dtype == "f64" else 5e-3
    for k in ("uv", "cov", "kp_mask", "prob_logits"):
        assert _rel(getattr(got, k).numpy(), getattr(want, k)) <= tol, k
    back = convert.to_jax_variables(net)
    assert sorted(back) == ["params"]
    assert jax.tree.structure(back) == jax.tree.structure(v)


def _port_step_net(variables, dtype):
    net = PkpNet(**STEP_NET, dtype=dtype)
    f64 = dtype == torch.float64
    sd = convert.from_jax_variables(variables, np.float64 if f64 else np.float32)
    if f64:
        net = net.double()
    net.load_state_dict(sd, strict=True)
    return net.to(memory_format=CL)


def _jax_group_step(jdt, variables, b, key):
    """JAX's group-net train step: its dropout keep mask, (loss, aux) and the
    gradients under the port's names."""
    net = JaxPkpNet(**STEP_NET, dtype=jdt)
    jb = _jbatch(b)
    keep = _jax_dropout_keep(net, variables, jb, key)

    @jax.jit
    def f(params):
        (loss, (aux, stats)), grads = jax.value_and_grad(
            lambda p: jh._forward_loss(net, p, {}, jb, jnp.asarray(EPOCH), key, True, HW),
            has_aux=True)(params)
        return loss, aux, stats, grads

    loss, aux, stats, grads = f(variables["params"])
    assert not stats  # a group net keeps no running statistics
    npd = np.float64 if jdt == jnp.float64 else np.float32
    flat = convert.from_jax_variables(jax.tree.map(np.asarray, {"params": grads}), npd)
    return keep, dict(loss=float(loss), aux={k: float(a) for k, a in aux.items()},
                      grads={k: t.numpy() for k, t in flat.items()})


@pytest.fixture(scope="module")
def group_step_case():
    variables = jax.tree.map(np.asarray, JaxPkpNet(**STEP_NET).init(
        jax.random.PRNGKey(1), jnp.zeros((1, *HW, 3))))
    b = _batch_np()
    with _jax_in_f64():
        ref64 = _jax_group_step(jnp.float64, _f64(variables), _f64(b), jax.random.PRNGKey(5))
    return variables, b, ref64


_STEP_TOL = {"f64": dict(loss=1e-8, grad=1e-9, zero=1e-10),
             "f32": dict(loss=1e-3, grad=0.5, cos=0.99, zero=1e-4),
             "bf16": dict(loss=0.2)}


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_group_train_step_matches_jax(group_step_case, dtype):
    variables, b, ref64 = group_step_case
    if dtype == "bf16":
        keep, ref = _jax_group_step(jnp.bfloat16, variables, b, jax.random.PRNGKey(5))
    else:
        keep, ref = ref64
    tdt = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    net = _port_step_net(variables, tdt)
    state = th.TrainState(net, th.make_optimizer(net.parameters()))
    _, m = th.make_train_step(HW)(state, th.to_batch(_f64(b) if dtype == "f64" else b, "cpu"),
                                  EPOCH, dropout_mask=torch.from_numpy(keep))
    tol = _STEP_TOL[dtype]
    assert abs(float(m["loss"]) - ref["loss"]) <= tol["loss"] * abs(ref["loss"])
    for k, want in ref["aux"].items():
        assert abs(float(m[k]) - want) <= tol["loss"] * max(abs(want), 1e-3), k
    if "grad" not in tol:
        return
    named = dict(net.named_parameters())
    want = ref["grads"]
    assert set(named) == set(want)
    port = {k: p.grad.double().numpy() for k, p in named.items()}
    # tensors whose gradient is 0 in exact arithmetic (a convolution bias
    # that a norm of single-channel groups removes, and what feeds only a
    # constant into such a group): rounding noise on both sides, held
    # against the largest gradient of the net
    gmax = max(np.abs(w).max() for w in want.values())
    zero = [k for k in named if np.abs(want[k]).max() <= 1e-10 * gmax]
    assert zero
    for k in zero:
        assert np.abs(port[k]).max() <= tol["zero"] * gmax, k
    keys = [k for k in named if k not in zero]
    worst = max((_rel(port[k], want[k]), k) for k in keys)
    assert worst[0] <= tol["grad"], worst
    if "cos" in tol:
        cat = lambda g: np.concatenate([np.asarray(g[k], np.float64).ravel() for k in keys])
        a, c = cat(port), cat(want)
        assert a @ c / np.linalg.norm(a) / np.linalg.norm(c) >= tol["cos"]


TINY_CLI = dict(n_stack=1, n_modules=1, features=16)  # SUO_TINY_NET
ARGS = {"norm": "group", "no_network_cov": False, "dataset": "ycbv", "lr": 1e-3}


def test_jax_group_checkpoint_round_trips_byte_equal(tmp_path):
    net = JaxPkpNet(**TINY_CLI, norm="group")
    st = jh.init_state(net, jax.random.PRNGKey(0), optax.adam(1e-3), input_hw=(64, 64))
    assert st.batch_stats == {}
    rng = np.random.default_rng(1)
    st = st._replace(params=jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), st.params),
        step=jnp.asarray(2, jnp.int32))
    jck.save_checkpoint(str(tmp_path / "jax"), st, 4, ARGS, 0.5)
    path = str(tmp_path / "jax" / "checkpoint-4")
    port = PkpNet(**TINY_CLI, norm="group")
    state, epoch, args, _, _ = tck.load_checkpoint(path, th.TrainState(
        port, th.make_optimizer(port.parameters())))
    assert (epoch, args, state.step) == (4, ARGS, 2)
    tck.save_checkpoint(str(tmp_path / "port"), state, 4, ARGS, 0.5)
    with open(path, "rb") as f, open(tmp_path / "port" / "checkpoint-4", "rb") as g:
        assert f.read() == g.read()


def test_training_cli_trains_a_group_net(tmp_path, monkeypatch):
    from suo_slam_tpu_torch import evaluate as port_evaluate
    from suo_slam_tpu_torch.eval import loading
    from suo_slam_tpu_torch.train import __main__ as cli

    root = str(tmp_path / "bop_datasets" / "ycbv")
    write_synthetic_bop(root, n_scenes=1, n_views=10, splits=("train_real", "test"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SUO_TINY_NET", "1")
    argv = ["--device", "cpu", "--dataset", "ycbv", "--data_split", "real", "--norm", "group",
            "--no_augmentations", "--no_bf16", "--batch_size", "1", "--truncate_obj", "3",
            "--steps_per_epoch", "2", "--val_steps", "1", "--workers", "1", "--epochs", "1",
            "--data_root", root, "--kp_config_root", os.path.join(root, "kp_configs")]
    assert cli.main(argv) == 0
    (outdir,) = (tmp_path / "results").iterdir()
    ck = str(outdir / "checkpoint-latest")
    assert json.loads(open(ck + ".meta.json").read())["args"]["norm"] == "group"
    template = JaxPkpNet(**TINY_CLI, norm="group").init(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 256, 256, 3)))
    variables, epoch, args = jck.load_model_only(ck, template)
    assert epoch == 0 and args["norm"] == "group" and sorted(variables) == ["params"]
    net, epoch = loading.load_eval_network(ck, bf16=False, norm="batch")  # the tree wins
    assert net.norm == "group" and epoch == 0
    mine = convert.to_jax_variables(net)["params"]
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jax.tree.map(np.asarray, variables))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit, match="norm='group'"):
        port_evaluate.Evaluator("ycbv", root, ck, nviews=1, detection_type="gt", int8=True,
                                no_viz=True, device="cpu",
                                kp_config_root=os.path.join(root, "kp_configs"))
