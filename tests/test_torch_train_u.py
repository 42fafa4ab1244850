"""`-u` training (no covariance head: the L2 + heatmap-variance loss) in the
port against the JAX package's, on the CPU with a tiny net (1 stack x 1
module x 16 features; the batch of `tests/test_torch_train_step.py`: 64x64
crops, a padded object slot, JAX's own dropout mask).

JAX forms the softmax maps and `heatmap_variance(prob, uv)`; the port takes
the same spread term from the readout's covariance, cuu + cvv - 2 min_var
(`heatmap.readout_spread`), so the backward is the readout's (K19 on the
card) with the term's gradient on g_cov's diagonal, and no probability map.

- the spread equals JAX's `heatmap_variance` of the softmax maps at uv =
  E[p] (f32: 1e-5 of the largest), and its gradient through the readout
  equals JAX's vjp (1e-5 of the largest);
- the train-mode step in f64 on both sides (the composition; see
  `tests/test_torch_train_step.py` for why f32 does not decide the
  train-mode gradients): loss and terms 1e-10 relative (measured 7e-14),
  every gradient 1e-9 of its tensor's largest magnitude (1.2e-12), the
  whole gradient's cosine at least 0.999, the new statistics 1e-10;
- the f32 train-mode step against that f64 step: loss and terms 1e-5
  relative (measured 2.8e-6 at worst, the mask term), the whole gradient's
  cosine at least 0.999 (0.999998), each gradient within the f32 step
  test's bound (0.5 of its largest magnitude; measured 0.0098);
- the training CLI with `-u` and augmentations on the CPU records
  `no_network_cov` in its checkpoint, which the evaluation loader reads
  into a net without the covariance output (chip_smoke's phase 9 runs the
  CLI with `--loader process` and the checkpoint through `Evaluator`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.models.pkpnet import PkpNet as JaxPkpNet
from suo_slam_tpu.ops import heatmap as jhm
from suo_slam_tpu_torch.models import convert
from suo_slam_tpu_torch.models.pkpnet import PkpNet
from suo_slam_tpu_torch.ops import heatmap as thm
from suo_slam_tpu_torch.train import harness as th
from tests.helpers.synthetic_bop import write_synthetic_bop
from tests.helpers.threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_train_step import (EPOCH, HW, _batch_np, _cos, _f64, _flat, _jax_in_f64,
                                         _jax_step_grads, _jbatch, _keep_jit, _rel)

U = dict(n_stack=1, n_modules=1, features=16, calc_cov=False)


def _conv_biases(named):
    """Biases of the convolutions that feed a batch norm (all but the head's
    and the classifier's): their gradient is 0."""
    return [k for k in named if k.endswith(".bias") and k[:-5] + ".weight" in named
            and k not in ("classifier.bias", "backbone.heads.0.bias")]


def _port_net(variables, dtype):
    net = PkpNet(**U, dtype=dtype)
    f64 = dtype == torch.float64
    sd = convert.from_jax_variables(jax.tree.map(np.asarray, variables),
                                    np.float64 if f64 else np.float32)
    if f64:
        net = net.double()
    net.load_state_dict(sd)
    return net.to(memory_format=torch.channels_last)


def _jax_u_step(jdt, variables, b, key):
    """JAX's -u train step: its dropout keep mask and (loss, aux, gradients,
    new statistics) under the port's names."""
    net = JaxPkpNet(**U, dtype=jdt)
    jb = _jbatch(b)
    keep = np.asarray(_keep_jit(net, variables, jb, key))
    loss, aux, stats, grads = _jax_step_grads(net, variables, key, jb)(variables["params"])
    npd = np.float64 if jdt == jnp.float64 else np.float32
    return keep, dict(loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                      grads={k: v.numpy() for k, v in _flat(grads, variables["batch_stats"],
                                                            variables, npd).items()},
                      stats={k: v.numpy() for k, v in _flat(None, stats, variables,
                                                            npd).items()})


@pytest.fixture(scope="module")
def init_and_batch():
    """flax-style initial variables (the port's `init_like_flax`, as a flax
    tree: no JAX init to compile) and the batch."""
    net = PkpNet(**U)
    th.init_state(net, seed=1)
    variables = jax.tree.map(jnp.asarray, convert.to_jax_variables(net))
    return variables, _batch_np()


@pytest.fixture(scope="module")
def jax_f64(init_and_batch):
    variables, b = init_and_batch
    with _jax_in_f64():
        return _jax_u_step(jnp.float64, _f64(variables), _f64(b), jax.random.PRNGKey(5))


@pytest.fixture(scope="module", params=["f64", "f32"])
def port_step(request, init_and_batch, jax_f64):
    variables, b = init_and_batch
    keep, ref = jax_f64
    dt = {"f64": torch.float64, "f32": torch.float32}[request.param]
    net = _port_net(variables, dt)
    state = th.TrainState(net, th.make_optimizer(net.parameters()))
    _, m = th.make_train_step(HW)(state, th.to_batch(_f64(b) if dt == torch.float64 else b,
                                                      "cpu"), EPOCH,
                                  dropout_mask=torch.from_numpy(keep.copy()))
    return request.param, ref, net, m


TOL = {"f64": dict(loss=1e-10, grad=1e-9, stats=1e-10, zero=1e-10),
       "f32": dict(loss=1e-5, grad=0.5, stats=1e-3, zero=1e-4)}


def test_spread_equals_jax_heatmap_variance_and_its_gradient():
    rng = np.random.default_rng(7)
    N, H, W, K = 3, 16, 16, 41
    logits = (rng.normal(size=(N, H, W, K)) * 3).astype(np.float32)
    g = rng.normal(size=(N, K)).astype(np.float32)

    def jvar(lg):
        prob = jhm.spatial_softmax(lg)
        uv, _ = jhm.soft_argmax(prob, calc_cov=False)
        return jhm.heatmap_variance(prob, uv)

    want, vjp = jax.vjp(jvar, jnp.asarray(logits))
    (gwant,) = vjp(jnp.asarray(g))
    lt = torch.tensor(logits, requires_grad=True)
    _, cov, _ = thm.heatmap_readout(lt)
    got = thm.readout_spread(cov)
    got.backward(torch.from_numpy(g))
    assert _rel(got.detach().numpy(), np.asarray(want)) <= 1e-5
    assert _rel(lt.grad.numpy(), np.asarray(gwant)) <= 1e-5


def test_u_train_step_loss_and_terms_match_jax(port_step):
    dt, ref, _, m = port_step
    tol = TOL[dt]["loss"]
    assert abs(float(m["loss"]) - ref["loss"]) <= tol * abs(ref["loss"])
    for k, want in ref["aux"].items():
        assert abs(float(m[k]) - want) <= tol * max(abs(want), 1e-3), (k, float(m[k]), want)


def test_u_train_step_gradients_and_statistics_match_jax(port_step):
    dt, ref, net, _ = port_step
    tol = TOL[dt]
    named = dict(net.named_parameters())
    port = {k: p.grad.double().numpy() for k, p in named.items()}
    biases = _conv_biases(named)
    for k in biases:
        assert np.abs(port[k]).max() <= tol["zero"] * np.abs(ref["grads"][k[:-5] + ".weight"]).max()
    keys = [k for k in named if k not in biases]
    worst = max((_rel(port[k], ref["grads"][k]), k) for k in keys)
    assert worst[0] <= tol["grad"], worst
    cat = lambda g: np.concatenate([np.asarray(g[k], np.float64).ravel() for k in keys])
    assert _cos(cat(port), cat(ref["grads"])) >= 0.999
    sd = {k: v.double().numpy() for k, v in net.state_dict().items()}
    want = ref["stats"]
    worst = max(np.abs(sd[k] - want[k]).max() / max(np.abs(want[k]).max(), 1.0)
                for k in want if k.endswith((".mean", ".var")))
    assert worst <= tol["stats"]


def test_u_cli_with_augmentations(tmp_path, monkeypatch):
    from suo_slam_tpu_torch.eval.loading import load_eval_network
    from suo_slam_tpu_torch.train import __main__ as cli
    from suo_slam_tpu_torch.train import checkpoint as ck

    root = str(tmp_path / "bop_datasets" / "ycbv")
    write_synthetic_bop(root, n_scenes=1, n_views=10, hw=(96, 128), splits=("train_real",),
                        obj2_continuous_sym=False)
    monkeypatch.setenv("SUO_TINY_NET", "1")
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["--device", "cpu", "--dataset", "ycbv", "--data_split", "real", "-u",
                   "--workers", "1", "--epochs", "1", "--steps_per_epoch", "1", "--no_val",
                   "--no_bf16", "--truncate_obj", "3", "--data_root", root,
                   "--kp_config_root", os.path.join(root, "kp_configs")])
    assert rc == 0
    (run,) = os.listdir(tmp_path / "results")
    path = str(tmp_path / "results" / run / "checkpoint-latest")
    assert ck.peek_checkpoint_args(path)["no_network_cov"] is True
    net, epoch = load_eval_network(path, bf16=False, no_network_cov=True)
    out = net.eval()(torch.zeros(1, *HW, 3))
    assert epoch == 0 and out.cov is None and out.spread.shape == (1, 41)
