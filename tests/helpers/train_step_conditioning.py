"""How far rounding moves the train step of `tests/test_torch_train_step.py`
(the tiny net, its batch, parameters and dropout mask), on the CPU:

- the port's f32 step: its gradients' distance under a relative change of
  1e-6 in the input frames (each tensor against its largest magnitude,
  median and worst over the tensors, and the whole gradient's cosine);
- the port's f64 step, JAX's f32 and bf16 steps and the port's against
  JAX's step in f64 (and the port's bf16 step against JAX's): loss, terms,
  running statistics and gradients.

Run from the repository's root: `python -m tests.helpers.train_step_conditioning`.
"""

import numpy as np

import tests.conftest  # noqa: F401  (JAX on the CPU with f64, as the tests run it)
import jax
import jax.numpy as jnp
import torch

# the compiler mode of the tier-1 run (`-m 'not slow'`, tests/conftest.py)
jax.config.update("jax_disable_most_optimizations", True)

from tests import test_torch_train_step as T
from suo_slam_tpu_torch.train import harness as th


def _port_step(variables, b, keep, dtype, noise=0.0):
    tnet = T._port_net(variables, dtype)
    batch = th.to_batch(b, "cpu")
    if noise:
        g = torch.Generator().manual_seed(3)
        batch = batch._replace(images=batch.images * (
            1 + noise * torch.randn(batch.images.shape, generator=g, dtype=batch.images.dtype)))
    state = th.TrainState(tnet, th.make_optimizer(tnet.parameters()))
    _, m = th.make_train_step(T.HW)(state, batch, T.EPOCH, dropout_mask=torch.from_numpy(keep))
    return dict(loss=float(m["loss"]), aux={k: float(v) for k, v in m.items() if k != "loss"},
                grads={k: p.grad.double().numpy() for k, p in tnet.named_parameters()},
                stats={k: v.double().numpy() for k, v in tnet.state_dict().items()})


def _distances(a, ref, keys):
    g = sorted(T._rel(a["grads"][k], ref["grads"][k]) for k in keys)
    cat = lambda d: np.concatenate([np.asarray(d["grads"][k], np.float64).ravel() for k in keys])
    stats = max(np.abs(a["stats"][k] - v).max() / max(np.abs(v).max(), 1.0)
                for k, v in ref["stats"].items() if k.endswith((".mean", ".var")))
    return dict(loss=abs(a["loss"] - ref["loss"]) / abs(ref["loss"]),
                terms=max(abs(a["aux"][k] - v) / max(abs(v), 1e-3) for k, v in ref["aux"].items()),
                stats=stats, grad_median=g[len(g) // 2], grad_worst=g[-1],
                cos=T._cos(cat(a), cat(ref)))


def main():
    net = T.JaxPkpNet(**T.TINY)
    variables = net.init(jax.random.PRNGKey(1), jnp.zeros((1, *T.HW, 3)))
    b, key = T._batch_np(), jax.random.PRNGKey(5)
    with T._jax_in_f64():
        keep, ref = T._jax_step(jnp.float64, T._f64(variables), T._f64(b), key)
    _, jax32 = T._jax_step(jnp.float32, variables, b, key)
    keep16, jax16 = T._jax_step(jnp.bfloat16, variables, b, key)
    port32 = _port_step(variables, b, keep, torch.float32)
    named = dict(T._port_net(variables, torch.float32).named_parameters())
    keys = [k for k in named if k not in T._conv_biases(named)]
    fmt = lambda d: ", ".join(f"{k} {v:.3g}" for k, v in d.items())
    moved = _distances(_port_step(variables, b, keep, torch.float32, noise=1e-6), port32, keys)
    print(f"port f32 under 1e-6 input noise: {fmt(moved)}")
    port16 = _port_step(variables, b, keep16, torch.bfloat16)
    port64 = _port_step(variables, T._f64(b), keep, torch.float64)
    for name, run in (("port f64", port64), ("JAX f32", jax32), ("port f32", port32),
                      ("JAX bf16", jax16), ("port bf16", port16)):
        print(f"{name} vs JAX f64: {fmt(_distances(run, ref, keys))}")
    print(f"port bf16 vs JAX bf16: {fmt(_distances(port16, jax16, keys))}")


if __name__ == "__main__":
    main()
