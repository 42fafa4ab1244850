"""Port parity for PkpNet: flax weights carried across by
`models.convert.from_jax_variables` (random batch_stats), the same numpy crops
through both nets. Tolerance 2e-4 on uv, cov and kp_mask, as in
tests/test_torch_convert.py (two f32 conv stacks summing in different
orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.models import PkpNet as JaxPkpNet
from suo_slam_tpu_torch.models.convert import backbone_config, from_jax_variables
from suo_slam_tpu_torch.models.pkpnet import PkpNet

TOL = 2e-4


def _variables(net, hw, seed=0):
    v = net.init(jax.random.PRNGKey(seed), jnp.zeros((1,) + hw + (3,)))
    v = jax.tree.map(np.asarray, v)
    rng = np.random.default_rng(seed)

    def stats(path, a):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0.0, 0.2, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    # non-trivial affine too, so a wrong scale/bias mapping cannot hide
    def params(path, a):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "bias":
            return (a + rng.normal(0.0, 0.05, a.shape)).astype(np.float32)
        return a

    return {"params": jax.tree_util.tree_map_with_path(params, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stats, v["batch_stats"])}


def _pair(prior_mode, transpose=False, n_modules=1, features=32, hw=(64, 64)):
    jnet = JaxPkpNet(n_stack=2, n_modules=n_modules, features=features,
                     prior_mode=prior_mode, transpose_heatmaps=transpose)
    v = _variables(jnet, hw)
    cfg = backbone_config(v)
    assert cfg["prior_mode"] == prior_mode and cfg["n_modules"] == n_modules
    tnet = PkpNet(**cfg, transpose_heatmaps=transpose)
    tnet.load_state_dict(from_jax_variables(v), strict=True)
    return jnet, v, tnet.eval()


def _compare(out_j, out_t):
    for name in ("uv", "cov", "kp_mask"):
        np.testing.assert_allclose(np.asarray(getattr(out_j, name)),
                                   getattr(out_t, name).numpy(), atol=TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("prior_mode,transpose",
                         [("post_stem", False), ("post_stem", True), ("concat", False)])
def test_pkpnet_matches_jax(prior_mode, transpose):
    jnet, v, tnet = _pair(prior_mode, transpose)
    x = np.random.default_rng(3).uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    out_j = jnet.apply(v, jnp.asarray(x))
    with torch.no_grad():
        out_t = tnet(torch.from_numpy(x))
    _compare(out_j, out_t)
    np.testing.assert_allclose(np.asarray(out_j.prob_logits), out_t.prob_logits.numpy(),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("prior_mode", ["post_stem", "concat"])
def test_pkpnet_with_prior_matches_jax(prior_mode):
    jnet, v, tnet = _pair(prior_mode)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    phw = jnet.prior_hw((64, 64))
    prior = rng.uniform(0, 1, (2,) + phw + (41,)).astype(np.float32)
    out_j = jnet.apply(v, jnp.asarray(x), jnp.asarray(prior))
    with torch.no_grad():
        out_t = tnet(torch.from_numpy(x), torch.from_numpy(prior))
    _compare(out_j, out_t)


def test_prior_free_program_keeps_the_projection_bias():
    """JAX feeds a zero prior through the post-stem 1x1 projection, so its
    output carries that conv's bias. The prior-free program must match it,
    and must differ from a net whose projection bias is dropped."""
    jnet, v, tnet = _pair("post_stem")
    proj_b = tnet.backbone.extra_proj.bias
    assert float(proj_b.detach().abs().max()) > 0  # the random affine made it nonzero
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    out_j = jnet.apply(v, jnp.asarray(x))  # JAX: explicit all-zero prior
    with torch.no_grad():
        out_t = tnet(torch.from_numpy(x))  # port: prior None -> bias only
        zero = torch.zeros((2, 16, 16, 41))
        out_z = tnet(torch.from_numpy(x), zero)
        proj_b.zero_()
        out_nb = tnet(torch.from_numpy(x))
    _compare(out_j, out_t)
    np.testing.assert_allclose(out_z.uv.numpy(), out_t.uv.numpy(), atol=1e-6, rtol=0)
    assert np.abs(out_nb.prob_logits.numpy() - out_t.prob_logits.numpy()).max() > 1e-4


def _conv_bias_params(tree):
    """flax `{"params"}` tree with every Conv bias made nonzero (flax inits
    them to zero)."""
    rng = np.random.default_rng(9)

    def f(path, a):
        if path[-1].key == "bias" and "Conv" in str(path[-2].key):
            return rng.normal(0.0, 0.05, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, tree)


def test_conversion_maps_every_tensor():
    _, v, tnet = _pair("post_stem", n_modules=2, features=16)
    sd = from_jax_variables(v)
    assert set(sd) == set(tnet.state_dict())
    n_flax = sum(a.size for a in jax.tree.leaves(v))
    assert n_flax == sum(t.numel() for t in sd.values())
    v2 = {"params": _conv_bias_params(v["params"]), "batch_stats": v["batch_stats"]}
    sd2 = from_jax_variables(v2)
    changed = [k for k in sd if not torch.equal(sd[k], sd2[k])]
    assert changed and all(k.endswith(".bias") for k in changed)


@pytest.mark.slow
def test_pkpnet_full_width_matches_jax():
    """The main path's width: 2 stacks x 2 modules x 256 features, 256x256."""
    jnet, v, tnet = _pair("post_stem", n_modules=2, features=256, hw=(256, 256))
    x = np.random.default_rng(6).uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
    out_j = jnet.apply(v, jnp.asarray(x))
    with torch.no_grad():
        out_t = tnet(torch.from_numpy(x))
    _compare(out_j, out_t)
