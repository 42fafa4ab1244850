"""The PnP hypothesis sampler (`suo_slam_tpu_torch/solvers/pnp.py`: the
draws of `sample_hypothesis_indices` and `hypothesis_indices`, whose CUDA
path is kernel K22, `csrc/pnp_sample.cu`) against the JAX package's
`_sample_hypothesis_indices` on the CPU, and the thread safety of the
kernels' launch counters and build.

JAX ranks Gumbel scores g = -log(-log(u)); the port ranks u. Given JAX's own
scores `jax.random.gumbel(key, (n_hyp, N))` as u = exp(-exp(-g)) in f64 (a
strictly increasing map, so the order is kept), the port's plain version
must pick exactly JAX's indices, exhausted rows (fewer than 4 valid points)
included. The shapes are the main path's: the front end's 64 hypotheses
over 41 keypoints and the backup camera pose's 128 over 8 x 41.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.solvers import pnp as jpnp
from suo_slam_tpu_torch import kernels
from suo_slam_tpu_torch.kernels import _build
from suo_slam_tpu_torch.solvers import pnp as tpnp


def _masks(rng, N):
    """Rows of every kind: most points valid, 4 valid, 3 valid, 1 valid,
    none valid, all valid."""
    m = rng.uniform(size=(6, N)) < 0.8
    for row, k in ((1, 4), (2, 3), (3, 1), (4, 0)):
        m[row] = False
        m[row, rng.choice(N, k, replace=False)] = True
    m[5] = True
    return m


@pytest.mark.parametrize("n_hyp,N,seed", [(64, 41, 0), (64, 41, 1), (128, 328, 2), (16, 7, 3)])
def test_plain_version_equals_jax_given_its_gumbel_scores(n_hyp, N, seed):
    rng = np.random.default_rng(seed)
    masks = _masks(rng, N)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(masks))
    u = np.stack([np.exp(-np.exp(-np.asarray(jax.random.gumbel(k, (n_hyp, N)), np.float64)))
                  for k in keys])
    want = np.stack([np.asarray(jpnp._sample_hypothesis_indices(k, jnp.asarray(m), n_hyp))
                     for k, m in zip(keys, masks)])
    got = tpnp.hypothesis_indices(torch.from_numpy(u), torch.from_numpy(masks))
    assert got.dtype == torch.int64 and got.shape == (len(masks), n_hyp, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    # the contract: distinct valid points while >= 4 are valid, else the
    # valid ones first and index 0 for every exhausted pick
    g = got.numpy()
    for o, m in enumerate(masks):
        n = int(m.sum())
        for r in g[o]:
            assert m[r[:min(n, 4)]].all()
            assert len(set(r[:min(n, 4)])) == min(n, 4)
            assert (r[n:] == 0).all()


def test_ties_go_to_the_lowest_index_and_masked_points_never_win():
    u = torch.tensor([[[0.5, 0.9, 0.9, 0.2, 0.9, 0.7]]])
    mask = torch.tensor([[True, True, True, True, False, True]])
    assert tpnp.hypothesis_indices_plain(u, mask).tolist() == [[[1, 2, 5, 0]]]
    assert tpnp.hypothesis_indices_plain(u, torch.zeros_like(mask)).tolist() == [[[0, 0, 0, 0]]]


def test_sampler_draws_once_and_ranks_on_the_plain_version():
    """`sample_hypothesis_indices` = one `torch.rand` [O, n_hyp, N] on the
    generator, ranked by `hypothesis_indices` (the CPU dispatch: the plain
    version)."""
    mask = torch.from_numpy(np.random.default_rng(5).uniform(size=(3, 41)) < 0.7)
    idx = tpnp.sample_hypothesis_indices(mask, 64, torch.Generator().manual_seed(7))
    u = torch.rand((3, 64, 41), generator=torch.Generator().manual_seed(7))
    assert torch.equal(idx, tpnp.hypothesis_indices_plain(u, mask))


def test_k22_wrapper_refuses_what_the_kernel_does_not_take():
    u, m = torch.rand(2, 8, 41), torch.ones(2, 41, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA device"):
        tpnp._hypothesis_indices_cuda(u, m)
    with pytest.raises(ValueError, match="f32"):
        tpnp._hypothesis_indices_cuda(u.double(), m)
    with pytest.raises(ValueError, match="points"):
        tpnp._hypothesis_indices_cuda(torch.rand(1, 8, tpnp.K22_MAX_POINTS + 1),
                                      torch.ones(1, tpnp.K22_MAX_POINTS + 1, dtype=torch.bool))
    with pytest.raises(ValueError, match="shapes"):
        tpnp._hypothesis_indices_cuda(u, m[:, :40])
    with pytest.raises(ValueError, match="unsupported device"):
        tpnp.hypothesis_indices(u.to("meta"), m.to("meta"))


def test_launch_counter_loses_nothing_across_threads():
    kernels.reset_counts()
    barrier = threading.Barrier(8)

    def work():
        barrier.wait()
        for _ in range(5000):
            kernels.count("pnp_sample")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert kernels.counts()["pnp_sample"] == 8 * 5000
    kernels.reset_counts()
    assert kernels.counts()["pnp_sample"] == 0


def test_first_entry_lookups_from_threads_build_once(monkeypatch):
    """Eight threads reaching a kernel's first launch together run one build
    and type the entry point once."""
    builds = []

    class Lib:
        def __init__(self):
            self.suo_fake = type("Fn", (), {})()

    def build_all():
        with _build._lock:
            builds.append(threading.get_ident())
            time.sleep(0.05)  # other threads arrive meanwhile
            _build._libs["fake"] = Lib()

    monkeypatch.setattr(_build, "build_all", build_all)
    _build._libs.pop("fake", None)
    barrier = threading.Barrier(8)
    got = []

    def work():
        barrier.wait()
        got.append(_build.entry("fake", []))

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        assert len(builds) == 1 and len(got) == 8 and all(g is got[0] for g in got)
    finally:
        _build._libs.pop("fake", None)
        _build._entries.pop(("fake", None), None)
