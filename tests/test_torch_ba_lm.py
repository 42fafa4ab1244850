"""The host side of kernel K14 (`optimize` in one launch) and the eager
schedule it replaced, on the CPU:

- the plain schedule leaves a round's LM loop once `done` is set, as JAX's
  `while_loop` does: poses, inliers and the damping bit-equal to the
  fixed-length loop that freezes the state instead (tracking, single-view
  and multi-view problems, f32); the iterations each round ran equal to the
  steps JAX's `while_loop` takes (f64, counted by a probe around the JAX
  package's own `_lm_while`), and scripted LM iterations leave both loops
  at the same step;
- the wrapper's shape and scratch planner (`plan_lm`) at every (V, O) the
  engine's capacity growth reaches, against the layouts of both designs in
  `csrc/ba_lm.cu`, and its refusals (both designs, an unknown design);
- the predicate that takes K2, K8 and K9 to their autograd Functions
  (backward kernels K19, K17, K18);
- the JAX checkpoint loader on a GroupNorm checkpoint (it builds the
  GroupNorm net the tree holds, whatever the norm flag says);
- the header-aware staleness of a kernel build.
"""

import os
import re
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.solvers import ba as jba
from suo_slam_tpu_torch import kernels
from suo_slam_tpu_torch.kernels import _build
from suo_slam_tpu_torch.solvers import ba as tba
from tests.test_ba import make_problem
from tests.test_torch_ba import _to_torch

REPO = Path(__file__).resolve().parents[1]


def _tracking_problem(dtype=np.float64):
    prob, *_ = make_problem(n_views=3, n_objs=4, V=3, O=4, K=12, noise=0.003,
                            outlier_frac=0.1, seed=8, dtype=dtype)
    row = lambda a: None if a is None else a[2:3]
    cam_T = np.array(prob.cam_T[2:3])
    cam_T[0, :3, 3] += np.array([3.0, -2.0, 4.0], dtype)
    return prob._replace(cam_T=cam_T, uv=row(prob.uv), info=row(prob.info),
                         cam_k=row(prob.cam_k), valid=row(prob.valid),
                         inliers=row(prob.inliers), cam_active=np.ones((1,), bool),
                         cam_frozen=None)


TRACKING = dict(iters_per_round=(10, 10, 10, 10), tracking_only=True, fix_first_cam=False)
CASES = {
    "tracking": (_tracking_problem, TRACKING),
    "single_view": (lambda dtype=np.float64: make_problem(
        n_views=1, n_objs=4, V=16, O=8, K=12, noise=0.002, outlier_frac=0.1,
        pose_noise=0.003, seed=0, dtype=dtype)[0], dict(iters_per_round=(10, 10, 10, 10))),
    "multi_view": (lambda dtype=np.float64: make_problem(
        n_views=4, n_objs=3, V=6, O=4, K=12, noise=0.003, outlier_frac=0.15,
        pose_noise=0.01, seed=5, dtype=dtype)[0], {}),
}


def _frozen_lm_while(lm_iteration, cam_T, obj_T, inl, lam, n_iters, use_huber):
    """The fixed-length form: every iteration runs, `done` freezes the state."""
    done = torch.zeros((), dtype=torch.bool)
    for _ in range(n_iters):
        (c_new, o_new, _, l_new), rel_gain = lm_iteration((cam_T, obj_T, inl, lam), use_huber)
        cam_T = torch.where(done, cam_T, c_new)
        obj_T = torch.where(done, obj_T, o_new)
        lam = torch.where(done, lam, l_new)
        done = done | ((rel_gain < tba.CONVERGENCE_RTOL) & torch.isfinite(rel_gain)) | (
            l_new >= 1e6)
    return cam_T, obj_T, lam, n_iters


@pytest.mark.parametrize("case", sorted(CASES))
def test_early_exit_equals_the_frozen_loop(monkeypatch, case):
    """In f32, the card's dtype, where the exit test meets the most noise."""
    make, kw = CASES[case]
    p = _to_torch(make(np.float32), np.float32)

    def recorded(impl, lams):
        def run(*a):
            out = impl(*a)
            lams.append(out[2])
            return out
        return run

    lams_exit, lams_frozen = [], []
    monkeypatch.setattr(tba, "_lm_while", recorded(tba._lm_while, lams_exit))
    r, iters = tba._optimize_eager(p, **kw)
    monkeypatch.setattr(tba, "_lm_while", recorded(_frozen_lm_while, lams_frozen))
    f, _ = tba._optimize_eager(p, **kw)
    for a, b in zip(r, f):
        assert torch.equal(a, b)
    assert torch.equal(torch.stack(lams_exit), torch.stack(lams_frozen))
    rounds = kw.get("iters_per_round", tba.DEFAULT_GLOBAL_ROUNDS)
    assert all(0 <= i <= n for i, n in zip(iters, rounds)) and sum(iters) < sum(rounds)
    assert torch.equal(tba.optimize(p, **kw).cam_T, r.cam_T)


def _jax_iterations(prob, kw):
    """The LM steps each round of JAX's `optimize` takes: its own `_lm_while`
    with the iteration wrapped in a counting debug callback, jitted anew."""
    runs, traced = [], []
    orig = jba._lm_while

    def probe(lm_iteration, *a):
        rnd = len(traced)
        traced.append(rnd)

        def counted(state, use_huber):
            jax.debug.callback(lambda: runs.append(rnd))
            return lm_iteration(state, use_huber)

        return orig(counted, *a)

    jba._lm_while = probe
    try:
        opt = jax.jit(jba.optimize.__wrapped__, static_argnames=(
            "iters_per_round", "tracking_only", "fix_first_cam", "huber_delta", "chi2_thresh"))
        jax.block_until_ready(opt(jba.BAProblem(
            *[None if a is None else jnp.asarray(a) for a in prob]), **kw))
    finally:
        jba._lm_while = orig
    n = Counter(runs)
    return [n[r] for r in range(len(traced))]


def test_iterations_per_round_equal_jax_while_loop_steps():
    """The multi-view problem, whose rounds each end on a relative gain far
    above f64 rounding. (A round that starts converged ends on an
    accept / reject decision between costs equal to the last ulp, which
    JAX's and PyTorch's sums break differently: a reject's gain is inf and
    never ends the loop, so such counts legitimately differ.)"""
    make, kw = CASES["multi_view"]
    prob = make()
    _, iters = tba._optimize_eager(_to_torch(prob, np.float64), **kw)
    assert iters == _jax_iterations(prob, kw) == [4, 4, 3, 3]


# (relative gain, damping) after each scripted LM iteration; a reject's gain is inf
SCRIPTS = {
    "converges": [(0.1, 5e-6), (0.01, 2.5e-6), (np.inf, 1e-5), (1e-3, 5e-6), (5e-7, 2.5e-6)],
    "damping_cap": [(np.inf, 4e-5), (np.inf, 1e3), (np.inf, 1e6), (0.1, 5e5)],
    "never": [(0.5, 1e-5)] * 12,
    "nan_gain": [(np.nan, 1e-5), (2e-6, 1e-5), (9e-7, 1e-5)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_lm_while_exit_matches_jax_while_loop(name):
    """The same scripted LM iterations through the port's `_lm_while` and a
    jitted probe of JAX's: equal iteration counts and final damping, for a
    cap of 10 iterations."""
    gains, lams = (np.array(c, np.float64) for c in zip(*SCRIPTS[name]))

    def jax_iteration(state, use_huber):
        k = state[0].astype(jnp.int32)  # the iteration count rides in cam_T
        return (state[0] + 1, state[1], state[2], jnp.asarray(lams)[k]), jnp.asarray(gains)[k]

    def torch_iteration(state, use_huber):
        k = int(state[0])
        return (state[0] + 1, state[1], state[2], torch.tensor(lams[k])), torch.tensor(gains[k])

    probe = jax.jit(lambda lam: jba._lm_while(jax_iteration, jnp.zeros(()), jnp.zeros(()),
                                              None, lam, 10, True))
    jc, _, jl = probe(jnp.asarray(1e-5))
    tc, _, tl, it = tba._lm_while(torch_iteration, torch.zeros((), dtype=torch.float64),
                                  torch.zeros(()), None, torch.tensor(1e-5), 10, True)
    assert it == int(jc) == int(tc) and float(tl) == float(jl)
    assert it == {"converges": 5, "damping_cap": 3, "never": 10, "nan_gain": 3}[name]


def _layout_from_source(fn="inline Layout lm_layout(", end="L.total = off;"):
    """A layout function's `take(...)` sizes in the CUDA source (the block
    design's `lm_layout`, or the cluster design's `cl_layout`), and
    `lm_sys_floats` and the `constexpr int` constants, as Python
    expressions."""
    src = (REPO / "suo_slam_tpu_torch/csrc/ba_lm.cu").read_text()
    body = src[src.index(fn):src.index(end, src.index(fn))]
    sizes = re.findall(r"take\((.*?)\);", body)
    sys_expr = re.search(r"lm_sys_floats\(long long n\) \{ return (.*); \}", src).group(1)
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    return sizes, sys_expr, consts


@pytest.mark.parametrize("O", [8, 16, 32])
def test_planner_mirrors_the_kernel_layout(O):
    """Both designs' plans against the layouts in `csrc/ba_lm.cu`: the
    block design's scratch (`lm_layout`) and the cluster design's per-CTA
    buffers (`cl_layout`: each claims shared memory while the budget
    lasts, the rest goes to the CTA's slice of the scratch)."""
    sizes, sys_expr, consts = _layout_from_source()
    assert consts["kThreads"] == tba.LM_THREADS and consts["kPair"] == tba._LM_PAIR
    assert consts["kMaxRounds"] == tba.LM_MAX_ROUNDS
    for V in (1, 16, 32, 64, 128, 256):
        n = 6 * O
        env = dict(consts, V=V, O=O, n=n, C=n + 1, P=V * O,
                   lm_sys_floats=lambda m: eval(sys_expr, {}, {"n": m}))
        total = sum(eval(e, {}, env) for e in sizes)
        plan = tba.plan_lm(V, O, design="block")
        assert plan.scratch_floats == total == tba.lm_scratch_floats(V, O)
        assert plan.threads == 512 and plan.cluster == 1
        sys_bytes = 4 * tba.lm_sys_floats(O)
        assert sys_bytes == 4 * env["lm_sys_floats"](n)
        # the reduced system in shared memory exactly when it fits one block
        fits = sys_bytes <= tba.LM_SMEM_LIMIT - tba.LM_STATIC_SMEM
        assert plan.smem_bytes == (sys_bytes if fits else 0)
        assert plan.smem_bytes <= 227 * 1024 - 1024
        assert fits == (O <= 39)
        # an L2-resident scratch at the SLAM path's shapes (50 MB L2)
        if V <= 64:
            assert 4 * plan.scratch_floats < 50e6
    # the cluster design: cl_layout's claims, in order, under the budget
    csizes, _, _ = _layout_from_source("inline CLayout cl_layout(", "L.smem_floats = s;")
    assert consts["kCThreads"] == tba.LM_CLUSTER_THREADS
    assert consts["kTThreads"] == tba.LM_TRACK_THREADS
    assert consts["kMaxCluster"] == tba.LM_MAX_CLUSTER
    assert consts["kSmemFloats"] == tba.LM_SMEM_FLOATS and consts["kTCam"] == tba._LM_TCAM
    for V in (1, 16, 32, 64, 128, 256):
        G = tba.lm_cluster_size(V)
        n = 6 * O
        env = dict(consts, V=V, O=O, G=G, n=n, C=n + 1, cpr=-(-V // G), rpr=-(-n // G))
        want = [-(-eval(e, {}, env) // 4) * 4 for e in csizes]
        layout, s, g = tba.lm_cluster_layout(V, O, G)
        assert [f for _, _, f in layout] == want
        used = 0
        for inside, off, f in layout:
            assert inside == (used + f <= tba.LM_SMEM_FLOATS)
            if inside:
                assert off == used
                used += f
        assert used == s and g == sum(f for inside, _, f in layout if not inside)
        plan = tba.plan_lm(V, O)
        assert plan == tba.LmPlan(tba.LM_CLUSTER_THREADS, 4 * s, max(1, G * g), G)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    p = _to_torch(_tracking_problem(), np.float32)
    for design in tba.LM_DESIGNS:
        with pytest.raises(ValueError, match="f32"):
            tba._ba_lm_cuda(p._replace(uv=p.uv.double()), design=design, **TRACKING)
        with pytest.raises(ValueError, match="bool"):
            tba._ba_lm_cuda(p._replace(valid=p.valid.to(torch.uint8)), design=design,
                            **TRACKING)
        with pytest.raises(ValueError, match="shapes"):
            tba._ba_lm_cuda(p._replace(cam_k=p.cam_k[..., :3]), design=design, **TRACKING)
        with pytest.raises(ValueError, match="rounds"):
            tba._ba_lm_cuda(p, iters_per_round=(1,) * 33, design=design)
    with pytest.raises(ValueError, match="design"):
        tba._ba_lm_cuda(p, design="serial", **TRACKING)


def test_autograd_predicate():
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    assert kernels.autograd_records(y, x) and not kernels.autograd_records(y, None)
    with torch.no_grad():
        assert not kernels.autograd_records(x)
    with torch.inference_mode():
        assert not kernels.autograd_records(x)
    assert not kernels.autograd_records(y)


def test_jax_checkpoint_message_names_its_format_and_item(tmp_path):
    """The JAX package's checkpoints (flax msgpack with a `.meta.json`
    sidecar) load; a `norm="group"` one as the GroupNorm net (ROADMAP A18,
    done), its tree winning over the norm flag."""
    from suo_slam_tpu_torch.eval import loading
    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.train import checkpoint as tck
    from suo_slam_tpu_torch.train import harness as th

    net = PkpNet(n_stack=1, n_modules=1, features=16, norm="group")
    tck.save_checkpoint(str(tmp_path), th.TrainState(net, th.make_optimizer(net.parameters())),
                        3, {"norm": "group"}, 1.0)
    loaded, epoch = loading.load_eval_network(str(tmp_path / "checkpoint-3"), norm="batch")
    assert epoch == 3 and loaded.norm == "group"
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert re.search(r"A18", (REPO / "ROADMAP.md").read_text())
    assert "orbax" not in loading.__doc__ and ".meta.json" in loading.__doc__


def test_a_shared_header_makes_its_includers_stale(tmp_path):
    src, hdr = tmp_path / "k.cu", tmp_path / "common.cuh"
    out = tmp_path / "libk.so"
    src.write_text("")
    hdr.write_text("")
    assert _build.stale(src, out)  # never built
    out.write_text("")
    for path, t in ((src, 100), (hdr, 100), (out, 200)):
        os.utime(path, (t, t))
    assert not _build.stale(src, out)
    os.utime(hdr, (300, 300))
    assert _build.stale(src, out)
    os.utime(hdr, (100, 100))
    os.utime(src, (300, 300))
    assert _build.stale(src, out)
