"""The scene-pipelined evaluation (`suo_slam_tpu_torch/eval/pipeline.py`,
`Evaluator(pipeline_scenes=K)`) on the CPU.

- The server and the pool (as the JAX package's tests/test_pipelined_eval.py):
  one call serves every live client, each gets its own rows; the barrier
  shrinks as clients finish and the scene axis keeps its construction-time
  size; a worker's error aborts the server and re-raises with no peer left
  waiting (within 30 s); the pool returns every result by its key.
- The sweep against the port's own sequential sweep on a BOP tree of 2
  scenes x 3 views: SLAM (`--nviews -1 --pipeline_scenes 2`) and SfM
  (`--nviews 2 --pipeline_scenes 3`) with ground-truth keypoints give the
  same CSV byte for byte and the same summary (a fresh engine per work item
  seeds its sampler as the sequential engine after its reset; the SfM view
  draws are made on the calling thread in the sequential order); SLAM with
  a tiny int8 net on a scales sidecar through the server, wrapped by
  chip_smoke's `GtGuided` (the net's output moves the poses), within PnP's f32 bound (`close_results`: on the CPU the plain
  readout's matrix product blocks by the batch).
- `--int8 --pipeline_scenes` without a sidecar refuses, naming
  `python -m suo_slam_tpu_torch.calibrate_int8`; `--int8_online_ok` passes
  that guard; `--pipeline_scenes` under `--nviews 1` is ignored with JAX's
  message.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from suo_slam_tpu_torch import evaluate as port_evaluate
from suo_slam_tpu_torch.eval import loading as tloading
from suo_slam_tpu_torch.eval.pipeline import BatchingInferServer, ScenePool
from tests.test_torch_batched_eval import (close_results, guided, run_eval,  # noqa: F401
                                           same_results, sidecar, tiny_net, tree)  # (fixtures)

NK = 5


# the server and the pool ---------------------------------------------------------
def _fake_multi_fn(calls):
    """A stand-in for `make_multi_frame_inference`: row i of uv holds
    (i, the box's x1), so that each client can see it got its own rows."""

    def fn(imgs, boxes, valid, prior_uv, prior_valid, has_prior=True):
        calls.append(dict(g=int(imgs.shape[0]), o=int(boxes.shape[1]), has_prior=bool(has_prior)))
        g, o = boxes.shape[:2]
        nk = prior_uv.shape[-2]
        row = torch.arange(g, dtype=torch.float32)[:, None, None, None].expand(g, o, nk, 1)
        x1 = boxes[:, :, None, None, 0].expand(g, o, nk, 1)
        return torch.cat([row, x1], -1), None, torch.ones(g, o, nk)

    return fn


def _request(o, x1=0.0):
    return (torch.zeros(8, 8, 3), torch.full((o, 4), float(x1)), torch.ones(o, dtype=torch.bool),
            torch.zeros(o, NK, 2), torch.zeros(o, NK, dtype=torch.bool))


def test_batching_server_slices_and_barrier():
    """Three clients, one call with G = 3; each gets its own O rows."""
    calls, outs = [], {}
    server = BatchingInferServer(_fake_multi_fn(calls), n_clients=3)

    def client(cid, o):
        uv, cov, mask = server.client(cid)(*_request(o, 10 * cid), has_prior=(cid == 1))
        outs[cid] = (uv, cov, mask)
        server.done(cid)

    threads = [threading.Thread(target=client, args=a, daemon=True)
               for a in ((0, 2), (1, 4), (2, 3))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "the server deadlocked"
    assert calls == [{"g": 3, "o": 4, "has_prior": True}]  # padded; any client's prior
    for cid, o in ((0, 2), (1, 4), (2, 3)):
        uv, cov, mask = outs[cid]
        assert uv.shape == (o, NK, 2) and mask.shape == (o, NK) and cov is None
        assert (uv[..., 0] == cid).all() and (uv[..., 1] == 10 * cid).all()


def test_batching_server_shrinking_barrier():
    """After a client is done, the others still dispatch; the scene axis
    stays at the construction-time count."""
    calls = []
    server = BatchingInferServer(_fake_multi_fn(calls), n_clients=2)
    server.done(0)  # client 0 never asks
    uv, _, _ = server.client(1)(*_request(2))
    assert uv.shape == (2, NK, 2)
    assert calls == [{"g": 2, "o": 2, "has_prior": True}]


def test_scene_pool_propagates_worker_errors():
    """A worker's exception aborts the server (the waiting peer wakes) and
    re-raises on the calling thread."""
    server = BatchingInferServer(_fake_multi_fn([]), n_clients=2)

    def run_scene(cid, scene_id):
        if scene_id == "bad":
            time.sleep(0.2)  # the peer reaches the barrier first
            raise ValueError("boom")
        server.client(cid)(*_request(1))
        return "ok"

    t0 = time.time()
    with pytest.raises(ValueError, match="boom"):
        ScenePool(server, 2).run(["good", "bad"], run_scene)
    assert time.time() - t0 < 30, "a peer hung at the barrier after the abort"


def test_dispatch_errors_reach_every_waiting_client():
    def broken(*a, **kw):
        raise RuntimeError("device fault")

    server = BatchingInferServer(broken, n_clients=2)
    errors = []

    def client(cid):
        try:
            server.client(cid)(*_request(1))
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(errors) == ["device fault", "pipelined inference aborted by a peer scene"]


def test_scene_pool_runs_every_item_and_keys_the_results():
    assert ScenePool(None, 2).run(list(range(7)), lambda cid, sid: sid * 10) == {
        i: i * 10 for i in range(7)}


# the sweep -------------------------------------------------------------------------
@pytest.mark.parametrize("nviews,k", [(-1, 2), (2, 3)])
def test_pipelined_gt_keypoints_equal_the_sequential_sweep(tree, tmp_path, nviews, k):
    seq = run_eval(tree, tmp_path / "seq", nviews=nviews, debug_gt_kp=True)
    pipe = run_eval(tree, tmp_path / "pipe", nviews=nviews, debug_gt_kp=True,
                    pipeline_scenes=k)
    same_results(seq, pipe, 18)
    if nviews < 0:
        assert seq[0]["cam_pose_pct"] == 100.0 and seq[0]["ours"]["AUC of ADD(-S)"] > 0.8


def test_pipelined_int8_net_matches_the_sequential_sweep(tree, tmp_path, guided):
    net = tiny_net()
    kw = dict(nviews=-1, net=net, int8=True, int8_scales=sidecar(tree, str(tmp_path / "s.npz"),
                                                                   net))
    seq = run_eval(tree, tmp_path / "seq", **kw)
    pipe = run_eval(tree, tmp_path / "pipe", pipeline_scenes=2, **kw)
    close_results(seq, pipe, 18)
    assert seq[0]["cam_pose_pct"] == 100.0


def test_int8_pipelined_without_a_sidecar_refuses(tree, tmp_path, monkeypatch, capsys):
    net = tiny_net()
    monkeypatch.setattr(tloading, "load_eval_network", lambda *a, **k: (net, 7))
    kw = dict(nviews=-1, detection_type="gt", no_viz=True, device="cpu", int8=True,
              kp_config_root=os.path.join(tree, "kp_configs"), pipeline_scenes=2)
    with pytest.raises(SystemExit, match="python -m suo_slam_tpu_torch.calibrate_int8"):
        port_evaluate.Evaluator("ycbv", tree, str(tmp_path / "ckpt-without-sidecar"), **kw)
    ev = port_evaluate.Evaluator("ycbv", tree, str(tmp_path / "ckpt-without-sidecar"),
                                 int8_online_ok=True, **kw)
    assert ev._pipe is not None and ev._pipe["scales_path"] is None
    assert "--int8_online_ok: pipelined online calibration accepted" in capsys.readouterr().out
    ev = port_evaluate.Evaluator("ycbv", tree, "", nviews=1, detection_type="gt",
                                 debug_gt_kp=True, no_viz=True, device="cpu",
                                 kp_config_root=os.path.join(tree, "kp_configs"),
                                 pipeline_scenes=2)
    assert ev.pipeline_scenes == 0 and ev._pipe is None
    assert "--pipeline_scenes has no effect with --nviews 1" in capsys.readouterr().out


def test_cli_accepts_the_throughput_flags():
    from suo_slam_tpu_torch.args import get_args

    a = get_args(["--batched", "--eval_window", "8", "--pipeline_scenes", "3",
                  "--int8_online_ok"])
    assert (a.batched, a.eval_window, a.pipeline_scenes, a.int8_online_ok) == (True, 8, 3, True)
    assert np.isscalar(a.eval_window)
