"""The batched network calls of the throughput evaluation modes
(`suo_slam_tpu_torch/slam/kernels.py`: `make_batch_inference`,
`make_multi_frame_inference`) against the JAX package's, the window runner
(`eval/batched.py`), and `--nviews 1 --batched` against the port's own
sequential sweep, on the CPU.

- f32: the port's calls against JAX's on weights carried across by
  `from_jax_variables`, within 2e-4 (tests/test_torch_prior.py's bound for
  the per-frame call; measured 5e-6). The prior-free program is held
  against JAX's with-prior program on a zero prior: the port keeps the
  post-stem prior projection's bias there (ROADMAP C3), JAX's prior-free
  program drops it.
- int8: the port's calls equal, bit for bit, the port's int8 forward on its
  own crops and prior heatmaps; the crops equal JAX's and the heatmaps lie
  within 1e-6 of JAX's (K5's gate). The outputs cannot equal JAX's: the two
  f32 stem convolutions differ in their last bits, which flips int8 codes
  downstream (tests/test_torch_int8.py), and on these crops the port's uv
  lies 0.18 of JAX's own int8-to-f32 distance (RMS) from JAX's int8 uv. The
  gate is half that distance: the port runs JAX's int8 program, not another
  quantization, so it must stay nearer to JAX's int8 output than JAX's int8
  is to f32.
- Per crop, the batched calls equal the per-frame call (`make_frame_inference`)
  within 1e-6, f32 and int8: on the CPU the plain K2's moment contraction
  and the validity head's `nn.Linear` are matrix products that the CPU
  blocks by the batch (measured 3.6e-7 on int8 uv at 24 against 4 crops of
  256 x 256). Bit-equality of the int8 keypoints is a property of the card,
  where K2 reads each plane alone; chip_smoke checks it there.
- The evaluation: `Evaluator(nviews=1, batched=True)` against
  `Evaluator(nviews=1)` with a tiny net, f32 and int8 on a scales sidecar:
  equal CSV keys, poses within PnP's f32 bound (`close_results`; the
  byte-equal int8 CSV is chip_smoke's check, for the reason above). A random net's keypoints pose nothing, so the
  network calls are wrapped (`guided`, chip_smoke's `GtGuided`): the
  ground-truth keypoints of each box plus 0.02 x the net's own uv,
  covariance 0.005^2 I, validity 1. The net runs and its output moves
  every pose, while PnP succeeds.

The JAX net is tests/test_torch_int8.py's (2 stacks, 1 module, 32 features,
64 x 64 crops), one module fixture.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.models import int8_forward as ji8
from suo_slam_tpu.ops import heatmap as jhm
from suo_slam_tpu.ops import roi as jroi
from suo_slam_tpu.slam import kernels as jk
from suo_slam_tpu_torch import evaluate as port_evaluate
from suo_slam_tpu_torch.eval.batched import BatchedSingleViewRunner
from suo_slam_tpu_torch.models import int8_forward as ti8
from suo_slam_tpu_torch.models.pkpnet import PkpNet
from suo_slam_tpu_torch.ops import heatmap as thm
from suo_slam_tpu_torch.ops import roi as troi
from suo_slam_tpu_torch.slam import kernels as tk
from tests.helpers.synthetic_bop import write_synthetic_bop
from tests.test_torch_int8 import _pair, _tscales

HW = (64, 64)
NK = 41


@pytest.fixture(scope="module")
def pair():
    return _pair("post_stem")


def _frames(seed, g=3, o=2, hw=(96, 128)):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (g,) + hw + (3,)).astype(np.float32)
    boxes = np.zeros((g, o, 4), np.float32)
    for i in range(g):
        for j in range(o):
            x1, y1 = rng.uniform(0, 40, 2)
            boxes[i, j] = (x1, y1, x1 + rng.uniform(30, 60), y1 + rng.uniform(30, 60))
    valid = np.ones((g, o), bool)
    valid[-1, -1] = False
    puv = rng.uniform(-0.8, 0.8, (g, o, NK, 2)).astype(np.float32)
    pval = rng.uniform(size=(g, o, NK)) < 0.5
    return imgs, boxes, valid, puv, pval


def _tt(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jj(arrays):
    return [jnp.asarray(a) for a in arrays]


def test_f32_calls_match_jax(pair):
    jnet, v, tnet = pair[:3]
    imgs, boxes, valid, puv, pval = _frames(0)
    jm = jk.make_multi_frame_inference(jnet, v, HW)
    tm = tk.make_multi_frame_inference(tnet, HW, device="cpu")
    tb = tk.make_batch_inference(tnet, HW, device="cpu")
    cases = {
        "with prior": (jm(*_jj((imgs, boxes, valid, puv, pval))),
                       tm(*_tt((imgs, boxes, valid, puv, pval)))),
        "prior-free": (jm(*_jj((imgs, boxes, valid, 0 * puv, 0 * pval))),
                       tm(*_tt((imgs, boxes, valid)), has_prior=False)),
        "batch": (jm(*_jj((imgs, boxes, valid, 0 * puv, 0 * pval))),
                  tb(*_tt((imgs, boxes, valid)))),
    }
    for case, (oj, ot) in cases.items():
        for name, a, b in zip(("uv", "cov", "kp_mask"), oj, ot):
            assert b.shape == (3, 2, NK) + a.shape[3:]
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-4, rtol=0,
                                       err_msg=f"{case} {name}")
    # the prior entered the net
    assert np.abs(cases["with prior"][1][0].numpy() - cases["prior-free"][1][0].numpy()).max() > 1e-3


def test_int8_calls_compose_the_int8_forward_and_stay_near_jax(pair):
    jnet, v, tnet, _, _, scales = pair
    imgs, boxes, valid, puv, pval = _frames(0)
    tm = tk.make_multi_frame_inference(tnet, HW, device="cpu", int8=True, int8_scales=scales)
    tb = tk.make_batch_inference(tnet, HW, device="cpu", int8=True, int8_scales=scales)
    ot = tm(*_tt((imgs, boxes, valid, puv, pval)))
    ob = tb(*_tt((imgs, boxes, valid)))
    # the stages against JAX's
    ct = troi.roi_crop_batch(*_tt((imgs, boxes, valid)), HW).reshape(-1, *HW, 3)
    cj = np.asarray(jroi.roi_crop_batch(*_jj((imgs, boxes, valid)), HW)).reshape(-1, *HW, 3)
    assert np.array_equal(ct.numpy(), cj)
    phw = tnet.prior_hw(HW)
    pt = thm.render_prior_heatmaps(torch.from_numpy(puv.reshape(-1, NK, 2)),
                                   torch.from_numpy(pval.reshape(-1, NK)), hw=phw,
                                   sigma_px=thm.prior_sigma_for(phw))
    pj = jhm.render_prior_heatmaps(jnp.asarray(puv.reshape(-1, NK, 2)),
                                   jnp.asarray(pval.reshape(-1, NK)), hw=phw,
                                   sigma_px=jhm.prior_sigma_for(phw))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)
    # the calls are the int8 forward on those stages, bit for bit
    qw, s = ti8.quantize_weights(tnet), _tscales(scales)
    for out, ref in ((ot, ti8.make_int8_apply(tnet)(qw, s, ct, pt)),
                     (ob, ti8.make_int8_apply(tnet, no_prior=True)(qw, s, ct))):
        for a, b in zip(out, (ref.uv, ref.cov, ref.kp_mask)):
            assert torch.equal(a.reshape(b.shape), b)
    assert set(tm.int8_state) == set(tb.int8_state) == {"scales", "vq"}
    # near JAX's int8 program with priors (the prior-free program is the int8
    # forward held to JAX by tests/test_torch_int8.py)
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    oj = ji8.make_int8_apply(jnet)(v, scales, jnp.asarray(cj), pj)
    ref = jnet.apply(v, jnp.asarray(cj), pj)
    for name, a, j, f in zip(("uv", "cov", "kp_mask"), ot, (oj.uv, oj.cov, oj.kp_mask),
                             (ref.uv, ref.cov, ref.kp_mask)):
        j, f = np.asarray(j), np.asarray(f)
        assert rms(a.numpy().reshape(j.shape) - j) <= 0.5 * rms(j - f), name


@pytest.mark.parametrize("int8", [False, True])
def test_per_crop_outputs_do_not_depend_on_the_batch(pair, int8):
    tnet, scales = pair[2], pair[5]
    imgs, boxes, valid, puv, pval = _frames(1)
    kw = dict(device="cpu", int8=int8, int8_scales=scales if int8 else None)
    tm = tk.make_multi_frame_inference(tnet, HW, **kw)
    tb = tk.make_batch_inference(tnet, HW, **kw)
    tf = tk.make_frame_inference(tnet, HW, **kw)
    om = tm(*_tt((imgs, boxes, valid, puv, pval)))
    ob = tb(*_tt((imgs, boxes, valid)))
    for i in range(len(imgs)):
        for out, fr in ((om, tf(*_tt((imgs[i], boxes[i], valid[i], puv[i], pval[i])))),
                        (ob, tf(*_tt((imgs[i], boxes[i], valid[i], puv[i], pval[i])),
                                has_prior=False))):
            for a, b in zip(out, fr):
                assert (a[i] - b).abs().max().item() <= 1e-6


def test_runner_window_and_guard():
    """A plan with a detection-less view, two windows, padding to the
    engine's bucket, and the boxes guard."""
    imgs, boxes, valid, _, _ = _frames(2, g=5, o=2)
    samples = {i: {"img": imgs[i], "K": np.eye(3, dtype=np.float32)} for i in range(5)}

    def load(scene_id, view_id):
        if view_id == 2:
            return None  # no detections
        return np.arange(1, 3, dtype=np.int64), boxes[view_id].copy(), samples[view_id]

    calls = []

    def fn(im, bx, vd):
        calls.append((tuple(im.shape), tuple(bx.shape), int(vd.sum())))
        g, o = bx.shape[:2]
        uv = bx[:, :, None, :2].expand(g, o, NK, 2).clone()  # rows carry their box
        return uv, None, torch.ones(g, o, NK)

    r = BatchedSingleViewRunner(fn, load, window=3, obj_slots=2)
    r.set_plan(7, [0, 1, 2, 3, 4])
    ent0 = r.get(7, 0)
    assert ent0 is not None and ent0["out"][0].shape == (2, NK, 2)
    assert calls == [((3, 96, 128, 3), (3, 2, 4), 4)]  # views 0, 1 (2 has none), padded to 3
    assert r.get(7, 1) is not None and r.get(7, 2) is None and len(calls) == 1
    ent3 = r.get(7, 3)  # the second window
    assert len(calls) == 2 and ent3 is not None
    eng_boxes = np.zeros((4, 4), np.float32)
    eng_boxes[:2] = ent3["boxes_infl"]
    uv, cov, m = r.infer_fn(None, torch.from_numpy(eng_boxes), None, None, None)
    assert uv.shape == (4, NK, 2) and m.shape == (4, NK) and cov is None
    assert (uv[2:] == 0).all() and torch.equal(uv[:2, 0], torch.from_numpy(boxes[3, :, :2]))
    with pytest.raises(AssertionError):
        r.infer_fn(None, torch.from_numpy(eng_boxes + 5.0), None, None, None)
    with pytest.raises(KeyError):
        r.get(8, 0)


# the evaluation ------------------------------------------------------------------
@pytest.fixture
def guided(tree):
    """Every network call the evaluation builds, wrapped by chip_smoke's
    `GtGuided`: the net runs, then each box's ground-truth keypoints plus
    0.02 x the net's uv, covariance 0.005^2 I, validity 1."""
    import chip_smoke

    with chip_smoke.GtGuided(tree, "cpu").installed() as g:
        yield g


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("batched") / "bop_datasets" / "ycbv"
    write_synthetic_bop(str(root), n_scenes=2, n_views=3, seed=3, splits=("test",))
    os.symlink(root / "models_bop-compat", root / "models_bop-compat_eval",
               target_is_directory=True)
    return str(root)


def tiny_net(seed=0):
    torch.manual_seed(seed)
    return PkpNet(n_stack=1, n_modules=1, features=16).eval()


def sidecar(root, path, net):
    """A scales sidecar calibrated on the crops of the tree's first view."""
    from suo_slam_tpu_torch.data.bop import BopDataset

    ds = BopDataset(root, "test", bop_dset="ycbv", ignore_symmetry=True,
                    kp_config_root=os.path.join(root, "kp_configs"))
    v = ds.view_ids(0)[0]
    s = ds.get_raw(0, v, ds.obj_ids(0, v), p_give_prior=0.0)
    crops = troi.roi_crop_batch(torch.from_numpy(s["img"])[None],
                                torch.from_numpy(s["bboxes"])[None],
                                torch.ones(1, len(s["bboxes"]), dtype=torch.bool), (256, 256))[0]
    ti8.save_scales(path, ti8.calibrate(net, [crops]))
    return path


def run_eval(root, out, **kw):
    """One Evaluator run on the CPU; returns (summary, CSV text, summary.txt)."""
    ev = port_evaluate.Evaluator("ycbv", root, "", detection_type="gt", no_viz=True,
                                 kp_config_root=os.path.join(root, "kp_configs"),
                                 device="cpu", **kw)
    ev.model_path = str(out)
    summary = ev.run()
    assert summary is not None
    outdir = os.path.join(ev.model_path, ev.method_name())
    csv = open(os.path.join(outdir, ev.method_name() + ".csv")).read()
    return summary, csv, open(os.path.join(outdir, "summary.txt")).read()


def same_results(a, b, n_rows):
    """Equal CSV (byte for byte), AUCs, camera-pose share and keypoint
    stdev line; n_rows rows."""
    (sa, ca, ta), (sb, cb, tb) = a, b
    assert ca == cb and len(ca.splitlines()) == n_rows
    assert sa["ours"] == sb["ours"] and sa.get("cam_pose_pct") == sb.get("cam_pose_pct")
    keep = lambda t: [x for x in t.splitlines() if not x.startswith("TIMING")]
    assert keep(ta) == keep(tb)


def close_results(a, b, n_rows, tol=1e-4):
    """The f32 net's per-crop outputs move in their last bits with the
    batch, so its poses move within PnP's f32 bound: equal CSV keys (scene,
    view, object, score), rotations within `tol` absolute and translations
    within `tol` of their norm (tests/test_torch_evaluate.py's bound), AUCs
    within 0.1 points, equal camera-pose shares."""
    (sa, ca, _), (sb, cb, _) = a, b

    def rows(csv):
        out = {}
        for line in csv.splitlines():
            p = line.split(",")
            out[tuple(p[:4])] = (np.array(p[4].split(), float), np.array(p[5].split(), float))
        return out

    ra, rb = rows(ca), rows(cb)
    assert ra.keys() == rb.keys() and len(ra) == n_rows
    for k in ra:
        np.testing.assert_allclose(rb[k][0], ra[k][0], atol=tol, rtol=0, err_msg=str(k))
        assert np.abs(rb[k][1] - ra[k][1]).max() <= tol * np.linalg.norm(ra[k][1]), k
    for name in sa["ours"]:
        assert abs(100 * sa["ours"][name] - 100 * sb["ours"][name]) <= 0.1, name
    assert sa.get("cam_pose_pct") == sb.get("cam_pose_pct")


@pytest.mark.parametrize("int8", [False, True])
def test_batched_single_view_equals_the_sequential_sweep(tree, tmp_path, guided, int8):
    net = tiny_net()
    kw = dict(nviews=1, net=net)
    if int8:
        kw.update(int8=True, int8_scales=sidecar(tree, str(tmp_path / "scales.npz"), net))
    seq = run_eval(tree, tmp_path / "seq", **kw)
    bat = run_eval(tree, tmp_path / "bat", batched=True, eval_window=3, **kw)
    close_results(seq, bat, 18)
    assert seq[0]["ours"]["AUC of ADD(-S)"] > 0.5
