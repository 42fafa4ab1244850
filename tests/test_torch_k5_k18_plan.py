"""K18's and K5's host plans and their kernels' index walks, on the CPU.

- `plan_upsample_bwd` sends K18 to its vector route (a thread per 16-byte
  vector of channels) where C is a multiple of a vector and dy and d_low
  are 16-byte aligned, else to its scalar route, and refuses odd sizes and
  rows past 32-bit offsets.
- A numpy model of K18's thread walk (`csrc/upsample_add.cu`: the launch
  geometry, one division a thread, then counters) stores every d_low value
  once, from the right four dy values, and equals the plain version.
- `plan_prior_render` takes K5's 16-byte stores where W x K is a multiple
  of a vector and the output is aligned, and a numpy model of K5's walk
  (`csrc/prior_render.cu`: tiles of 8 x 16 pixels, the staged terms by
  counters, the values walked flat) stages every term once and writes every
  value once with the terms of its own column, row and keypoint.
- K5's bf16 output: `render_prior_heatmaps_plain(..., dtype=torch.bfloat16)`
  is the f32 map rounded once (a subnormal value may flush to 0 on the
  CPU), and against the JAX package's
  `render_prior_heatmaps(...).astype(jnp.bfloat16)` it is bit-equal wherever
  the two f32 maps are, and elsewhere within one bf16 ulp or 0 against a
  subnormal: the f32 maps differ in the last bits (XLA's CPU exp is not
  PyTorch's, XLA's jit divides by the constant sigma through its
  reciprocal, and XLA's CPU flushes subnormal results to zero), within
  1e-6.
- K5's validity fold: dv = +inf for an invalid keypoint gives the plain
  version's g * valid bit for bit.
- A bf16 with-prior `make_frame_inference` (and its multi-frame twin)
  renders the prior in bf16 and gives the bits of the earlier route: an f32
  render, then the net's own cast.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.ops import heatmap as jhm
from suo_slam_tpu_torch.models import hourglass as hg
from suo_slam_tpu_torch.models.pkpnet import PkpNet
from suo_slam_tpu_torch.ops import heatmap as thm
from suo_slam_tpu_torch.ops import roi
from suo_slam_tpu_torch.slam import kernels as tk
from tests.test_torch_prior import _priors

CSRC = Path(__file__).resolve().parents[1] / "suo_slam_tpu_torch" / "csrc"


def _const(src: str, name: str) -> int:
    """A `constexpr int` of a source, its expression evaluated over the
    constants above it."""
    env: dict[str, int] = {}
    for k, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", (CSRC / src).read_text()):
        env[k] = eval(expr, {}, dict(env))
    return env[name]


# K18 ---------------------------------------------------------------------------
@pytest.mark.parametrize("C,itemsize,ptrs,route", [
    (256, 2, (0, 4096), hg.K18_VECTOR),    # the net's junctions, bf16
    (256, 4, (0, 4096), hg.K18_VECTOR),    # f32
    (40, 2, (16, 32), hg.K18_VECTOR),
    (12, 4, (16, 32), hg.K18_VECTOR),      # a multiple of 4 f32 ...
    (12, 2, (16, 32), hg.K18_SCALAR),      # ... not of 8 bf16
    (6, 4, (16, 32), hg.K18_SCALAR),
    (1, 2, (0, 0), hg.K18_SCALAR),
    (256, 2, (2, 4096), hg.K18_SCALAR),    # dy one bf16 off 16 bytes
    (256, 4, (0, 4100), hg.K18_SCALAR),    # d_low off 16 bytes
    (256, 4, (8,), hg.K18_SCALAR),
])
def test_upsample_bwd_route(C, itemsize, ptrs, route):
    assert hg.plan_upsample_bwd((32, C, 64, 64), itemsize, *ptrs) == route


def test_upsample_bwd_route_of_a_misaligned_view():
    """A channels_last dy one value past an aligned start takes the scalar
    route; the tensor it is a view of, the vector route."""
    for dt in (torch.bfloat16, torch.float32):
        base = torch.zeros(1 + 2 * 64 * 8 * 8, dtype=dt)
        aligned = base[:-1].view(2, 8, 8, 64).permute(0, 3, 1, 2)
        view = base[1:].view(2, 8, 8, 64).permute(0, 3, 1, 2)
        assert view.is_contiguous(memory_format=torch.channels_last)
        assert aligned.data_ptr() % 16 == 0 and view.data_ptr() % 16 != 0
        plan = lambda t: hg.plan_upsample_bwd(tuple(t.shape), t.element_size(), t.data_ptr())
        assert plan(aligned) == hg.K18_VECTOR
        assert plan(view) == hg.K18_SCALAR


@pytest.mark.parametrize("shape", [(2, 8, 7, 8), (2, 8, 8, 9), (1, 2 ** 20, 2, 2 ** 10)])
def test_upsample_bwd_refusals(shape):
    with pytest.raises(ValueError, match="K18"):
        hg.plan_upsample_bwd(shape, 2, 0, 0)


def _k18_walk(N, H, W, C, V):
    """K18's threads as the source runs them: (store index, top-left dy
    offset) of every load a thread makes in one low row, in units of V
    values."""
    unroll, max_threads = _const("upsample_add.cu", "kBwdUnroll"), \
        _const("upsample_add.cu", "kThreads")
    cv, lv = C // V, (W // 2) * (C // V)
    threads = -(-lv // unroll)
    threads = max_threads if threads >= max_threads else -(-threads // 32) * 32
    per_block = unroll * threads
    gx = -(-lv // per_block)
    q0 = (np.arange(gx)[:, None] * per_block + np.arange(threads)[None]).ravel()
    j, c = q0 // cv, q0 - (q0 // cv) * cv
    dj, dc = threads // cv, threads - (threads // cv) * cv
    qs, offs = [], []
    for u in range(unroll):
        ok = q0 + u * threads < lv
        qs.append((q0 + u * threads)[ok])
        offs.append((2 * j * cv + c)[ok])
        j, c = j + dj, c + dc
        wrap = c >= cv
        j, c = j + wrap, c - cv * wrap
    return np.concatenate(qs), np.concatenate(offs), threads, gx


@pytest.mark.parametrize("C,V", [(256, 8), (256, 4), (40, 8), (12, 4), (12, 1), (3, 1)])
@pytest.mark.parametrize("H,W", [(64, 64), (8, 8), (2, 2), (4, 10)])
def test_k18_walk_model_matches_plain(C, V, H, W):
    N = 2
    q, off, threads, _ = _k18_walk(N, H, W, C, V)
    cv, wv = C // V, W * (C // V)
    assert threads % 32 == 0 and threads <= 256
    assert np.array_equal(np.sort(q), np.arange((W // 2) * cv))  # each store once
    dy = np.random.default_rng(C + H).normal(size=(N, H, W, C)).astype(np.float32)
    rows = dy.reshape(N * H // 2, 2, wv, V)  # row pair r: dy rows 2r, 2r + 1 in loads
    top, bot = rows[:, 0], rows[:, 1]
    s = (top[:, off] + top[:, off + cv]) + (bot[:, off] + bot[:, off + cv])
    out = np.empty((N * H // 2, (W // 2) * cv, V), np.float32)
    out[:, q] = s
    t = torch.from_numpy(dy).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    plain = hg.upsample_add_bwd_plain(t).permute(0, 2, 3, 1).numpy()
    assert np.array_equal(out.reshape(plain.shape), plain)


def test_k18_geometry_at_the_train_step():
    """The train step's junctions (32 rows x 256 channels): full blocks of
    256 threads at 64 x 64 (one a low row in bf16, two in f32), warps of
    whole loads below."""
    assert _k18_walk(32, 64, 64, 256, 8)[2:] == (256, 1)
    assert _k18_walk(32, 64, 64, 256, 4)[2:] == (256, 2)
    assert _k18_walk(32, 8, 8, 256, 8)[2:] == (32, 1)


# K5 ----------------------------------------------------------------------------
def _vec(route: str, dtype: torch.dtype) -> int:
    """Values a K5 store writes on `route`."""
    return 16 // dtype.itemsize if route == thm.PRIOR_VECTOR else 1


@pytest.mark.parametrize("hw,K,dtype,ptr,route", [
    ((64, 64), 41, torch.float32, 0, thm.PRIOR_VECTOR),
    ((64, 64), 41, torch.bfloat16, 0, thm.PRIOR_VECTOR),
    ((256, 256), 41, torch.bfloat16, 512, thm.PRIOR_VECTOR),
    ((16, 2), 41, torch.float32, 0, thm.PRIOR_SCALAR),     # 82 values a row
    ((16, 4), 41, torch.bfloat16, 0, thm.PRIOR_SCALAR),    # 164: a multiple of 4, not 8
    ((16, 4), 41, torch.float32, 0, thm.PRIOR_VECTOR),
    ((64, 64), 41, torch.float32, 8, thm.PRIOR_SCALAR),    # output off 16 bytes
])
def test_prior_render_route(hw, K, dtype, ptr, route):
    assert thm.plan_prior_render(4, hw, K, dtype, ptr) == route
    # the shared-memory refusal: du of the tile's columns (16-byte rounded)
    # and dv rows of K + V - 1 terms, from the source's own tile
    rows, cols = _const("prior_render.cu", "kRows"), _const("prior_render.cu", "kCols")
    assert thm._PRIOR_TILE == (rows, cols)
    V = _vec(route, dtype)
    smem = lambda k: 4 * (-(-cols * k // 4) * 4 + rows * (k + V - 1))
    k_max = max(k for k in range(1, 4096) if smem(k) <= thm.CTA_SMEM)
    k_fit = k_max - k_max % (V // math.gcd(V, hw[1]))  # keeps W x K a multiple of V
    assert thm.plan_prior_render(4, hw, k_fit, dtype, ptr) == route
    with pytest.raises(ValueError, match="keypoints"):
        thm.plan_prior_render(4, hw, k_max + V, dtype, ptr)


def test_prior_render_refusals():
    with pytest.raises(ValueError, match="f32 or bf16"):
        thm.plan_prior_render(4, (64, 64), 41, torch.float64)
    with pytest.raises(ValueError, match="keypoints"):
        thm.plan_prior_render(4, (64, 64), 2500, torch.float32)
    with pytest.raises(ValueError, match="crops"):
        thm.plan_prior_render(70000, (64, 64), 41, torch.float32)


@pytest.mark.parametrize("hw,K,dtype", [((64, 64), 41, torch.float32),
                                        ((64, 64), 41, torch.bfloat16),
                                        ((12, 20), 41, torch.float32), ((4, 2), 3, torch.float32),
                                        ((16, 4), 41, torch.float32), ((9, 8), 1, torch.bfloat16),
                                        ((40, 24), 5, torch.bfloat16)])
def test_k5_walk_model(hw, K, dtype):
    """The kernel's index walks (a tile of 8 x 16 pixels; the prologue's
    (w, k) and (h, k) by counters; the values walked flat, V at a time, in
    steps of 512 x V, from one division a thread): every du and dv term is
    staged once, and every output value is written once, from du[w, k] of
    its column and the dv entry of its row at k + j < K + V - 1, which holds
    dv[h, (k + j) mod K]."""
    H, W = hw
    V = _vec(thm.plan_prior_render(1, hw, K, dtype), dtype)
    rows, cols, nt = (_const("prior_render.cu", c) for c in ("kRows", "kCols", "kThreads"))
    KX = K + V - 1
    seen = np.zeros((H, W, K), np.int64)
    for h0 in range(0, H, rows):
        for w0 in range(0, W, cols):
            tw, th = min(cols, W - w0), min(rows, H - h0)
            length, step = tw * K, nt * V
            assert length % V == 0
            du_terms, dv_terms = {}, {}
            for t in range(nt):       # the prologue's counters
                w, k = divmod(t, K)
                for i in range(t, length, nt):
                    assert divmod(i, K) == (w, k)
                    du_terms[i] = (w, k)
                    w, k = w + nt // K, k + nt % K
                    if k >= K:
                        w, k = w + 1, k - K
                h, k = divmod(t, KX)
                for i in range(t, th * KX, nt):
                    kk = k
                    while kk >= K:
                        kk -= K
                    dv_terms[i] = (h, kk)
                    h, k = h + nt // KX, k + nt % KX
                    if k >= KX:
                        h, k = h + 1, k - KX
            assert sorted(du_terms) == list(range(length))
            assert sorted(dv_terms) == list(range(th * KX))
            drow, de, dk = step // length, step - (step // length) * length, step % K
            for t in range(nt):
                row, e = divmod(t * V, length)
                k = e % K
                while row < th:
                    for j in range(V):
                        w, kk = du_terms[e + j]
                        assert dv_terms[row * KX + k + j] == (row, kk)
                        seen[h0 + row, w0 + w, kk] += 1
                    e, row = e + de, row + drow
                    if e >= length:
                        e, row = e - length, row + 1
                    k = k + dk
                    k -= K if k >= K else 0
    assert (seen == 1).all()


@pytest.mark.parametrize("hw", [(64, 64), (256, 256), (16, 4)])
def test_k5_validity_fold(hw):
    """K5 folds the validity select into dv (+inf for an invalid or
    non-finite keypoint): in f32, exp(-0.5 (du du + dv dv)) is then the
    plain version's g * valid bit for bit — the same argument where valid,
    -inf and +0 where not (du is always finite) — at every pixel and
    keypoint, keypoints on pixel centres and clipped ones included."""
    uv, mask = _priors(np.random.default_rng(1), n=4)
    h, w = hw
    u, v = (t.numpy() for t in thm.ndc_grid(h, w))
    c = min(8, h, w)
    uv[2, :c, 0] = u[0, :c]          # keypoints on pixel centres: du = 0
    uv[2, :c, 1] = v[:c, 0]
    su, sv = (np.float32(s) for s in thm._prior_sigmas(hw, thm.prior_sigma_for(hw)))
    uvc = np.clip(np.nan_to_num(uv), -1, 1).astype(np.float32)
    du = (u[0][None, :, None] - uvc[:, None, :, 0]) / su               # [n, w, k]
    dv = (v[:, 0][None, :, None] - uvc[:, None, :, 1]) / sv            # [n, h, k]
    ok = (mask & np.isfinite(uv).all(-1))[:, None, None, :]
    arg = lambda d: np.float32(-0.5) * (du[:, None] * du[:, None] + d[:, :, None] * d[:, :, None])
    folded_arg = arg(np.where(ok[:, 0], dv, np.float32(np.inf)))
    assert np.isfinite(du).all() and folded_arg.dtype == np.float32
    valid = np.broadcast_to(ok, folded_arg.shape)
    assert np.array_equal(folded_arg[valid].view(np.uint32), arg(dv)[valid].view(np.uint32))
    assert (folded_arg[~valid] == -np.inf).all()
    plain = np.exp(arg(dv)) * ok.astype(np.float32)
    assert np.array_equal(np.exp(folded_arg).view(np.uint32), plain.view(np.uint32))
    assert (du[2, :c, :c].diagonal() == 0).all()


@pytest.fixture(scope="module")
def jax_maps():
    """The JAX package's f32 prior maps at the post_stem and concat sizes."""
    uv, mask = _priors(np.random.default_rng(0))
    out = {}
    for hw in ((64, 64), (256, 256)):
        out[hw] = np.asarray(jhm.render_prior_heatmaps(
            jnp.asarray(uv), jnp.asarray(mask), hw=hw, sigma_px=jhm.prior_sigma_for(hw)))
    return uv, mask, out


@pytest.fixture
def one_thread():
    """One intra-op thread for the comparisons of bits between two CPU calls
    (which of PyTorch's CPU loops, vector or scalar, takes a value depends
    on where a thread's chunk ends)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_rounding(p16: torch.Tensor, p32: torch.Tensor) -> bool:
    """p16 is p32 rounded once to bf16: bit for bit at every normal value
    and 0, and at a subnormal f32 value its rounding or 0 (the CPU's
    conversion may flush subnormals)."""
    want = p32.to(torch.bfloat16)
    sub = (p32 != 0) & (p32.abs() < torch.finfo(torch.float32).tiny)
    same = p16.view(torch.int16) == want.view(torch.int16)
    return bool((same | (sub & (p16 == 0))).all())


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16).astype(np.int32)


@pytest.mark.parametrize("hw", [(64, 64), (256, 256)])
def test_bf16_prior_against_jax(jax_maps, hw, one_thread):
    uv, mask, maps = jax_maps
    sigma = thm.prior_sigma_for(hw)
    t_uv, t_mask = torch.from_numpy(uv), torch.from_numpy(mask)
    p16 = thm.render_prior_heatmaps_plain(t_uv, t_mask, hw, sigma, dtype=torch.bfloat16)
    p32 = thm.render_prior_heatmaps_plain(t_uv, t_mask, hw, sigma)
    assert p16.dtype == torch.bfloat16 and p16.is_contiguous() and p32.dtype == torch.float32
    assert _same_rounding(p16, p32)
    assert _same_rounding(thm.render_prior_heatmaps(t_uv, t_mask, hw, sigma, torch.bfloat16), p32)
    j32 = maps[hw]
    j16 = _bits(np.asarray(jnp.asarray(j32).astype(jnp.bfloat16)))
    k16 = _bits(p16.view(torch.int16).numpy())
    same32 = j32.view(np.uint32) == p32.numpy().view(np.uint32)
    assert np.abs(j32 - p32.numpy()).max() <= 1e-6
    assert (j16[same32] == k16[same32]).all()
    # values >= 0, so adjacent codes are adjacent bf16s; XLA flushes subnormals
    flushed = (j32 == 0) & (p32.numpy() < np.finfo(np.float32).tiny)
    assert (np.abs(j16 - k16)[~flushed] <= 1).all()
    drawn = mask & np.isfinite(uv).all(-1)
    assert not k16.transpose(0, 3, 1, 2)[~drawn].any()  # masked and non-finite: +0


def _small_bf16_net():
    torch.manual_seed(0)
    net = PkpNet(n_stack=1, n_modules=1, features=16, dtype=torch.bfloat16)
    return net.eval().to(memory_format=torch.channels_last)


def test_prior_dtype():
    assert PkpNet(n_stack=1, n_modules=1, features=16,
                  dtype=torch.bfloat16).prior_dtype == torch.bfloat16
    assert PkpNet(n_stack=1, n_modules=1, features=16).prior_dtype == torch.float32
    assert PkpNet(n_stack=1, n_modules=1, features=16, prior_mode="concat",
                  dtype=torch.bfloat16).prior_dtype == torch.float32


def test_bf16_with_prior_frame_inference_bits(monkeypatch, one_thread):
    """The bf16 with-prior program renders its prior in bf16 and returns the
    bits of the f32 render that the net itself casts."""
    net, hw = _small_bf16_net(), (64, 64)
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.uniform(0, 1, (96, 128, 3)).astype(np.float32))
    boxes = torch.tensor([[10, 8, 70, 60], [40, 30, 120, 90], [0, 0, 16, 16]],
                         dtype=torch.float32)
    valid = torch.tensor([True, True, False])
    prior_uv = torch.from_numpy(rng.uniform(-0.8, 0.8, (3, 41, 2)).astype(np.float32))
    prior_valid = torch.from_numpy(rng.uniform(size=(3, 41)) < 0.5)
    renders = []
    real = thm.render_prior_heatmaps

    def spy(*a, **kw):
        out = real(*a, **kw)
        renders.append(out.dtype)
        return out

    monkeypatch.setattr(thm, "render_prior_heatmaps", spy)
    fn = tk.make_frame_inference(net, hw, device="cpu")
    multi = tk.make_multi_frame_inference(net, hw, device="cpu")
    out = fn(img, boxes, valid, prior_uv, prior_valid)
    out_m = multi(img[None], boxes[None], valid[None], prior_uv[None], prior_valid[None])
    assert renders == [torch.bfloat16, torch.bfloat16]
    phw = net.prior_hw(hw)
    with torch.inference_mode():
        crops = roi.roi_crop_batch(img[None], boxes[None], valid[None], hw)[0]
        prior32 = real(prior_uv, prior_valid, hw=phw, sigma_px=thm.prior_sigma_for(phw))
        ref = net(crops, prior32)
    assert prior32.dtype == torch.float32
    for a, b, m in zip(out, (ref.uv, ref.cov, ref.kp_mask), out_m):
        assert torch.equal(a, b) and torch.equal(m[0], b)
