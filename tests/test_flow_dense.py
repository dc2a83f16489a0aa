"""Dense pyramidal LK vs ground truth and vs OpenCV per-point tracking."""

import cv2 as cv
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lk_tpu.config import LKConfig
from lk_tpu.flow.dense import dense_pyramidal_lk, dense_lk_level


def _natural_image(rng, h, w):
    img = rng.random((h, w)).astype(np.float32) * 255
    img = cv.GaussianBlur(img, (0, 0), 2.0)
    img += cv.GaussianBlur(rng.random((h, w)).astype(np.float32) * 255, (0, 0), 8.0)
    img = (img - img.min()) / (img.max() - img.min()) * 255
    return img.astype(np.float32)


def _shift_image(img, dx, dy):
    m = np.float32([[1, 0, dx], [0, 1, dy]])
    return cv.warpAffine(img, m, (img.shape[1], img.shape[0]),
                         flags=cv.INTER_LINEAR, borderMode=cv.BORDER_REFLECT_101)


class TestDenseLK:
    def test_single_scale_small_shift(self, rng):
        """BASELINE.json config #1: single-scale dense LK on a frame pair."""
        img = _natural_image(rng, 480, 640)
        nxt = _shift_image(img, 0.8, -0.6)
        flow0 = jnp.zeros((480, 640, 2), jnp.float32)
        res = jax.jit(dense_lk_level)(jnp.asarray(img), jnp.asarray(nxt), flow0)
        flow = np.asarray(res.flow)
        valid = np.asarray(res.valid)
        interior = np.zeros_like(valid)
        interior[20:-20, 20:-20] = True
        m = valid & interior
        # ground truth: (-dx, -dy)? no: flow maps prev->next sampling next at
        # p+v matching prev at p, so v = -shift of content = (+0.8, -0.6)?
        # content moved by (dx,dy): next(x) = prev(x - dx) => prev(p) = next(p + dx)
        epe = np.linalg.norm(flow[m] - np.array([0.8, -0.6]), axis=1)
        assert epe.mean() < 0.05, epe.mean()

    def test_pyramidal_large_shift_epe_vs_gt(self, rng):
        img = _natural_image(rng, 480, 640)
        nxt = _shift_image(img, 9.0, 6.5)
        res = jax.jit(lambda a, b: dense_pyramidal_lk(a, b, LKConfig()))(
            jnp.asarray(img), jnp.asarray(nxt)
        )
        flow = np.asarray(res.flow)
        valid = np.asarray(res.valid)
        interior = np.zeros_like(valid)
        interior[30:-30, 30:-30] = True
        m = valid & interior
        epe = np.linalg.norm(flow[m] - np.array([9.0, 6.5]), axis=1)
        assert epe.mean() < 0.1, epe.mean()

    def test_pyramidal_vs_opencv_sparse_grid(self, rng):
        """EPE vs the reference implementation (BASELINE.json metric)."""
        img = _natural_image(rng, 240, 320)
        m = cv.getRotationMatrix2D((160, 120), 1.5, 1.02)
        nxt = cv.warpAffine(img, m, (320, 240), flags=cv.INTER_LINEAR,
                            borderMode=cv.BORDER_REFLECT_101)
        res = jax.jit(lambda a, b: dense_pyramidal_lk(a, b, LKConfig()))(
            jnp.asarray(img), jnp.asarray(nxt)
        )
        flow = np.asarray(res.flow)
        valid = np.asarray(res.valid)

        ys, xs = np.mgrid[30:210:12, 30:290:12]
        pts = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
        p1, st, _ = cv.calcOpticalFlowPyrLK(
            img.astype(np.uint8), nxt.astype(np.uint8),
            pts.reshape(-1, 1, 2), None,
            winSize=(15, 15), maxLevel=2,
            criteria=(cv.TERM_CRITERIA_EPS | cv.TERM_CRITERIA_COUNT, 10, 0.03),
        )
        cv_flow = p1.reshape(-1, 2) - pts
        st = st.reshape(-1).astype(bool)
        ours = flow[pts[:, 1].astype(int), pts[:, 0].astype(int)]
        ok = st & valid[pts[:, 1].astype(int), pts[:, 0].astype(int)]
        epe = np.linalg.norm(ours[ok] - cv_flow[ok], axis=1)
        assert ok.sum() > len(pts) * 0.8
        assert epe.mean() < 0.1, epe.mean()

    def test_video_mode_matches_per_pair(self, rng):
        """dense_pyramidal_lk_video (scanned pyramid carry) == the per-pair
        calls: only redundant pyramid recomputation is eliminated."""
        from lk_tpu.flow.dense import dense_pyramidal_lk_video

        frames = [_natural_image(rng, 96, 160)]
        for t in range(3):
            frames.append(_shift_image(frames[-1], 1.2, -0.8))
        fr = np.stack(frames)
        cfg = LKConfig(max_level=2)
        vid = dense_pyramidal_lk_video(jnp.asarray(fr), cfg)
        assert vid.flow.shape == (3, 96, 160, 2)
        for t in range(3):
            pair = dense_pyramidal_lk(
                jnp.asarray(fr[t]), jnp.asarray(fr[t + 1]), cfg)
            d = np.abs(np.asarray(vid.flow[t]) - np.asarray(pair.flow))
            assert d.max() < 1e-4, (t, d.max())
            assert bool(jnp.all(vid.valid[t] == pair.valid)), t

    def test_video_warm_start_smooth_motion(self, rng):
        """Opt-in temporal warm start tracks smooth constant motion as well
        as the cold schedule (the discontinuity failure mode is documented
        in DenseLKConfig and is why the default is off)."""
        import dataclasses

        from lk_tpu.config import DenseLKConfig
        from lk_tpu.flow.dense import dense_pyramidal_lk_video

        frames = [_natural_image(rng, 96, 160)]
        for t in range(4):
            frames.append(_shift_image(frames[-1], 1.2, -0.8))
        fr = jnp.asarray(np.stack(frames))
        cfg = LKConfig(max_level=2)
        base = DenseLKConfig()
        cold = dense_pyramidal_lk_video(fr, cfg, base)
        warm = dense_pyramidal_lk_video(
            fr, cfg,
            dataclasses.replace(base, video_warm_start=True,
                                warm_top_iters=1))
        for t in range(4):
            f = np.asarray(warm.flow[t])[16:-16, 16:-16]
            err = np.hypot(f[..., 0] - 1.2, f[..., 1] + 0.8).mean()
            cf = np.asarray(cold.flow[t])[16:-16, 16:-16]
            cerr = np.hypot(cf[..., 0] - 1.2, cf[..., 1] + 0.8).mean()
            assert err < max(0.1, cerr * 1.5), (t, err, cerr)

    def test_batched_vmap(self, rng):
        imgs = np.stack([_natural_image(rng, 96, 128) for _ in range(3)])
        nxts = np.stack([_shift_image(im, 1.5, -1.0) for im in imgs])
        fn = jax.jit(jax.vmap(lambda a, b: dense_pyramidal_lk(a, b, LKConfig()).flow))
        flows = np.asarray(fn(jnp.asarray(imgs), jnp.asarray(nxts)))
        assert flows.shape == (3, 96, 128, 2)
        err = np.abs(flows[:, 20:-20, 20:-20] - np.array([1.5, -1.0])).mean()
        assert err < 0.1, err


class TestDenseConfigSchedules:
    def test_level_schedules(self):
        from lk_tpu.config import DenseLKConfig

        d = DenseLKConfig(iter_schedule=(1, 2, 6), outer_iters=9,
                          max_disp=32)
        assert [d.level_iters(lv) for lv in (0, 1, 2, 3)] == [1, 2, 6, 6]
        # an empty schedule falls back to the scalar knob
        d2 = DenseLKConfig(iter_schedule=(), outer_iters=9)
        assert d2.level_iters(2) == 9
        assert [d.level_disp(lv) for lv in (0, 1, 2, 4)] == [32, 16, 8, 4]


def test_multistream_matches_per_stream_video(rng):
    """dense_pyramidal_lk_multistream == per-stream dense_pyramidal_lk_video
    (it is a lax.map of the same program; parity guards the carry
    threading and any future cross-stream batching)."""
    from lk_tpu.flow.dense import (dense_pyramidal_lk_multistream,
                                   dense_pyramidal_lk_video)

    n, t, h, w = 3, 4, 64, 96
    fr = np.empty((n, t, h, w), np.float32)
    for i in range(n):
        img = cv.GaussianBlur(
            (rng.random((h, w)) * 255).astype(np.float32), (0, 0), 2.0)
        for k in range(t):
            m = np.float32([[1, 0, 0.9 * k + 0.3 * i], [0, 1, -0.6 * k]])
            fr[i, k] = cv.warpAffine(img, m, (w, h), flags=cv.INTER_LINEAR,
                                     borderMode=cv.BORDER_REFLECT_101)
    ms = dense_pyramidal_lk_multistream(jnp.asarray(fr))
    for i in range(n):
        single = dense_pyramidal_lk_video(jnp.asarray(fr[i]))
        np.testing.assert_allclose(np.asarray(ms.flow[i]),
                                   np.asarray(single.flow), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(ms.valid[i]),
                                      np.asarray(single.valid))


def test_effective_cfg_depth_clamped_by_window():
    """cv2 caps maxLevel so the top level >= winSize; small frames must
    not build a top level smaller than the LK window (ADVICE r4)."""
    from lk_tpu.config import DenseLKConfig
    from lk_tpu.flow.dense import _effective_cfg

    cfg = LKConfig()  # win 15x15
    dcfg = DenseLKConfig()  # pyramid_levels=4
    assert _effective_cfg(cfg, dcfg, (1080, 1920)).max_level == 3
    # 64 px: 64>>3=8 < 15 -> clamp to 2 levels of halving (16 >= 15)
    assert _effective_cfg(cfg, dcfg, (64, 64)).max_level == 2
    # tiny frame: no pyramid at all
    assert _effective_cfg(cfg, dcfg, (20, 20)).max_level == 0


# --- plain NumPy reference of one inverse-compositional level --------------


def _np_sep(x, taps, axis):
    """Correlate along axis with REFLECT_101 borders (float64)."""
    k = len(taps)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (k // 2, k // 2)
    xp = np.pad(x, pad, mode="reflect")
    n = x.shape[axis]
    return sum(t * np.take(xp, np.arange(i, i + n), axis=axis)
               for i, t in enumerate(taps))


def _np_box(x, win):
    """SAME box sum, zero border, window (w, h) in OpenCV order."""
    win_w, win_h = win
    xp = np.pad(x, (((win_h - 1) // 2, win_h // 2),
                    ((win_w - 1) // 2, win_w // 2)))
    c = np.pad(xp.cumsum(0).cumsum(1), ((1, 0), (1, 0)))
    h, w = x.shape
    return (c[win_h:win_h + h, win_w:win_w + w] - c[:h, win_w:win_w + w]
            - c[win_h:win_h + h, :w] + c[:h, :w])


def _np_bilinear(img, x, y):
    """Exact bilinear sample at (x, y), coordinates clamped to the frame."""
    h, w = img.shape
    x = np.clip(x, 0, w - 1)
    y = np.clip(y, 0, h - 1)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx, fy = x - x0, y - y0
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def _np_level(prev, nxt, flow0, win, iters, r, thr=1e-4, eps=0.03):
    prev = prev.astype(np.float64)
    nxt = nxt.astype(np.float64)
    smooth, diff = (3 / 16, 10 / 16, 3 / 16), (-0.5, 0.0, 0.5)
    ix = _np_sep(_np_sep(prev, smooth, 0), diff, 1)
    iy = _np_sep(_np_sep(prev, smooth, 1), diff, 0)
    a11, a12, a22 = (_np_box(ix * ix, win), _np_box(ix * iy, win),
                     _np_box(iy * iy, win))
    det = a11 * a22 - a12 * a12
    min_eig = (a22 + a11 - np.sqrt((a11 - a22) ** 2 + 4 * a12 * a12)) / (
        2.0 * win[0] * win[1])
    valid = (min_eig >= thr * 1024.0) & (det > 1e-7)
    inv_det = np.where(valid, 1.0 / np.where(valid, det, 1.0), 0.0)
    h, w = prev.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    u, v = (flow0[..., 0].astype(np.float64),
            flow0[..., 1].astype(np.float64))
    active = np.ones((h, w), bool)
    for _ in range(iters):
        jw = _np_bilinear(nxt, xs + np.clip(u, -r, r), ys + np.clip(v, -r, r))
        res = jw - prev - (ix * u + iy * v)
        b1 = _np_box(ix * res, win) + a11 * u + a12 * v
        b2 = _np_box(iy * res, win) + a12 * u + a22 * v
        du = (a12 * b2 - a22 * b1) * inv_det
        dv = (a12 * b1 - a11 * b2) * inv_det
        upd = active & valid
        u = np.clip(np.where(upd, u + du, u), -r, r)
        v = np.clip(np.where(upd, v + dv, v), -r, r)
        active &= du * du + dv * dv > eps * eps
    return np.stack([u, v], -1), valid


@pytest.mark.parametrize("iters", [1, 3, 6])
@pytest.mark.parametrize("win", [(7, 7), (15, 15), (9, 15)])
def test_level_matches_numpy_reference(rng, win, iters):
    """The XLA level solve == a float64 NumPy transcription of the
    inverse-compositional update, over window x iteration count."""
    from lk_tpu.config import DenseLKConfig
    from lk_tpu.io.scenes import affine_scene, zoom_rot_map

    h, w = 72, 104
    sc = affine_scene(rng, h, w, zoom_rot_map(h, w, 1.01, 0.8), n_frames=2)
    flow0 = np.zeros((h, w, 2), np.float32)
    flow0[..., 0] = 0.4
    res = dense_lk_level(jnp.asarray(sc.frames[0]), jnp.asarray(sc.frames[1]),
                         jnp.asarray(flow0), LKConfig(win_size=win),
                         DenseLKConfig(outer_iters=iters), max_disp=8)
    ref, ref_valid = _np_level(sc.frames[0], sc.frames[1], flow0, win,
                               iters, 8)
    np.testing.assert_array_equal(np.asarray(res.valid), ref_valid)
    d = np.linalg.norm(np.asarray(res.flow) - ref, axis=-1)
    # f32 vs f64: per-pixel eps-freeze decisions may flip by one step
    assert d.mean() < 1e-3, d.mean()
    assert np.percentile(d, 99) < 1e-2, np.percentile(d, 99)


def _np_warp(img, flow, r):
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    f = np.clip(flow.astype(np.float64), -r, r)
    return _np_bilinear(img.astype(np.float64), xs + f[..., 0],
                        ys + f[..., 1])


@pytest.mark.parametrize("beyond", [False, True])
@pytest.mark.parametrize("r", [4, 8, 32])
def test_bounded_warp_matches_exact_bilinear(rng, r, beyond):
    """The level solve's warp == exact bilinear of the edge-clamped frame
    at the flow clamped to +-r (displacements beyond r saturate)."""
    from lk_tpu.flow.dense import _bounded_warp

    h, w = 48, 80
    img = (rng.random((h, w)) * 255).astype(np.float32)
    scale = 2.5 * r if beyond else 0.98 * r
    flow = ((rng.random((h, w, 2)) * 2 - 1) * scale).astype(np.float32)
    got = np.asarray(_bounded_warp(jnp.asarray(img), jnp.asarray(flow), r))
    np.testing.assert_allclose(got, _np_warp(img, flow, r), atol=2e-3)


@pytest.mark.parametrize("h,w", [(67, 99), (91, 160), (108, 192), (135, 240)])
def test_video_chain_matches_per_pair_sizes(rng, h, w):
    """dense_pyramidal_lk_video == per-pair dense_pyramidal_lk at odd and
    1080p-aspect sizes (ceil-halved odd levels, depth clamped by window)."""
    from lk_tpu.flow.dense import dense_pyramidal_lk_video
    from lk_tpu.io.scenes import affine_scene, shift_map

    fr = affine_scene(rng, h, w, shift_map(1.4, -0.9), n_frames=3).frames
    vid = dense_pyramidal_lk_video(jnp.asarray(fr))
    assert vid.flow.shape == (2, h, w, 2)
    for t in range(2):
        pair = dense_pyramidal_lk(jnp.asarray(fr[t]), jnp.asarray(fr[t + 1]))
        np.testing.assert_allclose(np.asarray(vid.flow[t]),
                                   np.asarray(pair.flow), atol=1e-4)
        np.testing.assert_array_equal(np.asarray(vid.valid[t]),
                                      np.asarray(pair.valid))


# --- TF32 emulation: DEFAULT-precision matmuls on tensor-core GPUs ----------


def _tf32(x):
    """Round f32 to TF32 (10 explicit mantissa bits), nearest-even."""
    b = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    b = (b + jnp.uint32(0xFFF) + ((b >> 13) & 1)) & jnp.uint32(0xFFFFE000)
    return jax.lax.bitcast_convert_type(b, jnp.float32)


@pytest.fixture
def tf32_dots(monkeypatch):
    """Every jax.lax.dot_general call rounds its operands to TF32 (what a
    DEFAULT-precision f32 matmul does on a tensor-core GPU)."""
    orig = jax.lax.dot_general

    def dot(a, b, dimension_numbers, precision=None,
            preferred_element_type=None, **kw):
        return orig(_tf32(a), _tf32(b), dimension_numbers,
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jax.lax, "dot_general", dot)


@pytest.mark.parametrize("shape", [(37, 53), (135, 240), (270, 480)])
def test_pyr_down_fast_tf32_vs_cv2(rng, tf32_dots, shape):
    """pyr_down(fast=True) with TF32-rounded operands stays within 0.5
    intensity of cv.pyrDown (the documented fast-path budget)."""
    from lk_tpu.ops.blur import pyr_down

    img = (rng.random(shape) * 255).astype(np.float32)
    got = np.asarray(jax.jit(lambda x: pyr_down(x, fast=True))(
        jnp.asarray(img)))
    ref = cv.pyrDown(img)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err < 0.5, err
    assert err > 0.0   # the emulation really rounded something


@pytest.mark.parametrize("scene", ["shift", "zoom+rot"])
def test_dense_epe_gate_tf32(rng, tf32_dots, scene):
    """The dense EPE gate (< 0.1 px vs exact ground truth, bench.py's
    limit) holds with the coarse pyramid's matmuls rounded to TF32."""
    from lk_tpu.flow.dense import dense_pyramidal_lk_video
    from lk_tpu.io.scenes import (affine_scene, grid_epe, shift_map,
                                  zoom_rot_map)

    h, w = 216, 384
    m = (shift_map(3.7, -2.2) if scene == "shift"
         else zoom_rot_map(h, w, 1.004, 0.3))
    sc = affine_scene(rng, h, w, m, n_frames=2)
    flow = np.asarray(jax.jit(lambda f: dense_pyramidal_lk_video(f).flow)(
        jnp.asarray(sc.frames)))[0]
    epe = grid_epe(flow, sc.gt, step=8)
    assert epe < 0.1, epe
