"""Sparse LK tracker vs cv.calcOpticalFlowPyrLK (the kernel oracle, SURVEY.md §4)."""

import cv2 as cv
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lk_tpu.config import LKConfig
from lk_tpu.flow.sparse import track_points

LK_PARAMS = dict(
    winSize=(15, 15),
    maxLevel=2,
    criteria=(cv.TERM_CRITERIA_EPS | cv.TERM_CRITERIA_COUNT, 10, 0.03),
)


def _natural_image(rng, h, w):
    """Smooth-ish random texture: blurred noise with structure at all scales."""
    img = rng.random((h, w)).astype(np.float32) * 255
    img = cv.GaussianBlur(img, (0, 0), 2.0)
    img += cv.GaussianBlur(rng.random((h, w)).astype(np.float32) * 255, (0, 0), 8.0)
    img = (img - img.min()) / (img.max() - img.min()) * 255
    return img.astype(np.float32)


def _shift_image(img, dx, dy):
    m = np.float32([[1, 0, dx], [0, 1, dy]])
    return cv.warpAffine(
        img, m, (img.shape[1], img.shape[0]), flags=cv.INTER_LINEAR,
        borderMode=cv.BORDER_REFLECT_101,
    )


def _track_cv(prev, nxt, pts):
    p0 = pts.reshape(-1, 1, 2).astype(np.float32)
    p1, st, err = cv.calcOpticalFlowPyrLK(
        prev.astype(np.uint8), nxt.astype(np.uint8), p0, None, **LK_PARAMS
    )
    return p1.reshape(-1, 2), st.reshape(-1).astype(bool), err.reshape(-1)


def _track_ours(prev, nxt, pts):
    # cv2 path above consumes uint8; feed our tracker the identical images.
    prev8 = prev.astype(np.uint8).astype(np.float32)
    nxt8 = nxt.astype(np.uint8).astype(np.float32)
    valid = jnp.ones(len(pts), dtype=bool)
    fn = jax.jit(lambda a, b, p, v: track_points(a, b, p, v, LKConfig()))
    p1, st, err = fn(jnp.asarray(prev8), jnp.asarray(nxt8), jnp.asarray(pts), valid)
    return np.asarray(p1), np.asarray(st), np.asarray(err)


@pytest.fixture
def scene(rng):
    img = _natural_image(rng, 240, 320)
    pts = np.stack(
        np.meshgrid(np.linspace(40, 280, 7), np.linspace(40, 200, 5)), -1
    ).reshape(-1, 2).astype(np.float32)
    return img, pts


class TestSparseVsOpenCV:
    @pytest.mark.parametrize("shift", [(1.0, 0.5), (3.7, -2.2), (8.5, 5.25)])
    def test_translation_epe(self, scene, shift):
        img, pts = scene
        nxt = _shift_image(img, *shift)
        ours_p, ours_st, _ = _track_ours(img, nxt, pts)
        cv_p, cv_st, _ = _track_cv(img, nxt, pts)
        both = ours_st & cv_st
        assert both.sum() >= len(pts) * 0.8
        epe_vs_cv = np.linalg.norm(ours_p[both] - cv_p[both], axis=1)
        assert epe_vs_cv.mean() < 0.1, epe_vs_cv.mean()
        gt = pts[both] + np.array(shift)
        epe_gt = np.linalg.norm(ours_p[both] - gt, axis=1)
        assert epe_gt.mean() < 0.25, epe_gt.mean()

    def test_rotation_zoom(self, scene, rng):
        img, pts = scene
        m = cv.getRotationMatrix2D((160, 120), 2.0, 1.03)
        nxt = cv.warpAffine(img, m, (320, 240), flags=cv.INTER_LINEAR,
                            borderMode=cv.BORDER_REFLECT_101)
        ours_p, ours_st, _ = _track_ours(img, nxt, pts)
        cv_p, cv_st, _ = _track_cv(img, nxt, pts)
        both = ours_st & cv_st
        assert both.sum() >= len(pts) * 0.7
        epe = np.linalg.norm(ours_p[both] - cv_p[both], axis=1)
        assert epe.mean() < 0.1, epe.mean()

    def test_status_on_flat_region(self, rng):
        img = np.full((120, 160), 128.0, np.float32)
        img[20:40, 20:40] += 60  # one textured corner
        nxt = _shift_image(img, 1.0, 1.0)
        pts = np.array([[80.0, 80.0], [20.0, 20.0]], np.float32)  # flat, corner
        ours_p, ours_st, _ = _track_ours(img, nxt, pts)
        assert not ours_st[0]  # flat region: min-eig gate trips
        assert ours_st[1]

    def test_status_out_of_bounds(self, scene):
        img, _ = scene
        nxt = _shift_image(img, 2.0, 0.0)
        pts = np.array([[1.0, 1.0], [160.0, 120.0]], np.float32)
        ours_p, ours_st, _ = _track_ours(img, nxt, pts)
        cv_p, cv_st, _ = _track_cv(img, nxt, pts)
        # interior point agrees; the border point's status matches OpenCV
        assert ours_st[1] and cv_st[1]
        np.testing.assert_allclose(ours_p[1], cv_p[1], atol=0.1)

    def test_invalid_slots_passthrough(self, scene):
        img, pts = scene
        nxt = _shift_image(img, 1.0, 1.0)
        valid = np.zeros(len(pts), dtype=bool)
        valid[:3] = True
        p1, st, err = track_points(
            jnp.asarray(img), jnp.asarray(nxt), jnp.asarray(pts),
            jnp.asarray(valid), LKConfig(),
        )
        assert not np.asarray(st)[3:].any()
        np.testing.assert_array_equal(np.asarray(p1)[3:], pts[3:])

    def test_err_magnitude(self, scene):
        img, pts = scene
        nxt = _shift_image(img, 2.0, 1.0)
        _, ours_st, ours_err = _track_ours(img, nxt, pts)
        _, cv_st, cv_err = _track_cv(img, nxt, pts)
        both = ours_st & cv_st
        # err is mean-abs-window-diff in intensity units; same scale as OpenCV.
        assert np.abs(ours_err[both] - cv_err[both]).mean() < 1.0


class TestNonDefaultParams:
    @pytest.mark.parametrize("win,max_level", [((9, 9), 1), ((21, 21), 3)])
    def test_epe_other_configs(self, scene, win, max_level):
        """The tracker must hold parity away from the reference's (15,15)/2."""
        img, pts = scene
        nxt = _shift_image(img, 4.2, -3.1)
        cfg = LKConfig(win_size=win, max_level=max_level)
        valid = jnp.ones(len(pts), dtype=bool)
        p1, st, _ = jax.jit(
            lambda a, b, p, v: track_points(a, b, p, v, cfg)
        )(jnp.asarray(img.astype(np.uint8).astype(np.float32)),
          jnp.asarray(nxt.astype(np.uint8).astype(np.float32)),
          jnp.asarray(pts), valid)
        cv_p1, cv_st, _ = cv.calcOpticalFlowPyrLK(
            img.astype(np.uint8), nxt.astype(np.uint8),
            pts.reshape(-1, 1, 2), None,
            winSize=win, maxLevel=max_level,
            criteria=(cv.TERM_CRITERIA_EPS | cv.TERM_CRITERIA_COUNT, 10, 0.03),
        )
        cv_p1 = cv_p1.reshape(-1, 2)
        cv_st = cv_st.reshape(-1).astype(bool)
        both = np.asarray(st) & cv_st
        assert both.sum() >= len(pts) * 0.7
        epe = np.linalg.norm(np.asarray(p1)[both] - cv_p1[both], axis=1)
        assert epe.mean() < 0.15, epe.mean()


def test_batched_matches_per_stream(rng):
    """track_points_batched (row-folded) == track_points per stream."""
    import cv2 as cv

    from lk_tpu.flow.sparse import track_points, track_points_batched

    b, h, w, n = 3, 120, 200, 12
    prevs, nxts, ptss = [], [], []
    for s in range(b):
        img = (rng.random((h, w)) * 255).astype(np.float32)
        img = cv.GaussianBlur(img, (0, 0), 1.5)
        m = np.float32([[1, 0, 2.0 + s], [0, 1, -1.0 + 0.5 * s]])
        nxt = cv.warpAffine(img, m, (w, h), flags=cv.INTER_LINEAR,
                            borderMode=cv.BORDER_REFLECT_101)
        pts = np.stack([
            rng.uniform(12, w - 12, n), rng.uniform(12, h - 12, n)
        ], -1).astype(np.float32)
        prevs.append(img)
        nxts.append(nxt)
        ptss.append(pts)
    valid = np.ones((b, n), bool)
    valid[1, -2:] = False

    bp, bs, be = track_points_batched(
        jnp.asarray(np.stack(prevs)), jnp.asarray(np.stack(nxts)),
        jnp.asarray(np.stack(ptss)), jnp.asarray(valid))
    for s in range(b):
        sp, ss, se = track_points(
            jnp.asarray(prevs[s]), jnp.asarray(nxts[s]),
            jnp.asarray(ptss[s]), jnp.asarray(valid[s]))
        np.testing.assert_allclose(np.asarray(bp[s]), np.asarray(sp),
                                   atol=1e-4, err_msg=f"stream {s}")
        np.testing.assert_array_equal(np.asarray(bs[s]), np.asarray(ss))
        np.testing.assert_allclose(np.asarray(be[s]), np.asarray(se),
                                   atol=1e-3)


def test_batched_fast_pyramid_parity(rng):
    """fast_pyramid (banded-matmul coarse levels at DEFAULT precision)
    stays within the OpenCV parity budget: the level-0 refinement sees the
    exact frames either way."""
    import cv2 as cv
    import dataclasses

    from lk_tpu.config import LKConfig
    from lk_tpu.flow.sparse import track_points_batched

    b, h, w, n = 2, 120, 200, 12
    prevs, nxts, ptss = [], [], []
    for s in range(b):
        img = (rng.random((h, w)) * 255).astype(np.float32)
        img = cv.GaussianBlur(img, (0, 0), 1.5)
        m = np.float32([[1, 0, 5.0], [0, 1, -3.5]])
        nxt = cv.warpAffine(img, m, (w, h), flags=cv.INTER_LINEAR,
                            borderMode=cv.BORDER_REFLECT_101)
        pts = np.stack([
            rng.uniform(16, w - 16, n), rng.uniform(16, h - 16, n)
        ], -1).astype(np.float32)
        prevs.append(img)
        nxts.append(nxt)
        ptss.append(pts)
    valid = jnp.ones((b, n), bool)
    exact, es, _ = track_points_batched(
        jnp.asarray(np.stack(prevs)), jnp.asarray(np.stack(nxts)),
        jnp.asarray(np.stack(ptss)), valid)
    fast, fs, _ = track_points_batched(
        jnp.asarray(np.stack(prevs)), jnp.asarray(np.stack(nxts)),
        jnp.asarray(np.stack(ptss)), valid,
        dataclasses.replace(LKConfig(), fast_pyramid=True))
    both = np.asarray(es) & np.asarray(fs)
    d = np.linalg.norm(np.asarray(exact) - np.asarray(fast), axis=-1)[both]
    assert d.mean() < 0.02 and d.max() < 0.1, (d.mean(), d.max())


def test_row_band_exit_and_reenter_parity(rng):
    """Points leaving the band's ROI rows mid-track (the VERDICT corner:
    exit and possibly re-enter across the band margin in ONE frame) track
    identically banded and unbanded while the motion stays inside the
    documented envelope (_BAND_MARGIN fetch slack), and produce NO false
    in-band survivors beyond it.

    Scene: strong DOWNWARD shifts push points seeded at the band's bottom
    edge well outside the band rows; one shift is also beyond what LK can
    track so status parity is exercised too."""
    import cv2 as cv

    from lk_tpu.flow.sparse import track_points_batched

    h, w, n = 256, 512, 10
    band = (96, 160)
    img = (rng.random((h, w)) * 255).astype(np.float32)
    img = cv.GaussianBlur(img, (0, 0), 1.8)
    for dy in (12.0, 24.0, 40.0, 80.0):
        m = np.float32([[1, 0, 3.0], [0, 1, dy]])
        nxt = cv.warpAffine(img, m, (w, h), flags=cv.INTER_LINEAR,
                            borderMode=cv.BORDER_REFLECT_101)
        # points hugging the band's bottom rows: their true targets land
        # dy rows BELOW the band (outside it for every dy here)
        pts = np.stack([
            rng.uniform(32, w - 32, n),
            rng.uniform(band[1] - 10, band[1] - 2, n),
        ], -1).astype(np.float32)
        valid = jnp.ones((1, n), bool)
        args = (jnp.asarray(img[None]), jnp.asarray(nxt[None]),
                jnp.asarray(pts[None]), valid)
        up, us, _ = track_points_batched(*args)
        bp, bs, _ = track_points_batched(*args, row_band=band)
        up, us = np.asarray(up[0]), np.asarray(us[0])
        bp, bs = np.asarray(bp[0]), np.asarray(bs[0])
        if dy <= 40.0:
            # inside the envelope (level-0 crop reaches r1 + 64 = 224;
            # targets + the 24-row superwindow stay under it): bit-for-bit
            # the same track
            np.testing.assert_array_equal(bs, us, err_msg=f"dy={dy}")
            np.testing.assert_allclose(bp, up, atol=1e-4,
                                       err_msg=f"dy={dy}")
        else:
            # beyond the envelope the banded crop may clamp — but it must
            # not RESCUE points: anything the banded tracker reports as
            # alive landing back inside the band rows must agree with the
            # unbanded tracker (no false in-band survivors)
            inband = bs & (bp[:, 1] >= band[0]) & (bp[:, 1] < band[1])
            assert not inband.any() or (
                us[inband].all()
                and np.allclose(bp[inband], up[inband], atol=0.5)
            ), (bp[inband], up[inband])


def test_row_band_tracker_parity(rng):
    """track_points_batched with a row_band covering the points ==
    unbanded, bit-for-bit (band-cropped levels + band-relative memory
    coords; pipeline serving crops to the ROI row band)."""
    from lk_tpu.flow.sparse import track_points_batched

    b, n, h, w = 2, 6, 140, 160
    prev = (rng.random((b, h, w)) * 255).astype(np.float32)
    nxt = np.roll(prev, (2, -1), axis=(1, 2))
    # points confined to a mid-frame row band (the ROI situation)
    pts = np.stack([rng.uniform(20, w - 20, (b, n)),
                    rng.uniform(60, 86, (b, n))], -1).astype(np.float32)
    val = np.ones((b, n), bool)
    args = (jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts),
            jnp.asarray(val))
    ref = track_points_batched(*args)
    banded = track_points_batched(*args, row_band=(58, 88))
    for x, y in zip(banded, ref):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("fast_pyramid", [False, True])
@pytest.mark.parametrize("row_band", [None, (40, 100)])
@pytest.mark.parametrize("b,n", [(1, 5), (3, 12)])
def test_batched_plain_matches_per_stream(rng, b, n, row_band, fast_pyramid):
    """The plain batched tracker (vmapped dynamic_slice windows) ==
    per-stream track_points over batch size, point count, row band and
    fast pyramid (the fast coarse levels stay within the parity budget)."""
    import dataclasses

    from lk_tpu.config import LKConfig
    from lk_tpu.flow.sparse import track_points, track_points_batched
    from lk_tpu.io.scenes import affine_scene, shift_map

    h, w = 140, 176
    prevs, nxts = [], []
    for s in range(b):
        sc = affine_scene(rng, h, w, shift_map(1.5 + 0.5 * s, -1.0),
                          n_frames=2)
        prevs.append(sc.frames[0])
        nxts.append(sc.frames[1])
    lo, hi = (40, 100) if row_band else (16, h - 16)
    pts = np.stack([rng.uniform(16, w - 16, (b, n)),
                    rng.uniform(lo + 4, hi - 4, (b, n))], -1).astype(
        np.float32)
    valid = np.ones((b, n), bool)
    valid[0, -1] = False
    cfg = dataclasses.replace(LKConfig(), fast_pyramid=fast_pyramid)
    bp, bs, be = track_points_batched(
        jnp.asarray(np.stack(prevs)), jnp.asarray(np.stack(nxts)),
        jnp.asarray(pts), jnp.asarray(valid), cfg, row_band=row_band)
    tol = 0.1 if fast_pyramid else 1e-4
    for s in range(b):
        sp, ss, _ = track_points(jnp.asarray(prevs[s]), jnp.asarray(nxts[s]),
                                 jnp.asarray(pts[s]), jnp.asarray(valid[s]))
        np.testing.assert_array_equal(np.asarray(bs[s]), np.asarray(ss))
        ok = np.asarray(ss)
        np.testing.assert_allclose(np.asarray(bp[s])[ok], np.asarray(sp)[ok],
                                   atol=tol, err_msg=f"stream {s}")
    assert np.isfinite(np.asarray(be)).all()
