"""ops/ primitives vs the OpenCV oracle (SURVEY.md §4: OpenCV is the kernel oracle)."""

import cv2 as cv
import numpy as np
import pytest

import jax.numpy as jnp

from lk_tpu import ops
from lk_tpu.config import ROIConfig


def _rand_u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


class TestColor:
    def test_gray_u8_bit_exact(self, rng):
        img = _rand_u8(rng, (64, 96, 3))
        ours = np.asarray(ops.bgr_to_gray_u8(jnp.asarray(img)))
        ref = cv.cvtColor(img, cv.COLOR_BGR2GRAY)
        np.testing.assert_array_equal(ours, ref)

    def test_gray_float_close(self, rng):
        img = _rand_u8(rng, (64, 96, 3)).astype(np.float32)
        ours = np.asarray(ops.bgr_to_gray(jnp.asarray(img)))
        ref = cv.cvtColor(img, cv.COLOR_BGR2GRAY)
        assert np.abs(ours - ref).max() < 2e-3

    def test_gray_batched(self, rng):
        img = _rand_u8(rng, (3, 16, 16, 3)).astype(np.float32)
        out = np.asarray(ops.bgr_to_gray(jnp.asarray(img)))
        assert out.shape == (3, 16, 16)


class TestBlur:
    def test_gaussian3_f32_bit_exact(self, rng):
        img = _rand_u8(rng, (47, 61)).astype(np.float32)
        ours = np.asarray(ops.gaussian_blur3(jnp.asarray(img)))
        ref = cv.GaussianBlur(img, (3, 3), 0)
        np.testing.assert_allclose(ours, ref, atol=1e-3)

    def test_pyr_down_f32_exact(self, rng):
        img = _rand_u8(rng, (37, 53)).astype(np.float32)
        ours = np.asarray(ops.pyr_down(jnp.asarray(img)))
        ref = cv.pyrDown(img)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=1e-3)

    def test_pyramid_shapes(self, rng):
        img = _rand_u8(rng, (100, 173)).astype(np.float32)
        levels = ops.gaussian_pyramid(jnp.asarray(img), max_level=2)
        assert [lv.shape for lv in levels] == [(100, 173), (50, 87), (25, 44)]


class TestResize:
    @pytest.mark.parametrize("src,dst", [((108, 192), (48, 86)), ((72, 128), (54, 96))])
    def test_area_matches_cv(self, rng, src, dst):
        img = _rand_u8(rng, src).astype(np.float32)
        ours = np.asarray(ops.resize_area(jnp.asarray(img), *dst))
        ref = cv.resize(img, (dst[1], dst[0]), interpolation=cv.INTER_AREA)
        np.testing.assert_allclose(ours, ref, atol=1e-2)

    def test_linear_matches_cv(self, rng):
        img = _rand_u8(rng, (60, 90)).astype(np.float32)
        ours = np.asarray(ops.resize_linear(jnp.asarray(img), 45, 70))
        ref = cv.resize(img, (70, 45), interpolation=cv.INTER_LINEAR)
        np.testing.assert_allclose(ours, ref, atol=1e-2)


class TestGradients:
    def test_scharr_interior(self, rng):
        img = _rand_u8(rng, (40, 50)).astype(np.float32)
        ix, iy = ops.scharr_derivatives(jnp.asarray(img))
        # OpenCV Scharr with scale 1/32 equals our normalized kernel.
        rx = cv.Scharr(img, cv.CV_32F, 1, 0, scale=1 / 32.0)
        ry = cv.Scharr(img, cv.CV_32F, 0, 1, scale=1 / 32.0)
        np.testing.assert_allclose(np.asarray(ix)[2:-2, 2:-2], rx[2:-2, 2:-2], atol=1e-3)
        np.testing.assert_allclose(np.asarray(iy)[2:-2, 2:-2], ry[2:-2, 2:-2], atol=1e-3)


class TestWarp:
    def test_identity_flow(self, rng):
        img = _rand_u8(rng, (30, 40)).astype(np.float32)
        flow = np.zeros((30, 40, 2), np.float32)
        out = np.asarray(ops.warp_by_flow(jnp.asarray(img), jnp.asarray(flow)))
        np.testing.assert_allclose(out, img, atol=1e-5)

    def test_integer_translation(self, rng):
        img = _rand_u8(rng, (30, 40)).astype(np.float32)
        flow = np.full((30, 40, 2), 3.0, np.float32)
        out = np.asarray(ops.warp_by_flow(jnp.asarray(img), jnp.asarray(flow)))
        np.testing.assert_allclose(out[:-3, :-3], img[3:, 3:], atol=1e-4)

    def test_subpixel_against_cv_remap(self, rng):
        img = _rand_u8(rng, (33, 44)).astype(np.float32)
        h, w = img.shape
        xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        mx = xs + 0.37
        my = ys + 1.21
        ref = cv.remap(img, mx, my, cv.INTER_LINEAR, borderMode=cv.BORDER_REPLICATE)
        out = np.asarray(ops.bilinear_sample(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my)))
        np.testing.assert_allclose(out[2:-2, 2:-2], ref[2:-2, 2:-2], atol=2e-3)

    def test_extract_patch_matches_window(self, rng):
        img = _rand_u8(rng, (50, 60)).astype(np.float32)
        center = jnp.asarray([22.4, 17.8])
        patch = np.asarray(ops.extract_patch(jnp.asarray(img), center, (15, 15)))
        # Oracle: bilinear sample each window coordinate directly.
        ys = np.arange(15) - 7.0 + 17.8
        xs = np.arange(15) - 7.0 + 22.4
        mx, my = np.meshgrid(xs.astype(np.float32), ys.astype(np.float32), indexing="xy")
        ref = cv.remap(img, mx.astype(np.float32), my.astype(np.float32), cv.INTER_LINEAR)
        np.testing.assert_allclose(patch, ref.T.T, atol=2e-3)


class TestBoxSum:
    def test_matches_cv_boxfilter(self, rng):
        img = _rand_u8(rng, (32, 45)).astype(np.float32)
        out = np.asarray(ops.box_sum(jnp.asarray(img), (15, 15)))
        ref = cv.boxFilter(img, cv.CV_32F, (15, 15), normalize=False,
                           borderType=cv.BORDER_CONSTANT)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-2)

    def test_pyr_down_fast_matches_exact(self, rng):
        from lk_tpu.ops.blur import pyr_down

        img = _rand_u8(rng, (67, 101)).astype(np.float32)
        exact = np.asarray(pyr_down(jnp.asarray(img)))
        fast = np.asarray(pyr_down(jnp.asarray(img), fast=True))
        # identical math; DEFAULT matmul precision may additionally round
        # the operands (TF32 on GPUs, <= 0.5 intensity) — tolerance covers
        # both
        np.testing.assert_allclose(fast, exact, atol=1.0)
        assert fast.shape == exact.shape == (34, 51)
        # batched layout
        xb = jnp.asarray(rng.random((2, 36, 52)).astype(np.float32) * 255)
        np.testing.assert_allclose(
            np.asarray(pyr_down(xb, fast=True)), np.asarray(pyr_down(xb)),
            atol=1.0,
        )


class TestRasterize:
    def test_roi_masks_close_to_fillpoly(self):
        from lk_tpu.ops.rasterize import build_roi_masks, roi_mask_points

        width, height = 860, 483
        full, subs = build_roi_masks(width, height, ROIConfig())
        p = roi_mask_points(width, height, ROIConfig())
        ref = np.zeros((height, width), np.uint8)
        ref = cv.fillPoly(ref, [p[[1, 3, 5, 7]]], 255)
        ours = np.asarray(full) > 0
        refb = ref > 0
        # Identical away from polygon boundary; allow a thin boundary band.
        mismatch = np.count_nonzero(ours != refb)
        boundary = cv.polylines(np.zeros_like(ref), [p[[1, 3, 5, 7]]], True, 255, 3)
        assert mismatch <= np.count_nonzero(boundary)
        # sub-masks tile the full trapezoid (interior)
        union = np.asarray(subs).max(axis=0) > 0
        interior = cv.erode(ref, np.ones((5, 5), np.uint8)) > 0
        assert (union | ~interior).all()

    def test_tone_curve_matches_reference_formula(self, rng):
        img = _rand_u8(rng, (16, 16)).astype(np.float32)
        out = np.asarray(ops.contrast_brightness(jnp.asarray(img), 0, 100))
        import math

        k = math.tan((45 + 44 * (100 / 255.0)) / 180 * math.pi)
        ref = np.clip((img - 127.5) * k + 127.5, 0, 255)
        np.testing.assert_allclose(out, ref, atol=1e-3)


@pytest.mark.parametrize("tone", [False, True])
@pytest.mark.parametrize("shape", [(483, 860), (242, 430), (37, 53)])
def test_finish_chain_matches_cv2(rng, shape, tone):
    """The serving finish (u8 -> f32 [+ tone curve] + 3x3 Gaussian, one
    XLA chain) == cv.GaussianBlur of the same float frame."""
    import dataclasses
    import math

    from lk_tpu.config import PipelineConfig
    from lk_tpu.pipeline.runner import _cached_finish

    cfg = dataclasses.replace(PipelineConfig(), contrast_enhance=tone)
    u8 = _rand_u8(rng, (2,) + shape)
    got = np.asarray(_cached_finish(cfg)(jnp.asarray(u8)))
    for i in range(2):
        x = u8[i].astype(np.float32)
        if tone:
            k = math.tan((45 + 44 * (100 / 255.0)) / 180 * math.pi)
            x = np.clip((x - 127.5) * np.float32(k) + 127.5, 0, 255).astype(
                np.float32)
        ref = cv.GaussianBlur(x, (3, 3), 0)
        np.testing.assert_allclose(got[i], ref, atol=1e-3 if tone else 1e-4)
