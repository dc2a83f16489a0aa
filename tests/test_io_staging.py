"""Host staging and the synthetic source (numpy/scipy) vs their OpenCV
forms: BGR->gray and INTER_AREA resize bit-equal, the generator within
warpAffine's 1/32-px coordinate quantization (+-1 u8)."""

import cv2 as cv
import numpy as np
import pytest

from lk_tpu.io.staging import bgr_to_gray_u8, resize_area_u8, stage_gray
from lk_tpu.io.video import SyntheticRoadStream


def _old_stream(width, height, vp=None, zoom=1.02, seed=0):
    """SyntheticRoadStream's previous OpenCV implementation (oracle)."""
    vp = vp if vp is not None else (width * 0.5, height * 0.45)
    rng = np.random.default_rng(seed)
    th, tw = int(height * 1.6), int(width * 1.6)
    tex = rng.random((th, tw)).astype(np.float32) * 255
    tex = cv.GaussianBlur(tex, (0, 0), 1.5)
    tex += cv.GaussianBlur(
        rng.random((th, tw)).astype(np.float32) * 255, (0, 0), 6.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255
    ox, oy = (tw - width) / 2.0, (th - height) / 2.0

    def frame(t):
        s = zoom ** (-t)
        m = np.float32([[s, 0, (1 - s) * vp[0] + ox],
                        [0, s, (1 - s) * vp[1] + oy]])
        g = cv.warpAffine(tex, m, (width, height),
                          flags=cv.INTER_LINEAR | cv.WARP_INVERSE_MAP,
                          borderMode=cv.BORDER_REFLECT_101)
        return np.clip(g, 0, 255).astype(np.uint8)

    return tex, frame


@pytest.mark.parametrize("w,h,zoom,seed", [(860, 484, 1.03, 42),
                                           (430, 242, 1.05, 3),
                                           (1280, 720, 1.02, 0)])
def test_generator_matches_opencv_form(w, h, zoom, seed):
    new = SyntheticRoadStream(width=w, height=h, zoom=zoom, seed=seed)
    tex, old = _old_stream(w, h, zoom=zoom, seed=seed)
    # scipy's gaussian_filter (truncate 4, mirror) == cv2's sigma kernels
    assert np.abs(new.tex - tex).max() < 1e-3
    for t in (0, 7, 39):
        d = np.abs(new.frame_gray(t).astype(int) - old(t))
        assert d.max() <= 1, (t, d.max())
        assert (d > 0).mean() < 2e-3, (t, (d > 0).mean())
    f = new.frame(3)
    assert f.shape == (h, w, 3) and f.dtype == np.uint8
    assert (f[..., 0] == f[..., 2]).all()


def test_generator_off_center_vp_and_gray_mode():
    s = SyntheticRoadStream(width=200, height=120, vp=(40.0, 90.0),
                            zoom=1.1, seed=5, n_frames=3, color=False)
    _, old = _old_stream(200, 120, vp=(40.0, 90.0), zoom=1.1, seed=5)
    frames = list(s)
    assert len(frames) == 3 and frames[0].shape == (120, 200)
    for t, f in enumerate(frames):
        assert np.abs(f.astype(int) - old(t)).max() <= 1


def test_gray_bit_equal(rng):
    for shape in [(64, 96, 3), (2, 17, 33, 3)]:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        ref = (cv.cvtColor(img, cv.COLOR_BGR2GRAY) if img.ndim == 3 else
               np.stack([cv.cvtColor(x, cv.COLOR_BGR2GRAY) for x in img]))
        np.testing.assert_array_equal(bgr_to_gray_u8(img), ref)


@pytest.mark.parametrize("src,dst", [
    ((720, 1280), (483, 860)),     # serving: 1280x720 source
    ((1080, 1920), (483, 860)),    # serving: 1080p source
    ((484, 860), (242, 430)),      # exact 2x: OpenCV's integer path
    ((99, 171), (33, 57)),         # exact 3x
    ((100, 173), (57, 91)),        # odd, non-integer
    ((120, 200), (120, 200)),      # identity
])
def test_area_resize_bit_equal(rng, src, dst):
    img = rng.integers(0, 256, src, dtype=np.uint8)
    ref = cv.resize(img, (dst[1], dst[0]), interpolation=cv.INTER_AREA)
    np.testing.assert_array_equal(resize_area_u8(img, dst[1], dst[0]), ref)


def test_stage_gray_matches_cv_pipeline():
    """The host_preprocess / serving staging of one synthetic BGR frame ==
    cv.cvtColor + cv.resize(INTER_AREA), bit for bit."""
    f = SyntheticRoadStream(width=1280, height=720, seed=1).frame(4)
    ref = cv.resize(cv.cvtColor(f, cv.COLOR_BGR2GRAY), (860, 483),
                    interpolation=cv.INTER_AREA)
    np.testing.assert_array_equal(stage_gray(f, 860, 483), ref)
