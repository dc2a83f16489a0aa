"""Configuration dataclasses — the reference's module-constant blocks made real.

The reference configures itself through per-script UPPERCASE constants
(reference ``LK_Final.py:21-54``, ``LK3_classification.py:20-33``,
``LK1_masking.py:12-17``, ``LK2_road_line_detection.py:17-22``; full matrix in
SURVEY.md §2.4).  Here every knob is an explicit frozen dataclass so configs
are hashable (usable as static jit args) and the five reference pipelines
become presets in :mod:`lk_tpu.models`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LKConfig:
    """Pyramidal Lucas–Kanade parameters (reference ``LK_Final.py:94-96``)."""

    win_size: Tuple[int, int] = (15, 15)  # (width, height), OpenCV order
    max_level: int = 2                    # pyramid levels = max_level + 1
    max_iters: int = 10                   # TERM_CRITERIA_COUNT
    eps: float = 0.03                     # TERM_CRITERIA_EPS on |delta|
    min_eig_threshold: float = 1e-4       # OpenCV minEigThreshold default
    # Build the batched tracker's coarse pyramid levels with the fast
    # banded-matmul pyr_down (DEFAULT matmul precision: reduced-precision
    # operands, <= 0.5 intensity on 0..255 frames) instead of the
    # bit-exact cv.pyrDown path.  Level 0 — where the final refinement
    # happens — is the raw frame either way; parity vs OpenCV stays
    # < 0.1 px (tested).
    # Only affects fold_tracking_levels / track_points_batched; the
    # single-pair oracle path (track_points) stays exact.
    fast_pyramid: bool = False

    @property
    def half_win(self) -> Tuple[float, float]:
        return ((self.win_size[0] - 1) * 0.5, (self.win_size[1] - 1) * 0.5)


@dataclasses.dataclass(frozen=True)
class DenseLKConfig:
    """Dense-flow-specific knobs on top of LKConfig.

    outer_iters: warp+solve rounds for a single level call.  Each solve is
    exact to first order (flow/dense.py).
    iter_schedule: per-level rounds for the pyramid driver, indexed by level
    (the last entry extends to deeper levels).  The top level does the real
    search; the well-initialized fine levels only polish, so one round each
    keeps the translation/rotation/zoom EPE of longer schedules while a
    shorter top schedule degrades the large-displacement search.
    max_disp: level-0 bound on the warp displacement; level L uses
    max(4, max_disp >> L).  Total trackable |flow| is bounded by max_disp.
    """

    outer_iters: int = 6
    iter_schedule: Tuple[int, ...] = (1, 1, 1, 6)
    max_disp: int = 32
    # Dense pyramid depth override: the dense paths run this many levels
    # regardless of LKConfig.max_level (0 = follow max_level).  The sparse
    # tracker keeps the reference's maxLevel=2 exactly (LK_Final.py:81-86);
    # the dense path is this framework's own design, and a 4th level lets
    # the coarse search cover displacement a 3-level top clamps (20 px
    # shifts, 3% zoom, 1.5 deg rotation) at negligible cost on mild scenes.
    pyramid_levels: int = 4
    # Video-mode temporal warm start (OPT-IN): seed each step's TOP pyramid
    # level with the previous step's converged top-level flow (the prior
    # OpenCV exposes as OPTFLOW_USE_INITIAL_FLOW) and run warm_top_iters
    # there instead of the cold schedule's top count; the first pair runs
    # the full cold schedule.  On smooth motion the EPE equals the cold
    # schedule's, but a hard motion discontinuity (a +-10 px/frame
    # direction flip) PERMANENTLY corrupts the track: the stale seed
    # centers the warp's clamp range, and the bad output re-seeds every
    # following step.  Default off; enable only for streams with
    # guaranteed-smooth motion.  Only affects dense_pyramidal_lk_video.
    video_warm_start: bool = False
    warm_top_iters: int = 2
    # bf16 data for the bandwidth-bound box sums of the level solve (the
    # structure tensor + right-hand side).  Accumulation error ~1e-2
    # relative; gate with bench's EPE.
    bf16_box_sums: bool = False
    # Build the coarse-search pyramid with ops.blur.pyr_down(fast=True):
    # both filter+decimate passes as DEFAULT-precision banded matmuls
    # (reduced-precision operands, <= 0.5 intensity; the level-0 solve
    # still sees the exact f32 frames).  The exact path stays for
    # cv.pyrDown parity.
    fast_pyramid: bool = True

    def level_disp(self, level: int) -> int:
        return max(4, self.max_disp >> level)

    def level_iters(self, level: int) -> int:
        s = self.iter_schedule
        return s[min(level, len(s) - 1)] if s else self.outer_iters


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Shi–Tomasi / goodFeaturesToTrack parameters (reference ``LK_Final.py:88-91``)."""

    max_corners: int = 5          # int(TP_NUM/4) in the VP pipelines
    quality_level: float = 0.3    # relative to max response
    min_distance: float = 7.0     # greedy NMS radius
    block_size: int = 7           # structure-tensor window


@dataclasses.dataclass(frozen=True)
class ROIConfig:
    """Road-trapezoid ROI fractions (reference ``LK_Final.py:437-446``)."""

    outer_l: float = 0.2
    outer_u: float = 0.65
    outer_r: float = 0.8
    outer_d: float = 0.8
    inner_l: float = 0.47
    inner_u: float = 0.65
    inner_r: float = 0.52
    inner_d: float = 0.65


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full VP-pipeline configuration (SURVEY.md §2.4 hyper-parameter matrix).

    Defaults reproduce the reference ``LK_Final.py`` constants
    (``LK_Final.py:22-54``).  The compat flags at the bottom reproduce
    behavioral quirks of specific reference scripts so trajectories can be
    matched bit-for-bit where wanted (SURVEY.md §7 "faithful quirk set").
    """

    width: int = 860                  # WID: resize target width
    tp_num: int = 20                  # max simultaneous tracking points
    vp_ref_num: int = 15              # recent CPs per VP update
    vp_update_rate: float = 0.5
    fl_update_rate: float = 0.05      # EMA rate for average flow length
    tp_update_rate: float = 0.3       # replenish when live < tp_num * this
    tp_update_time: int = 10          # forced replenish period (frames)
    min_ang_dif: float = 25.0         # degrees
    max_cp_std: float = 1.0
    min_fl_len: float = 1.5
    cp_thold: float = 1.0 / 15.0
    hide_vp_thold: int = 50
    fl_upd_meth: str = "REP"          # "REP" | "EXT"
    vp_ref: int = 300                 # VP-history window for VL regression

    lk: LKConfig = LKConfig()
    features: FeatureConfig = FeatureConfig()
    roi: ROIConfig = ROIConfig()

    # --- structural variants -------------------------------------------------
    # Number of independent point groups: 2 in LK_Final/VP_det
    # (reference LK_Final.py:481-492), 1 in LK3 (LK3_classification.py:342-347).
    num_groups: int = 2

    # --- compat quirks (SURVEY.md §2.3 / §7) ---------------------------------
    # LK_Final.py:617-624 rebinds the loop variable `vp`, aliasing the new VP
    # with the last accepted cross point; diffs against that slot are then 0.
    vp_init_aliasing: bool = True
    # LK_Final updates avg_len BEFORE the accept test (LK_Final.py:557-558);
    # LK3 updates it AFTER (LK3_classification.py:411-417).
    avg_len_update_before_test: bool = True
    # VP_det additionally requires >= 5%*WID horizontal start separation of
    # the two lines forming a CP (VP_detection_using_optical_flow.py:588-589).
    cp_min_start_sep_frac: float = 0.0
    # VP_det resets avg_len on VP hide (VP_det:644-648); LK_Final does not.
    reset_avg_len_on_hide: bool = False
    # LK_Final appends a VP row both on every update and once in the show
    # block (LK_Final.py:612-614,637-638); LK3 appends only in the show block.
    csv_rows_on_update: bool = True
    # LK3 applies the contrast tone curve inside process_img (LK3:274).
    contrast_enhance: bool = False
    # Per-frame AVERAGE budget for chunk-compacted output transport (rows
    # per frame; a chunk of T frames shares a T*out_cap buffer).  The
    # update-row / cross-point outputs reserve P = C(tp_num, 2) = 190 slots
    # per frame while real frames emit ~14 (p99 ~100, measured on synthetic
    # road scenes) — compacting on device cuts the host readback bytes ~3x.
    # 0 = off: full fixed-capacity
    # FrameOutputs transport, bit-identical to the reference emission.
    # Compaction is exact unless a chunk's total exceeds the budget, which
    # the host detects from the transported counts and raises on.
    out_cap: int = 0

    # Crop the batched tracker's pyramid levels to the ROI's row band
    # (+ margins): valid tracking points only ever live inside the ROI
    # trapezoid (check_inside culls escapees every frame, reference
    # LK_Final.py:537-541), so the pyramid prep and Scharr pass need only
    # the band — the ROI covers ~15% of a dashcam frame.
    # Exact for in-band points (flow/sparse._level_row_bands margins);
    # disable for point sets that roam the full frame.
    track_row_band: bool = True

    def derived_height(self, src_h: int, src_w: int) -> int:
        """Frame height after aspect-preserving resize (LK_Final.py:426-428)."""
        return int(self.width * (src_h / src_w))
