"""lk_tpu — Lucas–Kanade dashcam-analysis framework on JAX/XLA.

A JAX/XLA re-design of the capabilities of
``chiahuilin0531/LK-Optical-Flow-Method`` (see SURVEY.md): pyramidal
Lucas–Kanade optical flow (dense fields and sparse point tracking), Shi–Tomasi
feature selection, road-ROI masking, flow-line extraction/filtering,
cross-point voting and temporally smoothed vanishing-point detection — built as
dense, batched, fixed-shape tensor programs that scan over frames and shard
over independent video streams.

Subpackages
-----------
ops        image primitives (color, blur, resize, gradients, warps, masks)
flow       the LK core: dense pyramidal LK + OpenCV-semantics sparse tracker
features   Shi–Tomasi corner selection (goodFeaturesToTrack equivalent)
geometry   flow lines, cross points, vanishing-point state machine
pipeline   per-frame step function, lax.scan frame loops, stream batching
parallel   mesh construction, stream (DP) and spatial (halo) sharding
io         host runtime: video ingest, CSV/pickle/video sinks, native loader
models     the five reference pipelines as configured model presets
apps       CLI entry points mirroring the reference scripts
utils      tree/profiling/logging helpers
"""

__version__ = "0.1.0"

from lk_tpu.config import (  # noqa: F401
    DenseLKConfig,
    FeatureConfig,
    LKConfig,
    PipelineConfig,
    ROIConfig,
)
