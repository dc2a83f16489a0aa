"""Image primitives: the JAX replacements for the reference's OpenCV calls.

Every op is a pure jittable function over float32 arrays in OpenCV's 0..255
intensity scale (so quality/eigenvalue thresholds carry over unchanged).
Mapping to the reference's native surface is documented per-op (SURVEY.md §2.2).
"""

from lk_tpu.ops.color import bgr_to_gray, bgr_to_gray_u8  # noqa: F401
from lk_tpu.ops.blur import (  # noqa: F401
    gaussian_blur3,
    gaussian_pyramid,
    pyr_down,
)
from lk_tpu.ops.resize import resize_area, resize_linear, area_weights  # noqa: F401
from lk_tpu.ops.gradients import scharr_derivatives, sobel_derivatives  # noqa: F401
from lk_tpu.ops.warp import (  # noqa: F401
    bilinear_sample,
    warp_by_flow,
    extract_patch,
)
from lk_tpu.ops.rasterize import fill_convex_poly, masks_from_points  # noqa: F401
from lk_tpu.ops.boxfilter import box_sum  # noqa: F401
from lk_tpu.ops.tone import contrast_brightness  # noqa: F401
