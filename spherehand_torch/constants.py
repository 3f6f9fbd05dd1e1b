"""Framework-wide geometry constants and joint correspondence tables.

The PyTorch port keeps its own copy of the sizes and keypoint tables of
``spherehand_tpu/constants.py`` so that nothing in this package imports the
JAX package. The training-only tables (collision pairs, bone lengths) arrive
with the training slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Constants:
    """Geometry / scaling constants (reference network/constants.py:10-15)."""

    depthmap_size: int = 64
    heatmap_size: int = 16
    num_joints: int = 41
    num_bones: int = 17
    num_params: int = 26
    depth_scale: float = 1.0 / 100.0
    uv_hm_scale: float = 1.0
    # Orthographic crop: a 300 mm cube maps onto the full image.
    cube_mm: float = 300.0
    # Background value of all depth maps, in mm.
    background_depth: float = 100.0
    # Native rasterization canvas of the reference renderer.
    raster_size: int = 640


# 14-point correspondence between the 41 sphere-model keypoints and the NYU
# 36-joint ground truth. Order: index/middle/ring/pinky tip+pip, thumb (3),
# palm (3).
SYNT_KEY_POINTS = (33, 32, 27, 26, 21, 20, 15, 14, 39, 40, 38, 0, 1, 2)
REAL_KEY_POINTS = (0, 3, 6, 9, 12, 15, 18, 21, 24, 25, 27, 30, 31, 32)

# 12-point variant used by the offline evaluator.
EVAL_SYNT_KEY_POINTS = (33, 32, 27, 26, 21, 20, 15, 14, 39, 40, 38, 2)
EVAL_REAL_KEY_POINTS = (0, 3, 6, 9, 12, 15, 18, 21, 24, 25, 27, 32)
