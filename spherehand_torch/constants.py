"""Framework-wide geometry constants and joint correspondence tables.

The PyTorch port keeps its own copy of the sizes and keypoint tables of
``spherehand_tpu/constants.py`` so that nothing in this package imports the
JAX package, the training tables (collision pairs, bone lengths)
included.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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


def collision_pairs() -> tuple[np.ndarray, np.ndarray]:
    """690 keypoint index pairs penalised for inter-penetration.

    Keypoints 0-10 are palm spheres, 11-40 are 6-per-finger chains; pairs
    are palm-vs-every-finger plus finger-vs-different-finger (reference
    mesh/render.py:150-162)."""
    j1, j2 = [], []
    for a in range(11):
        for b in range(11, 41):
            j1.append(a)
            j2.append(b)
    for a in range(11, 41):
        for b in range(a + 1, 41):
            if (a - 11) // 6 != (b - 11) // 6:
                j1.append(a)
                j2.append(b)
    return np.asarray(j1, np.int64), np.asarray(j2, np.int64)


# 35 bone segments (keypoint index pairs) and their median rest lengths in mm
# (reference mesh/bone_length.py:36-56): 20 palm-internal segments, then 3
# per finger.
BONE_PAIRS_J1 = np.asarray(
    [3, 2, 3, 8, 2, 2, 9, 8, 4, 8, 7, 4, 6, 7, 0, 5, 7, 7, 6, 6]
    + [11 + f * 6 + o for f in range(5) for o in (0, 2, 4)],
    np.int64,
)
BONE_PAIRS_J2 = np.asarray(
    [2, 9, 8, 2, 4, 10, 10, 4, 10, 7, 4, 6, 10, 6, 5, 1, 0, 5, 5, 1]
    + [11 + f * 6 + o for f in range(5) for o in (1, 3, 5)],
    np.int64,
)
BONE_MEDIAN_LENGTH = np.asarray(
    [
        25.212656021118164, 18.249488830566406, 27.5742244720459, 38.532264709472656,
        25.10819435119629, 31.173757553100586, 18.329626083374023, 19.15080451965332,
        16.209327697753906, 21.52261734008789, 32.740535736083984, 30.58920669555664,
        33.205970764160156, 11.672294616699219, 17.084707260131836, 17.084720611572266,
        16.697546005249023, 23.92103385925293, 20.87999725341797, 22.58038330078125,
        27.55999755859375, 15.471183776855469, 13.214692115783691, 21.748210906982422,
        13.021653175354004, 16.643720626831055, 18.83765983581543, 12.724685668945312,
        16.238431930541992, 18.04928970336914, 11.045844078063965, 11.320968627929688,
        30.078536987304688, 16.255985260009766, 19.434825897216797,
    ],
    np.float32,
)
