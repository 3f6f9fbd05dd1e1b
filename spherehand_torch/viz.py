"""Training-time visualization grids (numpy/cv2, host-side only).

Counterpart of ``spherehand_tpu/viz.py`` (reference
``network/util_vis.py:8-74``), the port's own copy: per-sample rows of
[gray depth map | heatmap overlay | skeleton dots], stacked vertically.
Inputs are plain numpy arrays (the engine copies device tensors once per
dump cadence); heatmap/depth layout is (B, J, H, W) to match the loss
stack. ``cv2`` is imported only when an image is drawn, so the port runs
without it; the engine logs a failed dump and trains on.
"""
from __future__ import annotations

import numpy as np

from spherehand_torch.constants import Constants

_C = Constants()

# Per-joint BGR colors: palm red, then one hue per finger chain
# (reference network/constants.py:16-22).
JOINT_COLORS = (
    [(255, 0, 0)] * 11
    + [(25, 255, 25)] * 6
    + [(212, 0, 255)] * 6
    + [(0, 230, 230)] * 6
    + [(179, 179, 0)] * 6
    + [(255, 153, 153)] * 6
)


def _resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    import cv2

    return cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)


def depthmap_to_u8(dm: np.ndarray) -> np.ndarray:
    """Scaled depth ([-1, 1] ~ foreground..background) -> 8-bit BGR."""
    dm = np.clip(np.squeeze(dm), -1.0, 1.0)
    gray = ((dm + 1.0) * 127).astype(np.uint8)
    return np.stack([gray, gray, gray], axis=-1)


def overlay_heatmaps(base: np.ndarray, hms: np.ndarray, colors=None) -> np.ndarray:
    """Alpha-blend per-joint heatmaps as colored masses over a BGR image."""
    colors = colors or JOINT_COLORS
    out = base.astype(np.float64)
    for hm, color in zip(hms, colors):
        c = np.asarray(color, np.float64).reshape(1, 1, 3)
        a = hm[..., None]
        out = a * c + (1.0 - a) * out
    return np.clip(out, 0, 255).astype(np.uint8)


def draw_joints(base: np.ndarray, joints_uv: np.ndarray, colors=None) -> np.ndarray:
    import cv2

    colors = colors or JOINT_COLORS
    out = base.copy()
    for j, c in zip(joints_uv, colors):
        cv2.circle(out, (int(j[0]), int(j[1])), 3, c, -1)
    return out


def result_grid(
    dms: np.ndarray,
    uv_hms: np.ndarray,
    joints_xyz: np.ndarray,
    vis_indices=None,
    output_size: tuple[int, int] = (128, 128),
    resized_dms: np.ndarray | None = None,
) -> np.ndarray:
    """Rows of [depth | heatmap overlay | skeleton], one per sample.

    dms (B, H, W) scaled depth; uv_hms (B, J, h, w); joints_xyz (B, J, 3) mm.
    Matches vis_result (reference util_vis.py:30-74).
    """
    batch = dms.shape[0]
    joints = np.array(joints_xyz, np.float64, copy=True)
    joints[..., 0] = joints[..., 0] * output_size[0] / _C.cube_mm + output_size[0] / 2
    joints[..., 1] = joints[..., 1] * output_size[1] / _C.cube_mm + output_size[1] / 2
    colors = JOINT_COLORS
    if vis_indices is not None:
        uv_hms = uv_hms[:, list(vis_indices)]
        joints = joints[:, list(vis_indices)]
        colors = [JOINT_COLORS[i] for i in vis_indices]

    rows = []
    for b in range(batch):
        dm_img = depthmap_to_u8(_resize_bilinear(np.asarray(dms[b]), output_size))
        hms = np.stack(
            [_resize_bilinear(np.asarray(h), output_size) for h in uv_hms[b]]
        )
        if resized_dms is not None:
            base = depthmap_to_u8(
                _resize_bilinear(np.asarray(resized_dms[b]), output_size)
            )
        else:
            base = dm_img
        row = np.hstack(
            [dm_img, overlay_heatmaps(base, hms, colors), draw_joints(dm_img, joints[b], colors)]
        )
        rows.append(row)
    return np.vstack(rows)


def save_image(path: str, img: np.ndarray) -> None:
    import cv2

    cv2.imwrite(path, img)
