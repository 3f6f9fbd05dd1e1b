"""Gaussian ground-truth heatmaps.

Counterpart of ``spherehand_tpu/render/heatmap.py`` (reference
mesh/render.py:210-279): uv heatmaps are ``exp(-0.5 * sigma * (du^2 + dv^2))``
on the integer heatmap grid, and the depth heatmap carries the joint z
wherever the uv heatmap exceeds 0.05.
"""
from __future__ import annotations

import torch

from spherehand_torch.hand.assets import HandModel
from spherehand_torch.hand.skinning import (
    inverse_orthographic,
    lbs_keypoints,
    orthographic_project,
)


def render_heatmaps(
    uvd: torch.Tensor, size: int, sigma: float = 1.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """uvd (..., J, 3+) in heatmap pixels -> (uv_hms, d_hms), each
    (..., J, size, size)."""
    grid = torch.arange(size, dtype=uvd.dtype, device=uvd.device)
    du = grid[None, :] - uvd[..., 0, None, None]
    dv = grid[:, None] - uvd[..., 1, None, None]
    uv_hms = torch.exp(-0.5 * sigma * (du * du + dv * dv))
    d_hms = torch.where(
        uv_hms > 0.05, uvd[..., 2, None, None], torch.zeros_like(uv_hms)
    )
    return uv_hms, d_hms


def render_joint_heatmaps(
    model: HandModel,
    transforms: torch.Tensor,
    heatmap_size: int,
    rand_f: torch.Tensor | None = None,
    sigma: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bone transforms (B, 17, 4, 4) -> GT heatmaps + 3D joints.

    The joints come back through the nominal inverse camera, so a focal
    jitter ``rand_f != 1`` is baked into the labels, as in the reference.
    Returns (uv_hms (B, 41, S, S), d_hms (B, 41, S, S), xyz (B, 41, 4)).
    """
    kp = lbs_keypoints(model, transforms)
    uvd = orthographic_project(kp, float(heatmap_size), rand_f)
    uv_hms, d_hms = render_heatmaps(uvd, heatmap_size, sigma)
    xyz = inverse_orthographic(uvd, float(heatmap_size))
    return uv_hms, d_hms, xyz
