"""Skeleton-only forward kinematics: pose parameters -> 41 sphere centres.

Counterpart of ``spherehand_tpu/hand/skeleton.py`` (reference
mesh/kinematicsTransformation.py:180-207): FK, an optional random
anisotropic scale, then keypoint LBS. It generates the training sets of the
VAE and the denoiser and the PCA prior's samples (``train/priors.py``).
The scale's draws come from ``hand.skinning.draw_random_scale``.
"""
from __future__ import annotations

import torch

from spherehand_torch.hand.assets import HandModel
from spherehand_torch.hand.kinematics import forward_kinematics
from spherehand_torch.hand.skinning import apply_scale, lbs_keypoints


def skeleton_fk(model: HandModel, params: torch.Tensor, scale_u: torch.Tensor | None = None,
                scale_range: float = 0.1) -> torch.Tensor:
    """(B, 26) pose parameters -> (B, 41, 3) keypoints in mm. ``scale_u``
    (B, 3) U[0, 1) draws apply the reference's RandScale(0.1) jitter
    (kinematicsTransformation.py:188,199); ``None`` leaves the scale at 1."""
    transforms = forward_kinematics(model, params)
    if scale_u is not None:
        transforms = apply_scale(transforms, scale_u, scale_range)
    return lbs_keypoints(model, transforms)[..., :3]
