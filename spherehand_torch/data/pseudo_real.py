"""A rendered stand-in for a real multi-view NYU batch.

The repository's pseudo-NYU recipe (``tools/selfsup_demo.py:101-172``)
renders sampler hands through a ring of three camera rotations; this module
keeps its own copy of that recipe for the port, without the sensor
corruption: each hand is skinned once, every view's bone transforms are
premultiplied by the view rotation conjugated with the skinning x-flip,
and ``render_depth_64`` renders it. The recipe renders with the fast rule;
this copy renders with the exact rule, the only one the CPU has, so that a
batch drawn on the GPU and one drawn on the CPU follow the same rasterizer.
The camera poses map view coordinates
to the canonical frame (rotation only), and the 36-joint ground truth is
filled through the keypoint correspondence (it feeds metrics only).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spherehand_torch import constants as C
from spherehand_torch.data.sampler import sample_poses
from spherehand_torch.hand.assets import HandModel
from spherehand_torch.hand.kinematics import forward_kinematics
from spherehand_torch.hand.skinning import apply_random_scale, lbs_keypoints
from spherehand_torch.losses.multiview import apply_rigid, mutual_transforms
from spherehand_torch.render.raster import render_depth_64


class PseudoRealBatch(NamedTuple):
    dms: torch.Tensor        # (B, V, 64, 64) mm, background 100
    gt_joints: torch.Tensor  # (B, V, 36, 3) NYU layout
    poses: torch.Tensor      # (B, V, 4, 4) view -> canonical
    inv_poses: torch.Tensor  # (B, V, 4, 4)
    keypoints: torch.Tensor  # (B, V, 41, 3) the sphere centres in each view


def _rot_x(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    return np.asarray([[1, 0, 0], [0, np.cos(r), -np.sin(r)], [0, np.sin(r), np.cos(r)]],
                      np.float32)


def _rot_y(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    return np.asarray([[np.cos(r), 0, np.sin(r)], [0, 1, 0], [-np.sin(r), 0, np.cos(r)]],
                      np.float32)


def camera_rotations() -> np.ndarray:
    """(3, 3, 3) camera-to-canonical rotations, an NYU-style ring of views."""
    return np.stack([np.eye(3, dtype=np.float32),
                     _rot_y(40.0) @ _rot_x(10.0),
                     _rot_y(-40.0) @ _rot_x(-10.0)])


def view_transforms(model: HandModel, transforms: torch.Tensor) -> torch.Tensor:
    """(B, 17, 4, 4) bone transforms -> (B, V, 17, 4, 4) per camera view.

    Skinning applies a final x-flip for right hands after the bone
    transforms, so a rotation R in final camera space enters the stack
    conjugated: F R^T F."""
    rots = camera_rotations()
    flip = (np.diag([-1.0, 1.0, 1.0]) if model.right_hand else np.eye(3)).astype(np.float32)
    rot4 = np.tile(np.eye(4, dtype=np.float32), (len(rots), 1, 1))
    rot4[:, :3, :3] = flip @ np.transpose(rots, (0, 2, 1)) @ flip
    rot4 = torch.as_tensor(rot4, device=transforms.device)
    return torch.einsum("vij,bkjl->bvkil", rot4, transforms)


def render_multiview_batch(model: HandModel, generator: torch.Generator,
                           batch: int) -> PseudoRealBatch:
    """Sampler hands at the training scale distribution seen by three
    cameras, on the generator's device."""
    dev = generator.device
    transforms = forward_kinematics(model, sample_poses(generator, batch))
    transforms = apply_random_scale(generator, transforms, 0.1)
    per_view = view_transforms(model, transforms)
    num_views = per_view.shape[1]
    dms, kps = [], []
    for v in range(num_views):
        dms.append(render_depth_64(model, per_view[:, v], exact=True))
        kps.append(lbs_keypoints(model, per_view[:, v])[..., :3])
    dms = torch.stack(dms, dim=1)
    kps = torch.stack(kps, dim=1)
    joints = torch.zeros((batch, num_views, 36, 3), dtype=kps.dtype, device=dev)
    joints[:, :, list(C.REAL_KEY_POINTS)] = kps[:, :, list(C.SYNT_KEY_POINTS)]
    poses = torch.zeros((batch, num_views, 4, 4), dtype=kps.dtype, device=dev)
    poses[:, :, 3, 3] = 1.0
    poses[:, :, :3, :3] = torch.as_tensor(camera_rotations(), device=dev)
    return PseudoRealBatch(dms, joints, poses, torch.linalg.inv(poses), kps)


def sphere_inputs(model: HandModel, real: PseudoRealBatch) -> tuple:
    """The sphere fields' inputs of the combined step on ``real``: every
    view's projected keypoints in every view's camera (N = B x V x V, J, 3),
    the depth maps (B x V, S, S), the radii and the view count V."""
    projected = apply_rigid(mutual_transforms(real.poses, real.inv_poses),
                            real.keypoints[:, :, None])
    size = real.dms.shape[-1]
    return (projected.reshape(-1, model.kp_radius.shape[0], 3).contiguous(),
            real.dms.reshape(-1, size, size).contiguous(), model.kp_radius.contiguous(),
            real.dms.shape[1])
