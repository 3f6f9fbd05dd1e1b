"""Pseudo-NYU: rendered multi-view hands seen by a shifted depth sensor.

The port's copy of the JAX package's pseudo-NYU recipe
(``tools/selfsup_demo.py:73-243``): sampler hands at the training scale
distribution are skinned once, every view's bone transforms are
premultiplied by a ring of three camera rotations conjugated with the
skinning x-flip, and ``render_depth_64`` renders each view. The camera
poses map view coordinates to the canonical frame (rotation only), and the
36-joint ground truth is filled through the keypoint correspondence (it
feeds metrics only, never a loss).

- :func:`render_multiview_batch` gives a clean batch. ``exact=True`` (the
  default) renders with the exact rule, so that a batch drawn on the GPU
  and one drawn on the CPU follow the same rasterizer; ``exact=False``
  takes the fast rule on the card, as the JAX recipe renders (the CPU has
  only the exact rule).
- The shifted sensor, split by the port's RNG rule: :func:`sensor_draws`
  draws two pixel-jitter planes, a z-noise plane and a dropout plane;
  :func:`corrupt` is the deterministic core (integer pixel shifts with a
  clipped gather, z noise on the foreground, holes punched to the
  background).
- :func:`generate_pseudo_nyu` writes the shards (``data.nyu.write_shard``,
  byte-compatible with both packages' ``NyuDataset``) after
  :func:`self_check` has held the first chunk's views consistent.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from spherehand_torch import constants as C
from spherehand_torch.constants import Constants
from spherehand_torch.data.nyu import write_shard
from spherehand_torch.data.sampler import sample_poses
from spherehand_torch.device import resolve_device
from spherehand_torch.hand.assets import HandModel, load_hand_model
from spherehand_torch.hand.kinematics import forward_kinematics
from spherehand_torch.hand.skinning import apply_random_scale, lbs_keypoints
from spherehand_torch.losses.multiview import apply_rigid, mutual_transforms
from spherehand_torch.render.raster import render_depth_64

_C = Constants()

# The shifted sensor (selfsup_demo.py:73-83 of the JAX package): the domain
# gap is the sensor, not the hand's shape, since the self-supervision priors
# (bone lengths, collision pairs, the VAE, fixed sphere radii) model the
# canonical hand.
SHIFT_PIXEL_SIGMA = 2.0  # pixel jitter (training noise: 0.5)
Z_SIGMA = 0.08           # scaled units = 8 mm (training: 5 mm)
DROPOUT = 0.12           # share of pixels punched to the background
BLUR_KERNEL = 0          # no blur: averaging across silhouettes makes phantom
                         # surfaces the distance terms would chase
SELF_CHECK_MM = 0.5      # cross-view joint inconsistency allowed
CHUNK = 256              # hands rendered at a time


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
                           batch: int, exact: bool = True) -> PseudoRealBatch:
    """Sampler hands at the training scale distribution seen by three
    cameras, on the generator's device (``exact``: the raster rule on the
    card)."""
    dev = generator.device
    transforms = forward_kinematics(model, sample_poses(generator, batch))
    transforms = apply_random_scale(generator, transforms, 0.1)
    per_view = view_transforms(model, transforms)
    num_views = per_view.shape[1]
    dms, kps = [], []
    for v in range(num_views):
        dms.append(render_depth_64(model, per_view[:, v], exact=exact))
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


class SensorDraws(NamedTuple):
    """The shifted sensor's draws, each of the depth maps' shape."""

    jitter_x: torch.Tensor  # standard normal
    jitter_y: torch.Tensor  # standard normal
    z: torch.Tensor         # standard normal
    dropout: torch.Tensor   # U[0, 1)


def sensor_draws(generator: torch.Generator, shape) -> SensorDraws:
    dev = generator.device
    normals = [torch.randn(shape, generator=generator, device=dev) for _ in range(3)]
    return SensorDraws(*normals, torch.rand(shape, generator=generator, device=dev))


def corrupt(dms: torch.Tensor, draws: SensorDraws) -> torch.Tensor:
    """Scaled depth maps (..., H, W), background 1.0, through the shifted
    sensor: each pixel reads the pixel ``trunc(n * sigma + 0.5)`` away in x
    and y (clipped to the map), the foreground gets ``Z_SIGMA`` z noise,
    and pixels whose dropout draw is at most ``DROPOUT`` become 1.0."""
    height, width = dms.shape[-2:]
    dx = torch.trunc(draws.jitter_x * SHIFT_PIXEL_SIGMA + 0.5).long()
    dy = torch.trunc(draws.jitter_y * SHIFT_PIXEL_SIGMA + 0.5).long()
    u = torch.arange(width, device=dms.device)
    v = torch.arange(height, device=dms.device)[:, None]
    src = (v + dy).clamp(0, height - 1) * width + (u + dx).clamp(0, width - 1)
    flat = dms.reshape(-1, height * width)
    shifted = torch.gather(flat, 1, src.reshape(flat.shape)).reshape(dms.shape)
    noisy = torch.where(shifted < 1.0, shifted + draws.z * Z_SIGMA, shifted)
    return torch.where(draws.dropout > DROPOUT, noisy, 1.0)


def self_check(batch: PseudoRealBatch) -> float:
    """The largest gap (mm) between a view's ground-truth keypoints mapped
    through the stored camera poses into another view and that view's own;
    raises above ``SELF_CHECK_MM``. It catches every pose, flip or axis
    convention error at once."""
    projected = apply_rigid(mutual_transforms(batch.poses, batch.inv_poses),
                            batch.keypoints[:, :, None])
    err = float((projected - batch.keypoints[:, None]).abs().max())
    if not err < SELF_CHECK_MM:
        raise ValueError(f"pseudo-NYU geometry inconsistent across views ({err:.3f} mm)")
    return err


def generate_pseudo_nyu(out_dir: str, num_samples: int, seed: int,
                        device: torch.device | str | None = None) -> float:
    """Write ``num_samples`` shifted-sensor multi-view hands as the shard
    ``mv_data_0`` under ``out_dir``, rendered in chunks of ``CHUNK`` hands
    (the last one shorter; the JAX recipe drops a remainder) with the fast
    rule on the card, from one generator seeded with ``seed``; returns
    :func:`self_check`'s gap on the first chunk (mm)."""
    dev = resolve_device(device)
    model = load_hand_model(device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    dms, joints, poses, gap = [], [], [], None
    for start in range(0, num_samples, CHUNK):
        batch = render_multiview_batch(model, generator, min(CHUNK, num_samples - start),
                                       exact=False)
        if gap is None:
            gap = self_check(batch)
        scaled = batch.dms * _C.depth_scale
        dms.append((corrupt(scaled, sensor_draws(generator, scaled.shape))
                    / _C.depth_scale).cpu().numpy())
        joints.append(batch.gt_joints.cpu().numpy())
        poses.append(batch.poses.cpu().numpy())
    os.makedirs(out_dir, exist_ok=True)
    write_shard(out_dir, "mv_data_0", np.concatenate(dms), np.concatenate(joints),
                np.concatenate(poses))
    return gap
