"""Forward kinematics: 26 pose parameters -> 17 bone transforms, batched.

Counterpart of ``spherehand_tpu/hand/kinematics.py``. All finger-joint
rotations are one ``(B, 5, 3, 3)`` Rodrigues batch and the three phalanges
chain with three batched ``(B, 5, 4, 4)`` products.

Parameter layout:
  params[0:3]  palm rotation angles (applied as Rz @ Ry @ Rx)
  params[3:6]  palm translation (mm)
  params[6+4f : 10+4f]  finger f: [abduct, flex1, flex2, flex3]

The 4x4 products run in true f32: PyTorch's float32 matmul on the GPU is
full precision unless TF32 is switched on, which the port never does.
"""
from __future__ import annotations

import numpy as np
import torch

from spherehand_torch.hand.assets import HandModel

# Abduction axis for each of the 5 finger chains, in asset order.
ABDUCT_AXES = np.asarray(
    [[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]],
    np.float32,
)


def rotation_about_axis(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotations about unit axes: axis (..., 3), angle (...,) ->
    (..., 3, 3) = cos(t) I + sin(t) [a]_x + (1 - cos(t)) a a^T."""
    axis = torch.broadcast_to(axis, angle.shape + (3,))
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    outer = axis[..., :, None] * axis[..., None, :]
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    cross = torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )
    return c * eye + s * cross + (1.0 - c) * outer


def _embed44(rot: torch.Tensor) -> torch.Tensor:
    """Embed (..., 3, 3) rotations into (..., 4, 4) homogeneous transforms."""
    out = torch.zeros(rot.shape[:-2] + (4, 4), dtype=rot.dtype, device=rot.device)
    out[..., :3, :3] = rot
    out[..., 3, 3] = 1.0
    return out


def palm_transform(palm_params: torch.Tensor) -> torch.Tensor:
    """(B, 6) = [rx, ry, rz, tx, ty, tz] -> translation @ Rz @ Ry @ Rx."""
    axes = torch.eye(3, dtype=palm_params.dtype, device=palm_params.device)
    rx = rotation_about_axis(axes[0], palm_params[:, 0])
    ry = rotation_about_axis(axes[1], palm_params[:, 1])
    rz = rotation_about_axis(axes[2], palm_params[:, 2])
    g = _embed44((rz @ ry) @ rx)
    g[:, :3, 3] = palm_params[:, 3:6]
    return g


def forward_kinematics(model: HandModel, params: torch.Tensor) -> torch.Tensor:
    """Pose parameters (B, 26) -> global bone transforms (B, 17, 4, 4).

    Each finger joint applies its local rotation conjugated by the bone
    offset, ``G_k = G_{k-1} @ inv(O_k) @ R_k @ O_k``; joint 1 composes
    abduction then flexion about +x.
    """
    dtype, dev = params.dtype, params.device
    batch = params.shape[0]
    palm = palm_transform(params[:, :6])  # (B, 4, 4)

    finger_params = params[:, 6:].reshape(batch, 5, 4)
    abduct_axes = torch.as_tensor(ABDUCT_AXES, dtype=dtype, device=dev)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev)

    r_abduct = rotation_about_axis(abduct_axes[None], finger_params[..., 0])
    r_flex = rotation_about_axis(x_axis, finger_params[..., 1:])  # (B,5,3,3,3)
    local_rot = torch.stack(
        [r_abduct @ r_flex[:, :, 0], r_flex[:, :, 1], r_flex[:, :, 2]], dim=2
    )
    local = _embed44(local_rot)  # (B, 5, 3, 4, 4)

    # Finger f, joint k uses bone index 2 + 3f + k.
    offs = model.offset_mats[2:].reshape(5, 3, 4, 4).to(dtype)
    inv_offs = model.inv_offset_mats[2:].reshape(5, 3, 4, 4).to(dtype)
    local = (inv_offs[None] @ local) @ offs[None]

    g1 = palm[:, None] @ local[:, :, 0]  # (B, 5, 4, 4)
    g2 = g1 @ local[:, :, 1]
    g3 = g2 @ local[:, :, 2]
    fingers = torch.stack([g1, g2, g3], dim=2).reshape(batch, 15, 4, 4)
    return torch.cat([palm[:, None], palm[:, None], fingers], dim=1)
