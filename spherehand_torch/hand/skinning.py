"""Linear blend skinning and the orthographic camera.

Counterpart of ``spherehand_tpu/hand/skinning.py``. Full-mesh LBS is one
product against the fused ``skin_matrix``; keypoint LBS uses single-bone
ownership with a gather. Every product runs in true f32 (the port leaves
``torch.backends.cuda.matmul.allow_tf32`` off).

``apply_random_scale`` follows the port's RNG rule: :func:`draw_random_scale`
takes a ``torch.Generator`` and :func:`apply_scale` is the deterministic core
that takes the draws.
"""
from __future__ import annotations

import torch

from spherehand_torch.hand.assets import HandModel


def _negate_x(points: torch.Tensor) -> torch.Tensor:
    sign = torch.ones(points.shape[-1], dtype=points.dtype, device=points.device)
    sign[0] = -1.0
    return points * sign


def lbs_mesh(model: HandModel, transforms: torch.Tensor) -> torch.Tensor:
    """Skin the full mesh: transforms (B, 17, 4, 4) -> vertices (B, V, 4).

    The x coordinate is negated for the right hand.
    """
    batch = transforms.shape[0]
    t_flat = transforms.transpose(1, 2).reshape(batch * 4, -1)  # (B*4, 68)
    skinned = (t_flat @ model.skin_matrix).reshape(batch, 4, -1).transpose(1, 2)
    return _negate_x(skinned) if model.right_hand else skinned


def lbs_faces(model: HandModel, transforms: torch.Tensor) -> torch.Tensor:
    """Skin the mesh in face-vertex order: (B, 17, 4, 4) -> (B, 3F, 4).

    The same dot products as ``lbs_mesh(model, t)[:, faces.flat]``.
    """
    batch = transforms.shape[0]
    t_flat = transforms.transpose(1, 2).reshape(batch * 4, -1)
    skinned = (t_flat @ model.skin_matrix_faces).reshape(batch, 4, -1).transpose(1, 2)
    return _negate_x(skinned) if model.right_hand else skinned


def project_faces_planes(
    model: HandModel,
    transforms: torch.Tensor,
    size: float,
    rand_f: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused LBS + orthographic projection in face-vertex order.

    Returns (u, v, z), each (B, 3F). The projection is affine, so it folds
    into the per-image bone-transform rows before the skinning product. Not
    bit-identical to ``lbs_faces`` + ``orthographic_project_xyz`` (the focal
    scaling associates differently, ~1e-5 relative); this is the render
    front end of the CUDA path, as it is of the TPU path.
    """
    batch = transforms.shape[0]
    t = transforms.transpose(1, 2).reshape(batch, 4, -1)  # (B, 4, 68)
    fx = size / 300.0
    c = size / 2.0
    if rand_f is not None:
        f = rand_f[:, None] * fx
    else:
        f = torch.full((batch, 1), fx, dtype=transforms.dtype, device=transforms.device)
    sx = -f if model.right_hand else f
    m = model.skin_matrix_faces
    return (
        (sx * t[:, 0] + c * t[:, 3]) @ m,
        (f * t[:, 1] + c * t[:, 3]) @ m,
        t[:, 2] @ m,
    )


def lbs_keypoints(model: HandModel, transforms: torch.Tensor) -> torch.Tensor:
    """Skin the 41 sphere centres: (B, 17, 4, 4) -> (B, 41, 4)."""
    per_kp = transforms[:, model.kp_bone]  # (B, 41, 4, 4)
    skinned = torch.einsum("bkmn,kn->bkm", per_kp, model.kp_local.to(transforms.dtype))
    return _negate_x(skinned) if model.right_hand else skinned


def draw_random_scale(
    generator: torch.Generator, batch: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The draws of the random scale: U[0, 1) of shape (B, 3), on the
    generator's device."""
    return torch.rand(
        (batch, 3), generator=generator, dtype=dtype, device=generator.device
    )


def apply_scale(
    transforms: torch.Tensor, scale_u: torch.Tensor, scale_range: float
) -> torch.Tensor:
    """Premultiply a per-image anisotropic scale onto all bone transforms.

    Per-axis scale = u * s + 0.9 - s/2 for u in [0, 1), so the scale lies in
    [0.9 - s/2, 0.9 + s/2) (centred at 0.9, as the reference RandScale).
    """
    scales = scale_u * scale_range + 0.9 - scale_range / 2.0
    ones = torch.ones_like(scales[:, :1])
    scales = torch.cat([scales, ones], dim=-1)
    return transforms * scales[:, None, :, None]


def apply_random_scale(
    generator: torch.Generator, transforms: torch.Tensor, scale_range: float
) -> torch.Tensor:
    """Draw step + core, the counterpart of the JAX ``apply_random_scale``."""
    u = draw_random_scale(generator, transforms.shape[0], transforms.dtype)
    return apply_scale(transforms, u.to(transforms.device), scale_range)


def orthographic_project(
    points: torch.Tensor, size: float, rand_f: torch.Tensor | None = None
) -> torch.Tensor:
    """Orthographic camera u = x * fx + cx, fx = size/300, cx = size/2.

    points (B, N, 4) homogeneous -> (B, N, 4) [u, v, z, 1]; ``rand_f`` (B,)
    jitters the focal length per image.
    """
    uvz = orthographic_project_xyz(points, size, rand_f)
    return torch.cat([uvz, torch.ones_like(uvz[..., :1])], dim=-1)


def orthographic_project_xyz(
    points: torch.Tensor, size: float, rand_f: torch.Tensor | None = None
) -> torch.Tensor:
    """:func:`orthographic_project` without the homogeneous column:
    (B, N, 4) -> (B, N, 3) [u, v, z]."""
    fx = size / 300.0
    c = size / 2.0
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    if rand_f is not None:
        f = rand_f[:, None] * fx
        u = x * f + c
        v = y * f + c
    else:
        u = x * fx + c
        v = y * fx + c
    return torch.stack([u, v, z], dim=-1)


def inverse_orthographic(uvd: torch.Tensor, size: float) -> torch.Tensor:
    """Inverse of :func:`orthographic_project` at the nominal focal length:
    (B, N, 4) -> xyz (B, N, 4)."""
    fx = size / 300.0
    c = size / 2.0
    x = (uvd[..., 0] - c) / fx
    y = (uvd[..., 1] - c) / fx
    return torch.stack([x, y, uvd[..., 2], torch.ones_like(x)], dim=-1)
