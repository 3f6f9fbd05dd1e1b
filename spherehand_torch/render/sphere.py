"""Analytic orthographic sphere rendering (plain PyTorch, no kernel).

Counterpart of ``render_spheres``/``render_sphere_hand`` in
``spherehand_tpu/render/sphere.py`` (reference mesh/render.py:10-90):

- the image grid is in millimetres, ``x = ((u - W/2) * 300) / W`` as two
  separate operations, u along the last axis, v along the one before;
- the squared surface distance is clamped at 1e-2, and pixels at the clamp
  are background = 100 mm, so a sphere passes no gradient outside its
  silhouette;
- the hand depth map is the min over the 41 sphere part maps.

``data_to_model_distance`` is the mean distance of the observed depth points
to the nearest sphere surface (reference mesh/render.py:93-142).

The sphere-field ops with their CUDA kernels (min depth, nearest distance and
both fused) are :mod:`spherehand_torch.render.sphere_cuda`. On a CUDA
device the loss stack goes through them (:func:`_fuse_spheres`); on the CPU
it keeps the plain broadcast path of this module, the one the goldens pin.
"""
from __future__ import annotations

import torch

from spherehand_torch.constants import Constants
from spherehand_torch.ops.reduce import bmean

_C = Constants()


def _fuse_spheres(device) -> bool:
    """Route the loss stack through the sphere kernels (render/sphere_cuda.py)?

    True on a CUDA device, where a tensor must launch its kernel or raise;
    the kernels' forward is bit-identical to the plain fields and their
    backward within 1e-5 relative of autograd. The CPU keeps the plain
    broadcast path (the oracle the goldens pin), as the JAX package keeps
    its XLA path off the TPU (``spherehand_tpu/render/sphere.py:28-38``)."""
    return torch.device(device).type == "cuda"


def _mm_grid(height: int, width: int, dtype=torch.float32, device=None):
    """Pixel-centre grid in mm: x (1, W) varies along axis -1, y (H, 1)."""
    u = ((torch.arange(width, dtype=dtype, device=device) - width / 2.0) * _C.cube_mm) / width
    v = ((torch.arange(height, dtype=dtype, device=device) - height / 2.0) * _C.cube_mm) / height
    return u[None, :], v[:, None]


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Square root rounded as IEEE float32 ``sqrtf`` rounds, on every device.

    PyTorch's vectorised CPU sqrt can be one ulp off the correctly rounded
    value, which moves sphere argmins against the CUDA kernels and the JAX
    package. The square root of a float32 taken in float64 and rounded once
    is the correctly rounded float32 square root (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).to(x.dtype)


def render_spheres(centers: torch.Tensor, radii: torch.Tensor, size: int) -> torch.Tensor:
    """Each sphere to its own depth map: centers (..., 3) mm, radii (...) ->
    (..., size, size), ``z - sqrt(r^2 - dx^2 - dy^2)`` inside, 100 outside."""
    x_grid, y_grid = _mm_grid(size, size, centers.dtype, centers.device)
    x = centers[..., 0, None, None]
    y = centers[..., 1, None, None]
    z = centers[..., 2, None, None]
    r = radii[..., None, None]
    sq = r * r - (x_grid - x) ** 2 - (y_grid - y) ** 2
    sq = torch.clamp(sq, min=1e-2)
    inside = sq > 1e-2
    depth = z - ieee_sqrt(sq)
    return torch.where(inside, depth, torch.full_like(depth, _C.background_depth))


def render_sphere_hand(centers: torch.Tensor, radii: torch.Tensor, size: int):
    """centers (..., J, 3), radii (J,) -> (part maps (..., J, S, S), min-reduced
    hand depth map (..., S, S))."""
    radii = torch.broadcast_to(radii, centers.shape[:-1]).to(centers.dtype)
    part_maps = render_spheres(centers, radii, size)
    return part_maps, part_maps.amin(dim=-3)


def data_to_model_distance(depth_maps: torch.Tensor, centers: torch.Tensor,
                           radii: torch.Tensor, weights: torch.Tensor | None = None,
                           total=None):
    """Mean distance from observed depth pixels to the nearest sphere surface.

    depth_maps (..., H, W) mm (background 100), centers (..., J, 3) mm, radii
    (J,), weights optional (batch,) row weights and ``total`` the global
    row count on one rank of several (ops.reduce). Each pixel's
    distance ``| ||p - c|| - r |`` to the nearest sphere is 0 on background,
    clipped to [0, 50] and averaged over all pixels (DataToModelLoss,
    reference mesh/render.py:123-142). ``||p - c||^2`` is expanded as
    ``(|p|^2 - 2 p.c) + |c|^2`` with the square root floored at 1e-6.

    On a CUDA device the nearest distance is the ``d2m_nearest`` kernel
    (square maps with S * S <= 4096, else it raises); on the CPU the plain
    (..., J, H, W) broadcast in the JAX package's order
    (``spherehand_tpu/render/sphere.py:119-138``). The depth is observed data
    at every call site: no gradient flows to it on CUDA."""
    height, width = depth_maps.shape[-2:]
    if _fuse_spheres(depth_maps.device):
        # imported here: sphere_cuda builds its plain versions on this module
        from spherehand_torch.render.sphere_cuda import d2m_nearest

        if height != width:
            raise ValueError(f"d2m_nearest takes square depth maps, got {height} x {width}")
        lead = depth_maps.shape[:-2]
        nearest = d2m_nearest(
            depth_maps.reshape(-1, height, width), centers.reshape(-1, *centers.shape[-2:]),
            radii, height,
        ).reshape(*lead, height, width)
        return bmean(torch.clamp(nearest, 0.0, 50.0), weights, total)
    x_grid, y_grid = _mm_grid(height, width, depth_maps.dtype, depth_maps.device)
    z = depth_maps
    p_sq = x_grid * x_grid + y_grid * y_grid + z * z
    cx = centers[..., 0, None, None]
    cy = centers[..., 1, None, None]
    cz = centers[..., 2, None, None]
    p_dot_c = x_grid * cx + y_grid * cy + z[..., None, :, :] * cz
    c_sq = cx * cx + cy * cy + cz * cz
    sq_dist = torch.clamp(p_sq[..., None, :, :] - 2.0 * p_dot_c + c_sq, min=1e-6)
    dist = torch.abs(ieee_sqrt(sq_dist) - radii[..., None, None].to(depth_maps.dtype))
    background = depth_maps > 99.0
    dist = torch.where(background[..., None, :, :], torch.zeros_like(dist), dist)
    nearest = dist.amin(dim=-3)
    return bmean(torch.clamp(nearest, 0.0, 50.0), weights, total)
