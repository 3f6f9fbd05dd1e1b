"""Analytic orthographic sphere rendering (plain PyTorch, no kernel).

Counterpart of ``render_spheres``/``render_sphere_hand`` in
``spherehand_tpu/render/sphere.py`` (reference mesh/render.py:10-90):

- the image grid is in millimetres, ``x = ((u - W/2) * 300) / W`` as two
  separate operations, u along the last axis, v along the one before;
- the squared surface distance is clamped at 1e-2, and pixels at the clamp
  are background = 100 mm, so a sphere passes no gradient outside its
  silhouette;
- the hand depth map is the min over the 41 sphere part maps.

The fused min-depth + distance op of the loss stack, with its CUDA kernels,
is :mod:`spherehand_torch.render.sphere_cuda`. ``data_to_model_distance``
arrives with its own kernel.
"""
from __future__ import annotations

import torch

from spherehand_torch.constants import Constants

_C = Constants()


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
