"""Soft-argmax 3D joint recovery and heatmap statistics.

Counterpart of ``spherehand_tpu/ops/softargmax.py`` (reference
network/util_modules.py:126-240). All reductions are over the trailing pixel
axes of (..., J, H, W) heatmap stacks.
"""
from __future__ import annotations

import torch

from spherehand_torch.constants import Constants

_C = Constants()


def spatial_softmax(hms: torch.Tensor, sigma: float = 20.0) -> torch.Tensor:
    """Temperature-scaled softmax over the pixel axes."""
    flat = (hms * sigma).flatten(-2)
    return torch.softmax(flat, dim=-1).reshape(hms.shape)


def spatial_normalize(hms: torch.Tensor) -> torch.Tensor:
    """ReLU then sum-normalise over pixels."""
    hms = torch.relu(hms)
    return hms / (hms.sum(dim=(-2, -1), keepdim=True) + 1e-5)


def recover_xyz(uv_hms: torch.Tensor, d_hms: torch.Tensor) -> torch.Tensor:
    """Heatmaps (..., J, H, W) -> 3D joints (..., J, 3) in mm camera space.

    u/v are the softmax(sigma=20) expectation over the integer pixel grid;
    depth is the d-heatmap weighted by the sum-normalised uv heatmap;
    un-projection uses fx = W/300, cx = W/2 and z /= depth_scale.
    """
    size = uv_hms.shape[-1]
    grid = torch.arange(size, dtype=uv_hms.dtype, device=uv_hms.device)
    probs = spatial_softmax(uv_hms)
    u = (probs * grid[None, :]).sum(dim=(-2, -1))
    v = (probs * grid[:, None]).sum(dim=(-2, -1))
    d = (d_hms * spatial_normalize(uv_hms)).sum(dim=(-2, -1))
    fx = size / _C.cube_mm
    c = size / 2.0
    return torch.stack([(u - c) / fx, (v - c) / fx, d / _C.depth_scale], dim=-1)


def heatmap_variance(hms: torch.Tensor) -> torch.Tensor:
    """Spatial variance of heatmap mass, a per-joint confidence proxy:
    (..., J, H, W) -> (..., J). The mean uses softmax(sigma=25) weights, the
    variance relu-normalised weights, over the centred unit grid
    ((g - S/2) / S) (reference util_modules.py:219-240)."""
    size_w, size_h = hms.shape[-1], hms.shape[-2]
    u_grid = ((torch.arange(size_w, dtype=hms.dtype, device=hms.device) - size_w / 2.0)
              / size_w)[None, :]
    v_grid = ((torch.arange(size_h, dtype=hms.dtype, device=hms.device) - size_h / 2.0)
              / size_h)[:, None]
    soft = spatial_softmax(hms, sigma=25.0)
    normed = spatial_normalize(hms)
    u_mean = (soft * u_grid).sum(dim=(-2, -1))[..., None, None]
    u_var = (normed * (u_grid - u_mean) ** 2).sum(dim=(-2, -1))
    v_mean = (soft * v_grid).sum(dim=(-2, -1))[..., None, None]
    v_var = (normed * (v_grid - v_mean) ** 2).sum(dim=(-2, -1))
    return u_var + v_var
