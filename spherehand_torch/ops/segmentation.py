"""Joint-guided depth segmentation.

Counterpart of ``spherehand_tpu/ops/segmentation.py`` (reference
network/util_modules.py:309-346): pixels farther than 7 px (uv) from every
projected joint are reset to background (100 mm). The reference engine wires
it to ``None`` (engine.py:79); it is part of the API.
"""
from __future__ import annotations

import torch

from spherehand_torch.constants import Constants

_C = Constants()


@torch.no_grad()
def segment_depth(dms: torch.Tensor, joints: torch.Tensor,
                  radius_px: float = 7.0) -> torch.Tensor:
    """dms (..., H, W) mm; joints (..., J, 3) mm camera space. Returns the
    segmented depth, without gradient (the reference's ``.detach()``)."""
    height, width = dms.shape[-2:]
    u = joints[..., 0] * (width / _C.cube_mm) + width / 2.0  # (..., J)
    v = joints[..., 1] * (height / _C.cube_mm) + height / 2.0
    u_grid = torch.arange(width, dtype=dms.dtype, device=dms.device)[None, :]
    v_grid = torch.arange(height, dtype=dms.dtype, device=dms.device)[:, None]
    sq = (u[..., None, None] - u_grid) ** 2 + (v[..., None, None] - v_grid) ** 2
    min_dist = torch.sqrt(sq.amin(dim=-3))
    return torch.where(min_dist > radius_px, torch.full_like(dms, _C.background_depth), dms)
