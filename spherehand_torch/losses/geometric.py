"""Geometric pose priors: collision and bone-length losses.

Counterpart of ``spherehand_tpu/losses/geometric.py`` (reference
mesh/render.py:145-206, tables mesh/bone_length.py:36-56).
"""
from __future__ import annotations

import torch

from spherehand_torch import constants as C
from spherehand_torch.ops.reduce import bmean, bsum

_COLL_J1, _COLL_J2 = C.collision_pairs()


def _pair_sq_dist(joints: torch.Tensor, j1, j2) -> torch.Tensor:
    """joints (..., J, 3) -> squared distances (..., P) for index pairs."""
    diff = joints[..., j1, :] - joints[..., j2, :]
    return (diff * diff).sum(dim=-1)


def collision_loss(
    joints: torch.Tensor, min_dist: float = 6.0, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Sum of relu(min_dist^2 - d^2) over the 690 palm/finger pairs and the
    batch. joints (..., 41, 3) mm; ``weights`` (batch,) zeroes padded rows."""
    sq = _pair_sq_dist(joints, _COLL_J1, _COLL_J2)
    return bsum(torch.relu(min_dist * min_dist - sq), weights)


def bone_length_loss(joints: torch.Tensor, weights: torch.Tensor | None = None,
                     total=None) -> torch.Tensor:
    """Penalty outside [0.80 L, 1.05 L] of the 35 median bone lengths: the
    lower and upper squared-length violations, each averaged, summed.
    ``total``: the global row count on one rank of several (``ops.reduce``)."""
    sq = _pair_sq_dist(joints, C.BONE_PAIRS_J1, C.BONE_PAIRS_J2)
    min_sq = torch.as_tensor((C.BONE_MEDIAN_LENGTH * 0.80) ** 2, dtype=sq.dtype, device=sq.device)
    max_sq = torch.as_tensor((C.BONE_MEDIAN_LENGTH * 1.05) ** 2, dtype=sq.dtype, device=sq.device)
    return (bmean(torch.relu(min_sq - sq), weights, total)
            + bmean(torch.relu(sq - max_sq), weights, total))
