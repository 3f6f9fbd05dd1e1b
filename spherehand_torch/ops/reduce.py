"""Batch-weighted reductions for padded batches.

Counterpart of ``spherehand_tpu/ops/reduce.py``. A batch padded with
duplicate rows at weight 0 reduces as if the padding were absent: padded
rows contribute zero loss and zero gradient. ``weights=None`` means every
row is real and reduces to the plain torch op.

``total``: on one rank of several (``parallel.mesh``), the batch's global
weight total (its count of true rows). A weighted mean then divides by it
rather than by the rank's own weight sum, so each rank's value is its exact
share of the global mean and the shares sum to it. ``None`` (one device)
keeps the local denominator, bit for bit as without the argument.
"""
from __future__ import annotations

import torch


def _broadcast(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B,) weights -> (B, 1, 1, ...) matching x's rank."""
    return w.reshape(w.shape + (1,) * (x.dim() - 1)).to(x.dtype)


def _denominator(weights: torch.Tensor | None, total) -> torch.Tensor | float:
    return weights.sum() if total is None else float(total)


def bmean(x: torch.Tensor, weights: torch.Tensor | None, total=None) -> torch.Tensor:
    """Mean over all elements of x (axis 0 = batch), weighting rows."""
    if weights is None and total is None:
        return x.mean()
    per_row = x.numel() // x.shape[0]
    num = x.sum() if weights is None else (x * _broadcast(weights, x)).sum()
    return num / (_denominator(weights, total) * per_row)


def bsum(x: torch.Tensor, weights: torch.Tensor | None) -> torch.Tensor:
    """Sum over all elements of x, zeroing padded rows."""
    if weights is None:
        return x.sum()
    return (x * _broadcast(weights, x)).sum()


def bmean_keep(x: torch.Tensor, weights: torch.Tensor | None, axes,
               total=None) -> torch.Tensor:
    """Weighted mean over the batch axis 0 plus the given axes, keeping the
    rest (e.g. a per-view mean over (batch, H, W))."""
    dims = (0, *axes)
    if weights is None and total is None:
        return x.mean(dim=dims)
    num = (x if weights is None else x * _broadcast(weights, x)).sum(dim=dims)
    per_row = 1
    for a in axes:
        per_row *= x.shape[a]
    return num / (_denominator(weights, total) * per_row)
