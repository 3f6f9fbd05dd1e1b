"""Joint-error metrics over the synthetic <-> NYU keypoint correspondence.

Counterpart of ``spherehand_tpu/evaluation/metrics.py`` (reference
network/utils_metric.py:7-17 and dataset/evaluation.py:59-79). The padded-row
weights of the data-parallel path arrive with that path.
"""
from __future__ import annotations

import numpy as np
import torch

from spherehand_torch import constants as C


def average_joint_error(
    gt_joints: torch.Tensor,
    est_joints: torch.Tensor,
    synt_points: tuple = C.SYNT_KEY_POINTS,
    real_points: tuple = C.REAL_KEY_POINTS,
) -> torch.Tensor:
    """Mean L2 error (mm): gt (..., 36, 3) NYU joints vs est (..., 41, 3)."""
    gt = gt_joints[..., list(real_points), :]
    est = est_joints[..., list(synt_points), :]
    return torch.linalg.norm(gt - est, dim=-1).mean()


def per_joint_error(
    gt_joints: torch.Tensor,
    est_joints: torch.Tensor,
    synt_points: tuple = C.EVAL_SYNT_KEY_POINTS,
    real_points: tuple = C.EVAL_REAL_KEY_POINTS,
) -> torch.Tensor:
    """Per-sample, per-keypoint L2 errors (..., K)."""
    gt = gt_joints[..., list(real_points), :]
    est = est_joints[..., list(synt_points), :]
    return torch.linalg.norm(gt - est, dim=-1)


def max_error_curve(
    errors: np.ndarray, thresholds: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Fraction of samples whose worst keypoint error is under each
    threshold (default 0.5..80.5 mm, step 5). errors: (N, K)."""
    if thresholds is None:
        thresholds = np.arange(0.5, 81.0, 5.0)
    worst = np.max(np.asarray(errors), axis=-1)
    frac = np.asarray([(worst < t).mean() for t in thresholds])
    return thresholds, frac
