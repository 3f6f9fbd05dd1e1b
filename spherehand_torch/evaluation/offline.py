"""Offline evaluation: per-joint errors, mean error, PCK curve.

Counterpart of ``spherehand_tpu/evaluation/offline.py`` (reference
``dataset/evaluation.py:8-105``), the port's own numpy copy. Consumes a
result file with ``gt`` (N[, V], 36, 3) and ``est`` (N[, V], 41, 3) joint
arrays — either the reference's ``result.pkl`` or our ``result.npz`` (the
engine's eval writes the npz form) — and emits the same artifacts:
``per_joint_mean_error.txt``, ``mean_error.txt``, and the max-error
threshold curve ``max_error.png``/``.txt`` (thresholds 0.5..80.5 mm step 5).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from spherehand_torch import constants as C
from spherehand_torch.evaluation.metrics import max_error_curve


def load_result_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    if path.endswith(".npz"):
        data = np.load(path)
        gt, est = data["gt"], data["est"]
    else:
        with open(path, "rb") as f:
            results = pickle.load(f)
        gt, est = results["gt"], results["est"]
    if gt.ndim == 4:
        gt = gt.reshape(-1, gt.shape[-2], 3)
    if est.ndim == 4:
        est = est.reshape(-1, est.shape[-2], 3)
    return np.asarray(gt), np.asarray(est)


def evaluate_result_file(
    path: str,
    synt_points: tuple = C.EVAL_SYNT_KEY_POINTS,
    real_points: tuple = C.EVAL_REAL_KEY_POINTS,
    make_plot: bool = True,
) -> dict:
    """Run the full offline evaluation; writes artifacts next to ``path``.

    Returns {mean_error, per_joint_error (K,), thresholds, fractions}.
    """
    gt, est = load_result_file(path)
    gt = gt[:, list(real_points)]
    est = est[:, list(synt_points)]
    errors = np.linalg.norm(gt - est, axis=-1)  # (N, K)

    out_dir = os.path.dirname(os.path.abspath(path))
    per_joint = errors.mean(axis=0)
    with open(os.path.join(out_dir, "per_joint_mean_error.txt"), "w") as f:
        for idx, e in enumerate(per_joint):
            f.write(f"{idx}: {e}\n")

    mean_error = float(errors.mean())
    with open(os.path.join(out_dir, "mean_error.txt"), "w") as f:
        f.write(f"average error: {mean_error}\n")

    thresholds, fractions = max_error_curve(errors)
    curve_path = os.path.join(out_dir, "max_error")
    with open(curve_path + ".txt", "w") as f:
        for t, p in zip(thresholds, fractions):
            f.write(f"{t:f} {p * 100.0:f}\n")
        f.write(f"{list(fractions)}\n")
    if make_plot:  # matplotlib is imported only here: the rest runs without it
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.clf()
        plt.plot(thresholds, fractions)
        plt.grid(True)
        plt.xlabel("max error thresh(mm)")
        plt.ylabel("percentage")
        plt.title("max joint error")
        plt.savefig(curve_path + ".png")

    return {
        "mean_error": mean_error,
        "per_joint_error": per_joint,
        "thresholds": thresholds,
        "fractions": fractions,
    }
