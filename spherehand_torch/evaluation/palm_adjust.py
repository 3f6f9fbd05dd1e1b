"""Palm-pose adjustment: fit a canonical palm template onto estimated joints.

The port's own copy of ``spherehand_tpu/evaluation/palm_adjust.py`` (numpy
only), a re-design of the reference's ``mesh/adjust_palm_pose.py:1-96``
post-processing tool: estimate a similarity transform (Umeyama, optional
RANSAC) from the canonical 11-point palm template onto the estimated joints,
then replace the palm joints with the transformed template.

Deliberate fix vs the reference: its ``estimate_similarity_transformation``
(adjust_palm_pose.py:37-65) composes the rotation as ``Vh S U^T`` (using the
right-singular ROW basis where the column basis is required) and estimates
scale as ``s1/s2`` — as written it does not recover a known similarity
transform (verified numerically). This implementation is the standard
Umeyama closed form, which does; API and template constants are unchanged.
"""
from __future__ import annotations

import numpy as np

PALM_JOINT_INDICES = list(range(11))

# Canonical palm template (reference adjust_palm_pose.py:9-22).
CANONICAL_PALM_PTS = np.asarray(
    [
        [-15.406372, 79.6443, 52.62097],
        [15.9734955, 82.24512, 47.8826],
        [2.219452, 13.717743, 26.17221],
        [-20.76764, 23.576614, 22.998213],
        [1.736557, 36.935516, 35.718056],
        [0.74661255, 84.52956, 55.28605],
        [1.1482239, 65.221634, 47.347717],
        [-10.020676, 66.30975, 44.136154],
        [-14.763321, 46.575455, 36.9746],
        [17.22052, 23.905838, 24.11928],
        [16.956161, 40.65445, 31.56168],
        [7.968979, 68.520035, 21.761257],
    ]
)

TEMPLATE_INDICES_FOR_ESTIMATION = [2, 4, 8, 10]
REAL_INDICES_FOR_ESTIMATION = [2, 4, 8, 10]


def apply_similarity(points: np.ndarray, rot: np.ndarray, t: np.ndarray, scale: float) -> np.ndarray:
    return scale * points @ rot.T + t.reshape(1, 3)


def estimate_similarity(
    src: np.ndarray, dst: np.ndarray, do_scale: bool = True
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity src -> dst (Umeyama). Returns (R, t, scale)."""
    if len(src) < 3:
        return np.eye(3), np.zeros(3), 1.0
    c_src, c_dst = src.mean(0), dst.mean(0)
    s = src - c_src
    d = dst - c_dst
    cov = d.T @ s / len(src)
    u, sing, vt = np.linalg.svd(cov)
    sign = np.sign(np.linalg.det(u @ vt))
    diag = np.diag([1.0, 1.0, sign])
    rot = u @ diag @ vt
    var_src = (s**2).sum() / len(src)
    scale = float((sing * np.diag(diag)).sum() / var_src) if do_scale else 1.0
    t = c_dst - scale * rot @ c_src
    return rot, t, scale


def estimate_similarity_ransac(
    src: np.ndarray,
    dst: np.ndarray,
    do_scale: bool = True,
    iterations: int = 10,
    inlier_thresh: float = 15.0,
    rng: np.random.RandomState | None = None,
) -> tuple[np.ndarray, np.ndarray, float]:
    """3-point RANSAC around :func:`estimate_similarity`
    (reference adjust_palm_pose.py:67-81)."""
    rng = rng or np.random.RandomState(0)
    best_inliers: np.ndarray = np.arange(0)
    for _ in range(iterations):
        pick = rng.permutation(len(src))[:3]
        rot, t, scale = estimate_similarity(src[pick], dst[pick], do_scale)
        err = np.sqrt(((apply_similarity(src, rot, t, scale) - dst) ** 2).sum(-1))
        inliers = np.nonzero(err < inlier_thresh)[0]
        if len(inliers) > len(best_inliers):
            best_inliers = inliers
    if len(best_inliers) < 3:
        best_inliers = np.arange(len(src))
    return estimate_similarity(src[best_inliers], dst[best_inliers], do_scale)


def adjust_palm_pose(joints: np.ndarray) -> np.ndarray:
    """Replace the 11 palm joints with the similarity-fitted template
    (reference adjust_palm_pose.py:88-96)."""
    joints = joints.reshape(-1, 3)
    rot, t, scale = estimate_similarity(
        CANONICAL_PALM_PTS[TEMPLATE_INDICES_FOR_ESTIMATION],
        joints[REAL_INDICES_FOR_ESTIMATION],
        True,
    )
    adjusted = joints.copy()
    adjusted[PALM_JOINT_INDICES] = apply_similarity(
        CANONICAL_PALM_PTS[PALM_JOINT_INDICES], rot, t, scale
    )
    return adjusted
