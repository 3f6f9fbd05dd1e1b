"""The rasterizers' parity contracts, as statistics and checks.

- Exact mode against its oracle (``tests/test_raster_pallas.py:229-232``,
  ``:246-248``): coverage match 1.0, median |diff| 0, fraction of samples
  more than 1 mm off under 1e-4.
- Fast mode against exact (``raster_pallas.py:81-96``): raw foreground IoU
  > 0.999, p99 |diff| < 0.5 mm on jointly covered raw samples, pooled median
  |diff| < 0.05 mm, fraction of pooled pixels more than 0.5 mm off < 0.005.

- The fused sphere kernels against their plain versions (below).

Inputs are numpy arrays or tensors (moved to the host); raw buffers use
background 1000, pooled ones the clamp 100.
"""
from __future__ import annotations

import numpy as np
import torch

from spherehand_torch.render import sphere_cuda as sc


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def exact_stats(ours, ref) -> dict:
    ours, ref = _np(ours), _np(ref)
    d = np.abs(ours - ref)
    return {
        "coverage_match": float(((ours < 999) == (ref < 999)).mean()),
        "median_diff": float(np.median(d)),
        "big_diff_frac": float((d > 1.0).mean()),
        "max_abs_err": float(d.max()),
    }


def exact_ok(stats: dict) -> bool:
    return (stats["coverage_match"] == 1.0 and stats["median_diff"] == 0.0
            and stats["big_diff_frac"] < 1e-4)


def fast_stats(fast_pooled, exact_pooled, fast_raw=None, exact_raw=None) -> dict:
    d = np.abs(_np(fast_pooled) - _np(exact_pooled))
    stats = {
        "pooled_median": float(np.median(d)),
        "pooled_big_frac": float((d > 0.5).mean()),
    }
    if fast_raw is not None:
        fr, er = _np(fast_raw), _np(exact_raw)
        fg_f, fg_e = fr < 999, er < 999
        both = fg_f & fg_e
        stats["raw_iou"] = float(both.sum() / max((fg_f | fg_e).sum(), 1))
        stats["raw_p99"] = float(np.percentile(np.abs(fr - er)[both], 99)) if both.any() else 0.0
    return stats


def fast_ok(stats: dict) -> bool:
    ok = stats["pooled_median"] < 0.05 and stats["pooled_big_frac"] < 0.005
    if "raw_iou" in stats:
        ok = ok and stats["raw_iou"] > 0.999 and stats["raw_p99"] < 0.5
    return ok


# The fused sphere kernels (render/sphere_cuda.py) against their plain
# versions on the same inputs: forward fields and argmin planes identical
# (both round operation for operation in one order), weight planes within
# SPHERE_WEIGHT_ULPS, the backward within SPHERE_BWD_REL (max |diff| over max
# |reference|; the sums are taken in another order) of fused_bwd_plain on the
# kernel's own planes and of autograd through fused_primal_plain, two
# backward runs bit-identical, and the primal kernel's fields equal to the
# forward kernel's.
SPHERE_WEIGHT_ULPS = 1
SPHERE_BWD_REL = 1e-5


def _max_ulps(a, b) -> int:
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max())


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def sphere_kernel_stats(centers, target, radii, size: int, views: int,
                        generator: torch.Generator) -> dict:
    """Run the three sphere kernels and their plain versions on one input
    set (CUDA tensors) with random cotangents; returns the statistics the
    contract above reads, and the kernel outputs under ``"kernel"``."""
    fwd_k = sc.launch_fused(centers, target, radii, size, views, residuals=True)
    fwd_p = sc.fused_fwd_plain(centers, target, radii, size, views)
    prim_k = sc.launch_fused(centers, target, radii, size, views, residuals=False)
    prim_p = sc.fused_primal_plain(centers, target, radii, size, views)
    g_depth, g_dist = (torch.rand(fwd_k[0].shape, generator=generator, device=centers.device)
                       * 2.0 - 1.0 for _ in range(2))
    bwd_k = sc.launch_fused_bwd(centers, target, views, g_depth, g_dist, *fwd_k[2:])
    bwd_k2 = sc.launch_fused_bwd(centers, target, views, g_depth, g_dist, *fwd_k[2:])
    bwd_p = sc.fused_bwd_plain(centers, target, views, g_depth, g_dist, *fwd_k[2:])
    leaf = centers.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        depth, dist = sc.fused_primal_plain(leaf, target, radii, size, views)
        ((depth * g_depth).sum() + (dist * g_dist).sum()).backward()
    torch.cuda.synchronize()
    return {
        "fields_max_abs_err": max(float((fwd_k[i] - fwd_p[i]).abs().max()) for i in (0, 1)),
        "primal_max_abs_err": max(float((prim_k[i] - prim_p[i]).abs().max()) for i in (0, 1)),
        "primal_vs_fwd": max(float((prim_k[i] - fwd_k[i]).abs().max()) for i in (0, 1)),
        "argmin_mismatch": int((fwd_k[2] != fwd_p[2]).sum() + (fwd_k[4] != fwd_p[4]).sum()),
        "weight_ulps": max(_max_ulps(fwd_k[3], fwd_p[3]), _max_ulps(fwd_k[5], fwd_p[5])),
        "bwd_max_abs_err": float((bwd_k - bwd_p).abs().max()),
        "bwd_rel_plain": _rel(bwd_k, bwd_p),
        "bwd_rel_autograd": _rel(bwd_k, leaf.grad),
        "bwd_deterministic": bool(torch.equal(bwd_k, bwd_k2)),
        "kernel": {"fwd": fwd_k, "primal": prim_k, "bwd": bwd_k},
    }


def sphere_ok(stats: dict) -> bool:
    return (stats["fields_max_abs_err"] == 0.0 and stats["primal_max_abs_err"] == 0.0
            and stats["primal_vs_fwd"] == 0.0 and stats["argmin_mismatch"] == 0
            and stats["weight_ulps"] <= SPHERE_WEIGHT_ULPS
            and stats["bwd_rel_plain"] <= SPHERE_BWD_REL
            and stats["bwd_rel_autograd"] <= SPHERE_BWD_REL
            and stats["bwd_deterministic"])


def sphere_tie_violations(stats: dict, duplicates=((0, 1), (2, 3))) -> int:
    """On ``adversarial.sphere_adversarial_case``: pixels where a duplicate
    sphere (the higher j of a tied pair) won an argmin, plus duplicate
    spheres with a nonzero gradient. The lowest-j rule makes both 0."""
    fwd, bwd = stats["kernel"]["fwd"], stats["kernel"]["bwd"]
    bad = 0
    for _, dup in duplicates:
        bad += int((fwd[2] == dup).sum() + (fwd[4] == dup).sum())
        bad += int((bwd[:, dup] != 0).any(dim=-1).sum())
    return bad
