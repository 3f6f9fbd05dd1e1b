"""The rasterizers' parity contracts, as statistics and checks.

- Exact mode against its oracle (``tests/test_raster_pallas.py:229-232``,
  ``:246-248``): coverage match 1.0, median |diff| 0, fraction of samples
  more than 1 mm off under 1e-4.
- Fast mode against exact (``raster_pallas.py:81-96``): raw foreground IoU
  > 0.999, p99 |diff| < 0.5 mm on jointly covered raw samples, pooled median
  |diff| < 0.05 mm, fraction of pooled pixels more than 0.5 mm off < 0.005.

- The sphere kernels against their plain versions (below).

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


# The sphere kernels (render/sphere_cuda.py) of one field set against their
# plain versions on the same inputs: forward fields and argmin planes
# identical (both round operation for operation in one order), weight planes
# within SPHERE_WEIGHT_ULPS, the backward within SPHERE_BWD_REL (max |diff|
# over max |reference|; the sums are taken in another order) of the plain
# backward on the kernel's own planes and of autograd through the plain
# primal fields, two backward runs bit-identical, and the primal kernel's
# fields equal to the forward kernel's. A NaN (from a NaN observation) must
# stand at the same place in both; autograd is compared on the images whose
# observation is finite (through a NaN field it gives a gradient of its own
# that the ops' backward, like the JAX kernels', does not follow).
SPHERE_WEIGHT_ULPS = 1
SPHERE_BWD_REL = 1e-5


def same_bits(a, b) -> bool:
    """Whether two float32 or int32 tensors hold the same bits (NaN included)."""
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _max_abs(a, b) -> float:
    """max |a - b| where equal values and NaN against NaN count 0, and a NaN
    against a number counts inf."""
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() else 0.0


def _max_ulps(a, b) -> int:
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(ia), (ia - ib).abs())
    return int(d.max())


def _rel(a, b) -> float:
    scale = b.abs()[torch.isfinite(b)]
    return _max_abs(a, b) / max(float(scale.max()) if scale.numel() else 0.0, 1e-30)


def sphere_fwd_stats(ours, ref, k: int) -> dict:
    """Two forwards' planes (the k fields, then each field's argmin and
    weight planes) against each other, as :func:`sphere_kernel_stats` reads
    them."""
    amins, weights = range(k, 3 * k, 2), range(k + 1, 3 * k, 2)
    return {
        "fields_max_abs_err": max(_max_abs(ours[i], ref[i]) for i in range(k)),
        "argmin_mismatch": sum(int((ours[i] != ref[i]).sum()) for i in amins),
        "weight_ulps": max(_max_ulps(ours[i], ref[i]) for i in weights),
    }


def sphere_kernel_stats(centers, target, radii, size: int, views: int,
                        generator: torch.Generator, fields: int = sc.BOTH) -> dict:
    """Run the sphere kernels of ``fields`` (``sc.DEPTH``, ``sc.DIST`` or
    ``sc.BOTH``) and their plain versions on one input set (CUDA tensors)
    with random cotangents; returns the statistics the contract above reads,
    and the kernel outputs under ``"kernel"``: ``fwd`` (the fields, then
    each field's argmin and weight planes), ``primal`` and ``bwd``. The
    cotangents are drawn for both fields whatever ``fields`` is, so a
    generator seeded alike gives every field set the same ones."""
    k = sc.num_fields(fields)
    args = (fields, centers, target, radii, size, views)
    fwd_k = sc.launch_fields(*args, residuals=True)
    fwd_p = sc.fields_plain(*args, residuals=True)
    prim_k = sc.launch_fields(*args, residuals=False)
    prim_p = sc.fields_plain(*args, residuals=False)
    g_both = [torch.rand((centers.shape[0], size, size), generator=generator,
                         device=centers.device) * 2.0 - 1.0 for _ in range(2)]
    grads = [g for g, f in zip(g_both, (sc.DEPTH, sc.DIST)) if fields & f]
    bwd_args = (fields, centers, target, views, grads, fwd_k[k:])
    bwd_k = sc.launch_fields_bwd(*bwd_args)
    bwd_k2 = sc.launch_fields_bwd(*bwd_args)
    bwd_p = sc.fields_bwd_plain(*bwd_args)
    leaf = centers.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        planes = sc.fields_plain(fields, leaf, target, radii, size, views)
        sum((p * g).sum() for p, g in zip(planes, grads)).backward()
    finite = torch.ones(centers.shape[0], dtype=torch.bool, device=centers.device)
    if fields & sc.DIST:
        z = sc.gathered_target(target, centers.shape[0], views)
        finite = torch.isfinite(z).flatten(1).all(dim=1)
    torch.cuda.synchronize()
    fwd = sphere_fwd_stats(fwd_k, fwd_p, k)
    return {
        "fields_max_abs_err": fwd["fields_max_abs_err"],
        "primal_max_abs_err": max(_max_abs(prim_k[i], prim_p[i]) for i in range(k)),
        "primal_vs_fwd": max(_max_abs(prim_k[i], fwd_k[i]) for i in range(k)),
        "argmin_mismatch": fwd["argmin_mismatch"],
        "weight_ulps": fwd["weight_ulps"],
        "bwd_max_abs_err": _max_abs(bwd_k, bwd_p),
        "bwd_rel_plain": _rel(bwd_k, bwd_p),
        "bwd_rel_autograd": _rel(bwd_k[finite], leaf.grad[finite]),
        "bwd_deterministic": same_bits(bwd_k, bwd_k2),
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
    k = len(fwd) // 3
    bad = 0
    for _, dup in duplicates:
        bad += sum(int((fwd[i] == dup).sum()) for i in range(k, 3 * k, 2))
        bad += int((bwd[:, dup] != 0).any(dim=-1).sum())
    return bad


def split_fused_planes(fused_fwd) -> dict:
    """The six planes of the two-field forward (depth, dist, amind, wd,
    aminm, wm) as the one-field forwards give them: {DEPTH: (depth, amind,
    wd), DIST: (dist, aminm, wm)}."""
    depth, dist, amind, wd, aminm, wm = fused_fwd
    return {sc.DEPTH: (depth, amind, wd), sc.DIST: (dist, aminm, wm)}
