"""The rasterizers' parity contracts, as statistics and checks.

- Exact mode against its oracle (``tests/test_raster_pallas.py:229-232``,
  ``:246-248``): coverage match 1.0, median |diff| 0, fraction of samples
  more than 1 mm off under 1e-4.
- Fast mode against exact (``raster_pallas.py:81-96``): raw foreground IoU
  > 0.999, p99 |diff| < 0.5 mm on jointly covered raw samples, pooled median
  |diff| < 0.05 mm, fraction of pooled pixels more than 0.5 mm off < 0.005.

Inputs are numpy arrays or tensors (moved to the host); raw buffers use
background 1000, pooled ones the clamp 100.
"""
from __future__ import annotations

import numpy as np


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
