"""Serving-path benchmark: depth crops -> joints, device time and scanned wall.

Counterpart of the JAX package's ``tools/bench_infer.py``, step for step.
It serves ``assets/pretrained/synthetic_params.npz`` with
``PoseEstimator(num_stacks=1, denoise=True)`` (the hourglass forward,
soft-argmax and the palm denoiser) at serving precision (PyTorch's
defaults: cuDNN convolutions in TF32), the deterministic settings off, on
the JAX tool's crops (100 mm background, a 24 x 24 patch uniform in 20-60
mm from ``np.random.RandomState(0)``), and times each batch size two ways:

- ``device_ms``: the union of the device activities that torch.profiler
  records over 3 ``predict`` calls (``profile_path.device_events`` and
  ``union_us``), the host<->device copies left out, over 3: the per-call
  device time of the predictor's own work, as the JAX tool's is the time
  of its ``jit__predict`` program, which holds no transfer. The copies'
  own ms a call (the pageable crops in, joints and heatmaps out) and the
  union with them are printed on the batch's line (``split_copies``).
  B = 1024 runs as ``serve_chunk`` chunks of 128, as ``predict`` does.
- ``wall_ms_scanned``: the counterpart of the JAX ``lax.scan``: ``ITERS``
  calls of the estimator's device predictor (``_predict_local``; ``_predict``
  itself reads each result back to the host) on the pre-scaled crops plus
  0.001 x i, in one window on the host clock, with no copy to the host
  between calls; a sum of every call's mean joint is carried and one
  synchronise ends the window. The best of ``WINDOWS`` windows.
- ``crops_per_sec_device`` and ``crops_per_sec_wall``: B over each.

Prints one line a batch, then one JSON line ``{"metric": "serving_latency",
"results": [...], "gpu_name", "gpu_power_limit"}``. Any failure exits
non-zero; nothing is printed as ``None``. ``--device cpu`` runs the same
code on the CPU for the tests: its numbers are the CPU's (the profiler's
CPU operators stand in for the device activities) and its identity says
so; they are no card's.

Usage: python -m spherehand_torch.tools.bench_infer [batches="1,8,128,1024"] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from spherehand_torch.constants import Constants
from spherehand_torch.device import resolve_device
from spherehand_torch.infer import PoseEstimator, float32_precision, load_params_npz
from spherehand_torch.profile_path import PARAMS, TRACE_ATTEMPTS, device_events, union_us

BATCHES = "1,8,128,1024"
CALLS = 3    # predict calls in the traced window
ITERS = 50   # calls in a scanned window
WINDOWS = 3  # scanned windows; the best is kept
COPIES = ("Memcpy HtoD", "Memcpy DtoH")  # the host<->device copies' activity names


def crops(rng: np.random.RandomState, batch: int) -> np.ndarray:
    """The JAX tool's crops in mm: background 100, a uniform 24 x 24 patch."""
    dms = np.full((batch, 64, 64), 100.0, np.float32)
    dms[:, 20:44, 20:44] = rng.uniform(20, 60, (batch, 24, 24))
    return dms


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def split_copies(spans) -> tuple[float, float, float]:
    """(the union of the spans that are not host<->device copies, the union
    of the copies, the union of all) over ``(name, start, end)`` spans, in
    their unit."""
    spans = list(spans)
    own = [(a, b) for name, a, b in spans if not name.startswith(COPIES)]
    copies = [(a, b) for name, a, b in spans if name.startswith(COPIES)]
    return union_us(own), union_us(copies), union_us((a, b) for _, a, b in spans)


def device_ms(est: PoseEstimator, dms: np.ndarray,
              calls: int = CALLS) -> tuple[float, float, float]:
    """Device ms a ``predict`` call over ``calls`` calls, by ``split_copies``
    of the traced activities: (its own work, the host<->device copies, the
    union of both)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = est.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    # The tracer now and then keeps no device activity of a whole trace
    # (profile_path): such a trace is taken again.
    for _ in range(TRACE_ATTEMPTS):
        with profile(activities=activities) as prof:
            for _ in range(calls):
                est.predict(dms)
            _sync(est.device)
        events = (device_events(prof) if cuda else
                  [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU])
        if events:
            return tuple(us / 1e3 / calls for us in split_copies(
                (e.name, e.time_range.start, e.time_range.end) for e in events))
    raise RuntimeError("bench_infer: the profiler recorded no device activity")


def scanned_wall_ms(est: PoseEstimator, dms: np.ndarray, iters: int = ITERS,
                    windows: int = WINDOWS) -> float:
    """Host ms a call with ``iters`` calls in one window, the best of
    ``windows``: each call's input varies (+ 0.001 x i) and a reduction of
    its joints is carried, so no call can be skipped."""
    base = torch.as_tensor(dms, device=est.device) * Constants().depth_scale
    replica = est.replicas[0]

    def window() -> torch.Tensor:
        acc = torch.zeros((), device=est.device)
        with float32_precision(est.precision):
            for i in range(iters):
                joints, _ = est._predict_local(replica, base + 0.001 * i)
                acc = acc + joints.mean()
        return acc

    window()  # warm-up
    _sync(est.device)
    best = math.inf
    for _ in range(windows):
        t0 = time.perf_counter()
        acc = window()
        _sync(est.device)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
        if not torch.isfinite(acc):
            raise RuntimeError(f"bench_infer: non-finite joints in a window ({float(acc)})")
    return best


def measure_batch(est: PoseEstimator, dms: np.ndarray, calls: int = CALLS, iters: int = ITERS,
                  windows: int = WINDOWS) -> dict:
    """One batch's record, the JAX tool's keys, printed on a line with the
    copies' ms and the union with them; raises if a number is not finite
    and positive."""
    batch = dms.shape[0]
    est.predict(dms)  # warm-up
    dev_ms, copies_ms, union_ms = device_ms(est, dms, calls)
    wall_ms = scanned_wall_ms(est, dms, iters, windows)
    if not all(math.isfinite(v) and v > 0 for v in (dev_ms, wall_ms)):
        raise RuntimeError(f"bench_infer: B = {batch}: device {dev_ms} ms, wall {wall_ms} ms: "
                           "not finite and positive")
    print(f"B={batch:5d}: {dev_ms:7.3f} ms device  {wall_ms:7.3f} ms wall(scan)  "
          f"{round(batch / dev_ms * 1e3):10,d} crops/s dev  "
          f"{round(batch / wall_ms * 1e3):10,d} crops/s wall  copies {copies_ms:.4f} ms  "
          f"union with them {union_ms:.4f} ms", flush=True)
    return {
        "batch": batch,
        "device_ms": round(dev_ms, 4),
        "wall_ms_scanned": round(wall_ms, 4),
        "crops_per_sec_device": round(batch / dev_ms * 1e3),
        "crops_per_sec_wall": round(batch / wall_ms * 1e3),
    }


def identity(device: torch.device) -> dict:
    """The card's name and power limit (``nvidia-smi``); on the CPU, that
    no card was measured."""
    if device.type == "cuda":
        from spherehand_torch.bench import gpu_identity

        return gpu_identity()
    return {"gpu_name": "none (CPU run)", "gpu_power_limit": "none (CPU run)"}


def run(batches: list[int], device: torch.device | str | None = None, calls: int = CALLS,
        iters: int = ITERS, windows: int = WINDOWS) -> dict:
    """Every batch's record (``measure_batch``) and the card's identity."""
    dev = resolve_device(device)
    est = PoseEstimator(load_params_npz(PARAMS), num_stacks=1, denoise=True, device=dev)
    rng = np.random.RandomState(0)
    results = [measure_batch(est, crops(rng, b), calls, iters, windows) for b in batches]
    return {"results": results, **identity(dev)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batches", nargs="?", default=BATCHES, help="comma list of batch sizes")
    ap.add_argument("--device", default="cuda", help="torch device (cpu: the tests' run)")
    args = ap.parse_args(argv)
    out = run([int(b) for b in args.batches.split(",")], args.device)
    print(json.dumps({"metric": "serving_latency", "results": out["results"],
                      "gpu_name": out["gpu_name"], "gpu_power_limit": out["gpu_power_limit"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
