"""Device-time breakdown of the port's main path on one GPU, by torch.profiler.

Each piece of the synthetic-render -> serve path runs ``CALLS`` times inside
one profiler window, after warm-up, and ``CALLS`` times more unprofiled for
its host time. For each piece it prints one JSON line, per call:

- ``host_ms``: wall clock, unprofiled, the device synchronised at both ends;
- ``device_ms``: the union of the device activity intervals (kernels, copies,
  memsets) the profiler recorded;
- ``idle_share``: ``1 - device_ms / host_ms``, the share of the call in which
  the card has nothing to run;
- ``launches``: device activities;
- ``top``: the device ops with the most time, as [name, ms, count].

Pieces, at B = 128 (the main path's batch) and 1024: the geometry front end
(``project_faces_planes``), each pre-pass, each kernel, ``render_depth_64``
fast and exact, ``synthesize`` (fast, with noise) and
``PoseEstimator.predict`` with the shipped weights.

Usage: python -m spherehand_torch.profile_path

Needs a CUDA device. Exits non-zero without one, or when the profiler
records no device activity.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

CALLS = 10
SEED = 0
BATCHES = (128, 1024)
TOP = 6
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(_ROOT, "assets", "pretrained", "synthetic_params.npz")


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def device_events(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def host_ms(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def profile_piece(fn, calls: int = CALLS) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    if not events:
        raise SystemExit("profile_path: the profiler recorded no device activity")
    busy = union_us((e.time_range.start, e.time_range.end) for e in events) / 1e3 / calls
    per_name: dict = defaultdict(lambda: [0.0, 0])
    for e in events:
        per_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / calls
        per_name[e.name][1] += 1
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    wall = host_ms(fn, calls)
    return {
        "host_ms": wall,
        "device_ms": busy,
        "idle_share": 1.0 - busy / wall,
        "launches": len(events) / calls,
        "top": [[name[:80], ms, n / calls] for name, (ms, n) in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_path: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from spherehand_torch.data.sampler import sample_poses
    from spherehand_torch.data.synthesizer import draw_synthesis, synthesize
    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.hand.kinematics import forward_kinematics
    from spherehand_torch.hand.skinning import apply_scale, project_faces_planes
    from spherehand_torch.infer import PoseEstimator, load_params_npz
    from spherehand_torch.render import raster_cuda
    from spherehand_torch.render.raster import bilinear_sample_positions, render_depth_64

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}", flush=True)

    dev = torch.device("cuda")
    model = load_hand_model(device=dev)
    samples = torch.as_tensor(bilinear_sample_positions(64, 10), device=dev)
    estimator = PoseEstimator(load_params_npz(PARAMS), num_stacks=1, denoise=True,
                              precision="highest", device=dev)
    for batch in BATCHES:
        gen = torch.Generator(device=dev).manual_seed(SEED + batch)
        poses = sample_poses(gen, batch)
        draws = draw_synthesis(gen, batch)
        tr = apply_scale(forward_kinematics(model, poses), draws.scale_u, 0.1)
        rand_f = draws.rand_f
        planes = project_faces_planes(model, tr, 640.0, rand_f)
        rec_f, box_f = raster_cuda.prepass_fast(planes=planes)
        rec_e, box_e = raster_cuda.prepass_exact(planes=planes)
        dms_mm = synthesize(model, gen, poses).dms * 100.0
        pieces = {
            "planes": lambda: project_faces_planes(model, tr, 640.0, rand_f),
            "prepass_fast": lambda: raster_cuda.prepass_fast(planes=planes),
            "prepass_exact": lambda: raster_cuda.prepass_exact(planes=planes),
            "kernel_fast": lambda: raster_cuda.launch_raster_fast_pooled(
                rec_f, box_f, samples, samples, 100.0),
            "kernel_exact": lambda: raster_cuda.launch_raster_exact(
                rec_e, box_e, samples, samples, 640),
            "render_fast": lambda: render_depth_64(model, tr, rand_f),
            "render_exact": lambda: render_depth_64(model, tr, rand_f, exact=True),
            "synthesize_fast": lambda: synthesize(model, gen, poses, add_noise=True),
            "predict": lambda: estimator.predict(dms_mm),
        }
        for name, fn in pieces.items():
            row = {"piece": name, "batch": batch, **profile_piece(fn)}
            print(json.dumps(row), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
