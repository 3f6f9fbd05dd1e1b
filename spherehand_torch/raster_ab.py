"""The raster kernels of the checkout against another build, and raw fast scan against bins, on one GPU.

Two comparisons, each timed in turns (A, B, B, A) in one process, one JSON
line a turn:

- ``raster_fast_pooled`` and ``raster_exact`` of the checkout against a
  build of the source given by ``--baseline`` (another version of
  ``csrc/raster.cu`` whose two entry points ``shx_raster_fast_pooled`` and
  ``shx_raster_exact`` have the same C interface), built with the build's
  own flags, at B = 128 and 1024 on the 128 x 128 sample grid of
  ``render_depth_64``; with ``--raw``, whose ``shx_raster_fast`` reads the
  planes too, also ``raster_fast`` (binned) at those shapes and on the
  canvas below. Before the turns both builds' canvases must agree bit for
  bit.
- ``raster_fast`` with its face lists from the binning pass against the
  same kernel scanning all faces in every z-tile
  (``raster_cuda._raster_fast(..., binned)``), at B = 128 and 1024 on the
  128 x 128 grid and at B = 32 on the whole 640 x 640 canvas; both must
  agree bit for bit. Each row also gives the binning scratch (counts and
  lists, int32) at that shape.

Per kernel and shape a turn gives ``event_ms``, the CUDA-event median of 20
single launches, each synchronised, as ``chip_smoke.py`` times them, and
``device_ms``, device ms a call by torch.profiler
(``profile_path.profile_piece``: for the binned variant the union of the
memset, the binning pass and the raster), and for ``raster_fast`` the
device ms of each of those activities. The last lines are each build's
and variant's means over its two turns and the card's name and power limit.

Hands: sampler poses with synthesis draws, seed 3 (``raster_sweep``'s).

Usage: python -m spherehand_torch.raster_ab [--baseline path/to/raster.cu [--raw]]

Needs a CUDA device and nvcc; exits non-zero without a device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

SEED = 3
GRID_BATCHES = (128, 1024)
CANVAS = 640
CANVAS_BATCH = 32


def bind_baseline(source: str):
    """nvcc ``source`` with the build's flags into ``build/`` and declare
    its two z-tile entry points."""
    from spherehand_torch import cuda_build

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(cuda_build.BUILD_DIR, "libshx_raster_baseline.so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {source} failed:\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"    baseline {line.strip()}", flush=True)
    lib = ctypes.CDLL(out)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.shx_raster_fast_pooled.argtypes = [ptr] * 6 + [i32] * 4 + [f32, ptr]
    lib.shx_raster_fast_pooled.restype = i32
    lib.shx_raster_exact.argtypes = [ptr] * 6 + [i32] * 4 + [f32, f32, ptr]
    lib.shx_raster_exact.restype = i32
    lib.shx_raster_fast.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.shx_raster_fast.restype = i32
    return lib


def ztile_calls(lib, planes, samples, kernels) -> dict:
    """{kernel: call} for ``kernels`` of ``lib`` (``raster_fast`` binned) on
    one geometry; each call writes its own canvas and returns it."""
    from spherehand_torch.render import raster_cuda

    batch, num_faces = planes[0].shape[0], planes[0].shape[1] // 3
    n = samples.numel()
    dev = samples.device
    ptrs = [p.data_ptr() for p in planes]
    pooled = torch.empty((batch, n // 2, n // 2), device=dev)
    exact = torch.empty((batch, n, n), device=dev)
    if "raster_fast" in kernels:
        tiles_x, tiles_y = raster_cuda.ztiles(n, n)
        counts = torch.empty((batch * tiles_x * tiles_y,), dtype=torch.int32, device=dev)
        lists = torch.empty((batch * tiles_x * tiles_y, num_faces), dtype=torch.int32, device=dev)

    def run_pooled():
        rc = lib.shx_raster_fast_pooled(*ptrs, samples.data_ptr(), samples.data_ptr(),
                                        pooled.data_ptr(), batch, num_faces, n // 2, n // 2,
                                        100.0, torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"raster_fast_pooled launch failed ({rc})")
        return pooled

    def run_exact():
        rc = lib.shx_raster_exact(*ptrs, samples.data_ptr(), samples.data_ptr(),
                                  exact.data_ptr(), batch, num_faces, n, n, 640.0, 640.0,
                                  torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"raster_exact launch failed ({rc})")
        return exact

    def run_raw():
        rc = lib.shx_raster_fast(*ptrs, samples.data_ptr(), samples.data_ptr(), exact.data_ptr(),
                                 counts.data_ptr(), lists.data_ptr(), batch, num_faces, n, n,
                                 torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"raster_fast launch failed ({rc})")
        return exact

    runs = {"raster_fast_pooled": run_pooled, "raster_exact": run_exact, "raster_fast": run_raw}
    return {k: runs[k] for k in kernels}


def timed(calls: dict, by_kernel: bool = False) -> dict:
    """Per call, ``event_ms`` and ``device_ms``; with ``by_kernel`` also the
    device ms a call of each device activity (``profile_piece``'s top)."""
    from spherehand_torch.profile_path import profile_piece
    from spherehand_torch.raster_sweep import median_ms

    out = {}
    for k, fn in calls.items():
        prof = profile_piece(fn)
        out[k] = {"event_ms": median_ms(fn), "device_ms": prof["device_ms"]}
        if by_kernel:
            out[k]["by_kernel"] = {name: ms for name, ms, _ in prof["top"]}
    return out


def mean_of_turns(rows) -> dict:
    return {k: {m: sum(r[k][m] for r in rows) / len(rows) for m in ("event_ms", "device_ms")}
            for k in rows[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None, help="another version of csrc/raster.cu")
    ap.add_argument("--raw", action="store_true",
                    help="the baseline's shx_raster_fast reads the planes: compare it too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("raster_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from spherehand_torch.data.sampler import sample_poses
    from spherehand_torch.data.synthesizer import draw_synthesis
    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.hand.kinematics import forward_kinematics
    from spherehand_torch.hand.skinning import apply_scale, project_faces_planes
    from spherehand_torch.render import contracts, raster_cuda
    from spherehand_torch.render.raster import bilinear_sample_positions

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}", flush=True)
    dev = torch.device("cuda")
    model = load_hand_model(device=dev)
    samples = torch.as_tensor(bilinear_sample_positions(64, 10), device=dev)
    canvas = torch.arange(CANVAS, dtype=torch.float32, device=dev)

    def hands(batch: int):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        draws = draw_synthesis(gen, batch)
        tr = apply_scale(forward_kinematics(model, sample_poses(gen, batch)), draws.scale_u, 0.1)
        return project_faces_planes(model, tr, 640.0, draws.rand_f)

    geometry = {f"B{b}": (hands(b), samples) for b in GRID_BATCHES}
    geometry[f"B{CANVAS_BATCH}_canvas{CANVAS}"] = (hands(CANVAS_BATCH), canvas)
    failed = False

    if args.baseline:
        libs = {"checkout": raster_cuda._library(), "baseline": bind_baseline(args.baseline)}
        kernels = {}
        for shape, (_, grid) in geometry.items():
            kernels[shape] = ([] if grid is canvas else ["raster_fast_pooled", "raster_exact"]) + (
                ["raster_fast"] if args.raw else [])
        grid_shapes = [k for k in geometry if kernels[k]]
        calls = {name: {shape: ztile_calls(lib, *geometry[shape], kernels[shape])
                        for shape in grid_shapes} for name, lib in libs.items()}
        agree = {}
        for shape in grid_shapes:
            for kernel in kernels[shape]:
                ours = calls["checkout"][shape][kernel]().clone()
                ref = calls["baseline"][shape][kernel]()
                torch.cuda.synchronize()
                agree[f"{kernel}_{shape}"] = contracts.same_bits(ours, ref)
        print(json.dumps({"builds_agree": agree}), flush=True)
        failed |= not all(agree.values())
        turns = {name: [] for name in libs}
        for name in ("baseline", "checkout", "checkout", "baseline"):
            row = {f"{k}_{shape}": v for shape in grid_shapes
                   for k, v in timed(calls[name][shape]).items()}
            turns[name].append(row)
            print(json.dumps({"build": name, **row}), flush=True)
        for name, rows in turns.items():
            print(json.dumps({"build": name, "mean_of_turns": mean_of_turns(rows)}), flush=True)

    variants = {"scan": False, "binned": True}
    agree, scratch = {}, {}
    for shape, (planes, grid) in geometry.items():
        outs = [raster_cuda._raster_fast(planes, grid, grid, b) for b in variants.values()]
        torch.cuda.synchronize()
        agree[shape] = contracts.same_bits(*outs)
        tiles_x, tiles_y = raster_cuda.ztiles(grid.numel(), grid.numel())
        slots = planes[0].shape[0] * tiles_x * tiles_y
        scratch[shape] = {"tiles_per_image": tiles_x * tiles_y,
                          "bytes": 4 * slots * (planes[0].shape[1] // 3 + 1)}
    print(json.dumps({"scan_binned_agree": agree, "binned_scratch": scratch}), flush=True)
    failed |= not all(agree.values())
    turns = {name: [] for name in variants}
    for name in ("scan", "binned", "binned", "scan"):
        calls = {f"raster_fast_{shape}": (lambda p=planes, g=grid, b=variants[name]:
                                          raster_cuda._raster_fast(p, g, g, b))
                 for shape, (planes, grid) in geometry.items()}
        row = timed(calls, by_kernel=True)
        turns[name].append(row)
        print(json.dumps({"variant": name, **row}), flush=True)
    for name, rows in turns.items():
        print(json.dumps({"variant": name, "mean_of_turns": mean_of_turns(rows)}), flush=True)
    print(smi)
    if failed:
        print("raster_ab: the builds or variants disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
