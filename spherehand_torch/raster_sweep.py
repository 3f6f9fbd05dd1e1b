"""Tile and block sizes of the z-tile rasterizers, measured on one GPU.

``raster_fast_pooled`` and ``raster_exact`` (``csrc/raster.cu``) fix two
sizes at compile time: ``kZTile``, the samples a side of a block's z-tile,
and ``kZThreads``, the threads of a block (``kPerThread`` follows, so that a
scan round still covers ``kChunk`` = 1,024 faces). This script builds one
library per pair of sizes from the checkout's source, with the build's own
flags, and for each batch prints one JSON line:

- ``ms``: per variant, [fast, exact] CUDA-event medians of 20 single
  launches, each synchronised, as ``chip_smoke.py`` times them;
- ``sustained_ms``: [fast, exact] over 200 launches back to back;
- ``same_bits``: whether every variant's canvases equal the shipped
  sizes' bit for bit;
- ``tile_spread``: per tile size, the mean and largest count of faces whose
  box meets a tile and of box samples in a tile (from the plain pre-pass's
  boxes), the load of a launch's slowest block against its mean.

Hands: sampler poses with synthesis draws, seed 3, on the 128 x 128 sample
grid of ``render_depth_64``. Batches: 25 (a view of the real batch), 48
(the synthetic batch), 128 (serving) and 1024.

Usage: python -m spherehand_torch.raster_sweep

Needs a CUDA device and nvcc; exits non-zero without a device.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

BATCHES = (25, 48, 128, 1024)
TILES = (32, 64)
THREADS = (256, 512, 1024)
CHUNK = 1024  # faces a scan round covers, kPerThread * kZThreads
SEED = 3
REPS = 20
SUSTAINED = 200


def variant_source(source: str, tile: int, threads: int) -> str:
    """``csrc/raster.cu`` with kZTile, kZThreads and kPerThread replaced."""
    out = source
    for name, value in (("kZTile", tile), ("kZThreads", threads), ("kPerThread", CHUNK // threads)):
        lines = [ln for ln in out.splitlines() if ln.startswith(f"constexpr int {name} = ")]
        if len(lines) != 1:
            raise ValueError(f"csrc/raster.cu: expected one definition of {name}")
        _, _, tail = lines[0].partition(";")
        out = out.replace(lines[0], f"constexpr int {name} = {value};{tail}")
    return out


def shipped_sizes(source: str) -> tuple[int, int]:
    """(kZTile, kZThreads) as the source defines them."""
    sizes = {}
    for ln in source.splitlines():
        for name in ("kZTile", "kZThreads"):
            if ln.startswith(f"constexpr int {name} = "):
                sizes[name] = int(ln.split("=")[1].split(";")[0])
    return sizes["kZTile"], sizes["kZThreads"]


def build_variants(source: str, out_dir: str) -> dict:
    """One nvcc per (tile, threads), all started together; {key: library}."""
    from spherehand_torch import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for tile in TILES:
        for threads in THREADS:
            key = f"tile{tile}_t{threads}"
            src = os.path.join(out_dir, f"{key}.cu")
            with open(src, "w") as fh:
                fh.write(variant_source(source, tile, threads))
            lib = os.path.join(out_dir, f"{key}.so")
            procs[key] = (subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, src],
                                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        _, log = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {key} failed:\n{log}")
        handle = ctypes.CDLL(lib)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        handle.shx_raster_fast_pooled.argtypes = [ptr] * 6 + [i32] * 4 + [f32, ptr]
        handle.shx_raster_exact.argtypes = [ptr] * 6 + [i32] * 4 + [f32, f32, ptr]
        libs[key] = handle
    return libs


def median_ms(fn, reps: int = REPS) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def sustained_ms(fn, reps: int = SUSTAINED) -> float:
    for _ in range(20):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def tile_spread(box: torch.Tensor, samples: torch.Tensor, tile: int) -> dict:
    """Faces whose box meets a tile, and box samples in a tile: mean and max
    over the batch's tiles."""
    faces, tests = [], []
    for i0 in range(0, samples.numel(), tile):
        for j0 in range(0, samples.numel(), tile):
            sx, sy = samples[i0:i0 + tile].contiguous(), samples[j0:j0 + tile].contiguous()
            hit = ((box[..., 1] >= sx[0]) & (box[..., 0] <= sx[-1])
                   & (box[..., 3] >= sy[0]) & (box[..., 2] <= sy[-1]))
            nx = (torch.searchsorted(sx, box[..., 1].contiguous(), right=True)
                  - torch.searchsorted(sx, box[..., 0].contiguous())).clamp(min=0)
            ny = (torch.searchsorted(sy, box[..., 3].contiguous(), right=True)
                  - torch.searchsorted(sy, box[..., 2].contiguous())).clamp(min=0)
            faces.append(hit.sum(1))
            tests.append((nx * ny * hit).sum(1))
    faces, tests = torch.stack(faces).float(), torch.stack(tests).float()
    return {"faces_mean": float(faces.mean()), "faces_max": float(faces.max()),
            "samples_mean": float(tests.mean()), "samples_max": float(tests.max())}


def main() -> int:
    if not torch.cuda.is_available():
        print("raster_sweep: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from spherehand_torch import cuda_build
    from spherehand_torch.data.sampler import sample_poses
    from spherehand_torch.data.synthesizer import draw_synthesis
    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.hand.kinematics import forward_kinematics
    from spherehand_torch.hand.skinning import apply_scale, project_faces_planes
    from spherehand_torch.render import raster_cuda
    from spherehand_torch.render.raster import bilinear_sample_positions

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}", flush=True)
    with open(os.path.join(cuda_build.CSRC_DIR, "raster.cu")) as fh:
        source = fh.read()
    libs = build_variants(source, os.path.join(cuda_build.BUILD_DIR, "sweep"))
    shipped = "tile{}_t{}".format(*shipped_sizes(source))

    dev = torch.device("cuda")
    model = load_hand_model(device=dev)
    samples = torch.as_tensor(bilinear_sample_positions(64, 10), device=dev)
    n = samples.numel()
    for batch in BATCHES:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        poses = sample_poses(gen, batch)
        draws = draw_synthesis(gen, batch)
        tr = apply_scale(forward_kinematics(model, poses), draws.scale_u, 0.1)
        planes = project_faces_planes(model, tr, 640.0, draws.rand_f)
        ptrs = [p.data_ptr() for p in planes]
        num_faces = planes[0].shape[1] // 3
        stream = torch.cuda.current_stream(dev).cuda_stream
        ms, sustained, outs = {}, {}, {}
        for key, lib in libs.items():
            fast = torch.empty((batch, n // 2, n // 2), device=dev)
            exact = torch.empty((batch, n, n), device=dev)

            def run_fast(lib=lib, out=fast):
                lib.shx_raster_fast_pooled(*ptrs, samples.data_ptr(), samples.data_ptr(),
                                           out.data_ptr(), batch, num_faces, n // 2, n // 2,
                                           100.0, stream)

            def run_exact(lib=lib, out=exact):
                lib.shx_raster_exact(*ptrs, samples.data_ptr(), samples.data_ptr(),
                                     out.data_ptr(), batch, num_faces, n, n, 640.0, 640.0, stream)

            ms[key] = [median_ms(run_fast), median_ms(run_exact)]
            sustained[key] = [sustained_ms(run_fast), sustained_ms(run_exact)]
            torch.cuda.synchronize()
            outs[key] = (fast.view(torch.int32), exact.view(torch.int32))
        same = {key: all(torch.equal(a, b) for a, b in zip(o, outs[shipped]))
                for key, o in outs.items()}
        _, box = raster_cuda.prepass_fast(planes=planes)
        spread = {tile: tile_spread(box, samples, tile) for tile in TILES}
        print(json.dumps({"batch": batch, "shipped": shipped, "ms": ms, "sustained_ms": sustained,
                          "same_bits": same, "tile_spread": spread}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
