"""The sphere kernels of the checkout against another build of ``csrc/sphere.cu``, on one GPU.

Builds the source given by ``--baseline`` (another version of
``csrc/sphere.cu`` with the same C interface) with the build's own flags
beside the checkout's, and runs both through the same wrappers
(``render/sphere_cuda.launch_fields`` / ``launch_fields_bwd``, and the train
steps) on the same inputs: the projected sphere centres of a pseudo-real
batch of 25 hands x 3 views against its depth maps, N = 225, J = 41, S = 64,
the inputs of ``chip_smoke.py`` phases 6, 9 and 10. The two run in turns
(baseline, checkout, checkout, baseline) and each turn prints one JSON line:

- ``event_ms``: per kernel, the CUDA-event median of 20 single launches,
  each synchronised, as ``chip_smoke.py`` times them;
- ``device_ms``: per kernel, device ms a launch by torch.profiler
  (``profile_path.profile_piece``);
- ``step_ms``: CUDA-event medians of ``synt_step``, ``combined_step`` and
  ``eval_step`` at the ``EngineConfig`` defaults, draws included.

Before the turns it holds the two builds against each other: every forward
plane equal bit for bit, the backward within 1e-5 of the largest entry.
The last lines are the per-kernel means of each build's two turns and the
card's name and power limit.

Usage: python -m spherehand_torch.sphere_ab --baseline path/to/sphere.cu

Needs a CUDA device and nvcc; exits non-zero without a device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

STEP_REPS = 10
SEED = 4
BWD_REL = 1e-5
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(_ROOT, "assets", "pretrained", "synthetic_params.npz")


def build_baseline(source: str) -> str:
    """nvcc ``source`` with the build's flags into ``build/``; the library path."""
    from spherehand_torch import cuda_build

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(cuda_build.BUILD_DIR, "libshx_sphere_baseline.so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {source} failed:\n{proc.stderr}")
    return out


def kernel_calls(sc, centers, target, radii, size: int, views: int) -> dict:
    """{kernel name: call} for the nine kernels, on the inputs each takes in
    the port (the distance field alone reads the gathered targets)."""
    gathered = sc.gathered_target(target, centers.shape[0], views).contiguous()
    inputs = {sc.BOTH: (target, views), sc.DEPTH: (None, 1), sc.DIST: (gathered, 1)}
    calls = {}
    for fields, (tgt, v) in inputs.items():
        args = (fields, centers, tgt, radii, size, v)
        planes = sc.launch_fields(*args, residuals=True)
        k = sc.num_fields(fields)
        gen = torch.Generator(device=centers.device).manual_seed(fields)
        grads = [torch.rand(p.shape, generator=gen, device=centers.device) * 2.0 - 1.0
                 for p in planes[:k]]
        bwd = (fields, centers, tgt, v, grads, planes[k:])
        prefix = sc.LAUNCH_PREFIX[fields]
        calls[f"{prefix}_fwd"] = lambda a=args: sc.launch_fields(*a, residuals=True)
        calls[f"{prefix}_primal"] = lambda a=args: sc.launch_fields(*a, residuals=False)
        calls[f"{prefix}_bwd"] = lambda b=bwd: sc.launch_fields_bwd(*b)
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, help="another version of csrc/sphere.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sphere_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from spherehand_torch.convert import train_state_from_params
    from spherehand_torch.data.pseudo_real import render_multiview_batch, sphere_inputs
    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.infer import load_params_npz
    from spherehand_torch.profile_path import profile_piece
    from spherehand_torch.raster_sweep import median_ms
    from spherehand_torch.render import contracts
    from spherehand_torch.render import sphere_cuda as sc
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.steps import RealBatch, build_steps

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}", flush=True)
    libs = {"checkout": sc._library(), "baseline": sc.bind(build_baseline(args.baseline))}

    dev = torch.device("cuda")
    model = load_hand_model(device=dev)
    cfg = EngineConfig()
    real = render_multiview_batch(model, torch.Generator(device=dev).manual_seed(SEED),
                                  cfg.real_batch)
    centers, target, radii, views = sphere_inputs(model, real)
    size = target.shape[-1]
    fns = build_steps(cfg, hand=model)
    state = train_state_from_params(fns.init_state, load_params_npz(PARAMS))
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    batch = RealBatch(*real[:4])
    steps = {
        "synt_step": lambda: fns.synt_step(state, cfg.lr, fns.draw(gen, real=False)),
        "combined_step": lambda: fns.combined_step(state, cfg.lr, fns.draw(gen), batch, True),
        "eval_step": lambda: fns.eval_step(state, fns.draw(gen, synt=False), batch),
    }

    # Both builds run through the same wrappers and train steps.
    outs = {}
    for name, lib in libs.items():
        with sc.use_library(lib):
            calls = kernel_calls(sc, centers, target, radii, size, views)
            outs[name] = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    agree = {}
    for k, ref in outs["baseline"].items():
        ours = outs["checkout"][k]
        if k.endswith("_bwd"):
            agree[k] = float((ours - ref).abs().max() / ref.abs().max()) <= BWD_REL
        else:
            agree[k] = all(contracts.same_bits(a, b) for a, b in zip(ours, ref))
    print(json.dumps({"N": centers.shape[0], "J": centers.shape[1], "S": size,
                      "builds_agree": agree}), flush=True)
    if not all(agree.values()):
        print("sphere_ab: the two builds disagree", file=sys.stderr)
        return 1

    turns = {name: [] for name in libs}
    for name in ("baseline", "checkout", "checkout", "baseline"):
        with sc.use_library(libs[name]):
            calls = kernel_calls(sc, centers, target, radii, size, views)
            row = {"build": name,
                   "event_ms": {k: median_ms(fn) for k, fn in calls.items()},
                   "device_ms": {k: profile_piece(fn)["device_ms"] for k, fn in calls.items()},
                   "step_ms": {k: median_ms(fn, STEP_REPS) for k, fn in steps.items()}}
        turns[name].append(row)
        print(json.dumps(row), flush=True)
    for name, rows in turns.items():
        mean = {metric: {k: sum(r[metric][k] for r in rows) / len(rows) for k in rows[0][metric]}
                for metric in ("event_ms", "device_ms", "step_ms")}
        print(json.dumps({"build": name, "mean_of_turns": mean}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
