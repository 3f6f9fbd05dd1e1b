"""Headline benchmark of the port on one card: one JSON line with the keys
of the JAX package's ``bench.py``.

- ``value``: frames/sec of the synthesis render path the training loop uses
  (sampler -> FK -> ``render_depth_64``: LBS, projection, the
  ``raster_fast_pooled`` kernel, 64 x 64 depth), full mesh, fast mode, B =
  1024; ``vs_baseline`` against 50,000 frames/sec; ``full_exact_fps``,
  ``lite_fps`` and ``lite_exact_fps`` the other meshes and modes;
- ``train_combined_steps_per_sec`` (and ``_bf16_``): the combined
  self-supervised step at the reference geometry (48 synthetic + 25 x 3
  real, one stack, draws included) on a fixed real batch;
- ``train_epoch_steps_per_sec`` (and ``_bf16_``): the engine's combined
  steps over NYU-format shards of rendered hands it writes to a temporary
  directory, ``device_data`` on (the index plan, the resident gather, the
  draws and the step);
- ``health_dispatch_rtt_ms`` (host ms of a tiny kernel and a synchronise)
  and ``health_device_get_mbps`` (a 4 MB card-to-host copy);
- ``gpu_name`` and ``gpu_power_limit`` (``nvidia-smi``).

Timing: CUDA events around windows of calls after a warm-up, the best of
``WINDOWS`` windows, as ``bench.py`` takes the best of 3 dispatches. Loop
lengths: renders ``RENDER_ITERS`` a window, train steps ``TRAIN_ITERS``,
engine steps ``EPOCH_STEPS`` (one window, after ``EPOCH_WARMUP``). A
failure of any part exits non-zero: nothing is printed as ``None``.

Usage: python -m spherehand_torch.bench
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TARGET_FPS = 50_000.0
BATCH = 1024
WINDOWS = 3
WARMUP = 3
RENDER_ITERS = 20
TRAIN_ITERS = 20
EPOCH_SAMPLES = 400  # train split of rendered hands, two shards
EPOCH_TEST_SAMPLES = 8
EPOCH_WARMUP = 5
EPOCH_STEPS = 60


def _timed(fn, iters: int, device: torch.device) -> float:
    """Seconds per call of ``fn``: CUDA events around ``iters`` calls on
    the card, the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def best_rate(fn, iters: int, device: torch.device, windows: int = WINDOWS,
              warmup: int = WARMUP) -> float:
    """Calls per second of ``fn``: the best of ``windows`` windows of
    ``iters`` calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return max(1.0 / _timed(fn, iters, device) for _ in range(windows))


def render_fps(model, batch: int, exact: bool, device: torch.device,
               iters: int = RENDER_ITERS, windows: int = WINDOWS, warmup: int = WARMUP) -> float:
    """Frames/sec of sampler -> FK -> ``render_depth_64`` at ``batch``."""
    from spherehand_torch.data.sampler import sample_poses
    from spherehand_torch.hand.kinematics import forward_kinematics
    from spherehand_torch.render.raster import render_depth_64

    gen = torch.Generator(device=device).manual_seed(0)
    acc = torch.zeros((), device=device)

    def one():
        nonlocal acc
        transforms = forward_kinematics(model, sample_poses(gen, batch))
        rand_f = torch.rand((batch,), generator=gen, device=device) * 0.2 + 0.9
        acc = acc + render_depth_64(model, transforms, rand_f, exact=exact).mean()

    rate = batch * best_rate(one, iters, device, windows, warmup)
    if not bool(torch.isfinite(acc)):
        raise RuntimeError("render produced non-finite depth")
    return rate


def combined_steps_per_sec(device: torch.device, bf16: bool = False, synt_batch: int = 48,
                           real_batch: int = 25, iters: int = TRAIN_ITERS,
                           windows: int = WINDOWS, warmup: int = WARMUP) -> float:
    """Combined steps/sec at ``synt_batch`` + ``real_batch`` x 3 (the
    reference geometry by default), draws included, on a fixed real batch
    (``parallel.check.real_batch``)."""
    from spherehand_torch.parallel.check import real_batch as fake_real_batch
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.steps import build_steps

    cfg = EngineConfig(synt_batch=synt_batch, real_batch=real_batch, num_stacks=1, bf16=bf16)
    fns = build_steps(cfg, device=device)
    state = fns.init_state(torch.Generator().manual_seed(0))
    batch = fake_real_batch(device, real_batch, 1)
    gen = torch.Generator(device=device).manual_seed(1)
    losses = []

    def one():
        nonlocal state
        state, metrics, _ = fns.combined_step(state, 1e-4, fns.draw(gen), batch, True)
        losses.append(metrics["loss"])

    rate = best_rate(one, iters, device, windows, warmup)
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise RuntimeError("combined step produced a non-finite loss")
    return rate


def write_rendered_shards(root: str, device: torch.device, train: int = EPOCH_SAMPLES,
                          test: int = EPOCH_TEST_SAMPLES, seed: int = 0,
                          lite: bool = False) -> str:
    """NYU-format shards of rendered multi-view hands (the full mesh, or
    the lite one) under ``root``: a train split of two shards and a test
    split; returns ``root``."""
    from spherehand_torch.data.nyu import write_shard
    from spherehand_torch.data.pseudo_real import render_multiview_batch
    from spherehand_torch.hand.assets import load_hand_model

    model = load_hand_model(device=device, lite=lite)
    gen = torch.Generator(device=device).manual_seed(seed)
    for subset, sizes in (("train", (train // 2, train - train // 2)), ("test", (test,))):
        os.makedirs(os.path.join(root, subset), exist_ok=True)
        for i, n in enumerate(sizes):
            real = render_multiview_batch(model, gen, n)
            write_shard(os.path.join(root, subset), f"mv_data_{i}",
                        *(x.cpu().numpy() for x in (real.dms, real.gt_joints, real.poses)))
    return root


def epoch_steps_per_sec(data_dir: str, model_dir: str, device: torch.device,
                        bf16: bool = False, steps: int = EPOCH_STEPS,
                        warmup: int = EPOCH_WARMUP, **fields) -> float:
    """The engine's combined steps/sec over the shards in ``data_dir``
    (``device_data`` on): epoch after epoch of ``Engine.batches`` and
    ``Engine.combined_step``, timed over ``steps`` steps after ``warmup``."""
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.engine import Engine

    cfg = EngineConfig(**{"mode": "Train", "dataset_dir": data_dir, "model_dir": model_dir,
                          "device_data": "on", "bf16": bf16, "tag": "bench_", **fields})
    engine = Engine(cfg, device=device)

    def feed():
        epoch = 0
        while True:
            for it, (_, batch) in enumerate(engine.batches(True, cfg.real_batch, epoch)):
                yield epoch, it, batch
            epoch += 1

    stream = feed()
    losses = []

    def one():
        epoch, it, batch = next(stream)
        metrics, _ = engine.combined_step(epoch, it, batch)
        losses.append(metrics["loss"])

    rate = best_rate(one, steps, device, windows=1, warmup=warmup)
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise RuntimeError("engine step produced a non-finite loss")
    return rate


def dispatch_health(device: torch.device) -> dict:
    """Host ms of a tiny kernel launch and synchronise (median of 20, after
    10) and the MB/s of a 4 MB card-to-host copy."""
    x = torch.ones((8, 128), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(10):
        (x * 1.0001 + 1.0).sum()
    sync()
    rtts = []
    for _ in range(20):
        t0 = time.perf_counter()
        x * 1.0001 + 1.0
        sync()
        rtts.append((time.perf_counter() - t0) * 1e3)
    big = torch.ones((1024 * 1024,), device=device)
    big.cpu()
    sync()
    t0 = time.perf_counter()
    big.cpu()
    mbps = 4.0 / max(time.perf_counter() - t0, 1e-9)
    return {"health_dispatch_rtt_ms": float(np.median(rtts)), "health_device_get_mbps": mbps}


def gpu_identity() -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (part.strip() for part in out.rsplit(",", 1))
    return {"gpu_name": name, "gpu_power_limit": limit}


def measure(device: torch.device) -> dict:
    """Every number of the line but the card's identity, on ``device``."""
    from spherehand_torch.hand.assets import load_hand_model

    record = dispatch_health(device)
    fps = {}
    for lite in (False, True):
        model = load_hand_model(device=device, lite=lite)
        for exact in (False, True):
            fps[(lite, exact)] = render_fps(model, BATCH, exact, device)
    train = {bf16: combined_steps_per_sec(device, bf16) for bf16 in (False, True)}
    tmp = tempfile.mkdtemp(prefix="spherehand_bench_")
    try:
        data = write_rendered_shards(os.path.join(tmp, "nyu"), device)
        epoch = {bf16: epoch_steps_per_sec(data, os.path.join(tmp, "runs"), device, bf16)
                 for bf16 in (False, True)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "metric": "depth_render_throughput",
        "value": fps[(False, False)],
        "unit": "frames/sec",
        "vs_baseline": fps[(False, False)] / TARGET_FPS,
        "mesh": "full-3382",
        "full_exact_fps": fps[(False, True)],
        "lite_fps": fps[(True, False)],
        "lite_exact_fps": fps[(True, True)],
        "train_combined_steps_per_sec": train[False],
        "train_combined_bf16_steps_per_sec": train[True],
        "train_epoch_steps_per_sec": epoch[False],
        "train_epoch_bf16_steps_per_sec": epoch[True],
        "batch": BATCH,
        **record,
    }


def main(argv: list[str] | None = None) -> int:
    import argparse

    from spherehand_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    device = resolve_device(None)
    with contextlib.redirect_stdout(sys.stderr):  # the engine's log lines
        record = measure(device)
    bad = [k for k, v in record.items() if isinstance(v, float) and not np.isfinite(v)]
    if bad:
        raise RuntimeError(f"non-finite numbers: {bad}")
    print(json.dumps({**record, **gpu_identity()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
