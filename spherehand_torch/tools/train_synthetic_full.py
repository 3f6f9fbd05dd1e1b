"""Synthetic pretraining: N synthetic steps at the StepLR thirds, then a
checkpoint, the flat params and the loss history.

Counterpart of the JAX package's ``tools/train_synthetic_full.py`` (and of
the trajectory printout of ``tools/train_synthetic_demo.py``): the
reference's synthetic-init stage (engine.py:265-316), with the step count,
batch, mesh and bf16 as arguments and the learning rate 1e-3 / 1e-4 / 1e-5
over thirds of the run (tier ``3 i // N``). Step ``i`` draws from a device
generator seeded ``i + 1`` (the JAX ``key(i + 1)``) and the network starts
from seed 0; ``seed`` s > 0 moves both (network seed s, step seeds
``s * 2**32 + i + 1``) for a second reading of the same run. The JAX tool
scans 100 steps a dispatch; here each step is one call of the same math.

Writes, under ``out``: ``model_final.pt`` (the engine's checkpoint format,
``infer.load_estimator`` serves it), ``synthetic_params.npz`` (flat flax
params, as ``assets/pretrained/``) and ``history.json`` ({step, loss,
synt_joint_err_mm, lr} every 1000 steps and at the last).

With a resume directory (``--resume DIR``) the run can be stopped anywhere
and carried on by the same command: every 2,500 steps it writes
``DIR/resume.pt`` (the network, Adam's state, the step, and the losses,
errors, history, seconds and launches so far) and ``DIR/resume.json`` (the
run's settings and the step the checkpoint holds). The state announces a
step before its checkpoint is written and records it after, so a stop
between the two resumes from the checkpoint. The draws and the learning
rate are functions of the step, so under the deterministic settings a
resumed run ends with the straight run's bits.

The command line runs with deterministic algorithms (``utils.determinism``).

Usage: python -m spherehand_torch.tools.train_synthetic_full [steps=75000] [batch=48]
       [out=runs/synthetic_full] [--mesh lite] [--bf16] [--resume DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from spherehand_torch.convert import flax_params
from spherehand_torch.device import resolve_device
from spherehand_torch.hand.assets import load_hand_model
from spherehand_torch.tools import add_counts, launch_counts, launches_since
from spherehand_torch.train.config import EngineConfig
from spherehand_torch.train.engine import load_optimizer_state, save_state
from spherehand_torch.train.priors import save_flax_params_npz
from spherehand_torch.train.steps import TrainState, build_steps
from spherehand_torch.utils import determinism

LEARNING_RATES = (1e-3, 1e-4, 1e-5)  # StepLR x0.1 at a third and two thirds
LOG_EVERY = 1000
SAVE_EVERY = 2500  # steps between resume checkpoints (about two minutes on an H100)


class SyntheticRun(NamedTuple):
    state: TrainState
    history: list[dict]   # the logged records
    losses: np.ndarray    # (N,) every step's loss
    errors: np.ndarray    # (N,) every step's synthetic joint error, mm
    seconds: float        # the steps' wall time, synchronised, over every call
    launches: dict        # the kernels the steps launched, over every call


def learning_rate(step: int, num_steps: int) -> float:
    return LEARNING_RATES[3 * step // num_steps]


def _write_json(path: str, obj: dict) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(path + ".tmp", path)


def _resume(resume_dir: str, settings: dict, state: TrainState, dev) -> dict | None:
    """The saved progress of the run in ``resume_dir``, its checkpoint
    loaded into ``state``; None to start at step 0."""
    state_file = os.path.join(resume_dir, "resume.json")
    ckpt_file = os.path.join(resume_dir, "resume.pt")
    if not os.path.exists(state_file):
        return None
    with open(state_file) as f:
        rstate = json.load(f)
    if rstate["settings"] != settings:
        raise RuntimeError(f"{state_file} ran other settings: {rstate['settings']}, "
                           f"not {settings}")
    if not os.path.exists(ckpt_file):
        if rstate["step"]:
            raise RuntimeError(f"{state_file} holds step {rstate['step']}, but {ckpt_file} "
                               "is missing")
        return None  # stopped before its first checkpoint
    ckpt = torch.load(ckpt_file, map_location=dev, weights_only=True)
    if ckpt["step"] not in (rstate["step"], rstate["pending"]):
        raise RuntimeError(f"{ckpt_file} holds step {ckpt['step']}, but {state_file} "
                           f"resumes at {rstate['step']}")
    state.network.load_state_dict(ckpt["network"])
    load_optimizer_state(state.optimizer, ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return ckpt


def train_synthetic(num_steps: int, batch: int = 48, mesh: str = "full", bf16: bool = False,
                    device: torch.device | str | None = None,
                    log_every: int = LOG_EVERY, seed: int = 0,
                    resume_dir: str | None = None) -> SyntheticRun:
    """``num_steps`` synthetic steps at ``batch`` on ``mesh`` ("full" or
    "lite"), bfloat16 convolutions under ``bf16``, from ``seed``.

    ``resume_dir``: carry the run on from its checkpoint there, if any, and
    write one every ``SAVE_EVERY`` steps."""
    dev = resolve_device(device)
    cfg = EngineConfig(synt_batch=batch, num_stacks=1, mesh=mesh, bf16=bf16)
    steps = build_steps(cfg, load_hand_model(device=dev, lite=mesh == "lite"))
    state = steps.init_state(torch.Generator().manual_seed(seed))
    settings = {"steps": num_steps, "batch": batch, "mesh": mesh, "bf16": bf16, "seed": seed}
    saved = None
    if resume_dir is not None:
        os.makedirs(resume_dir, exist_ok=True)
        saved = _resume(resume_dir, settings, state, dev)
    if saved is None:
        saved = {"step": 0, "losses": torch.zeros(0), "errors": torch.zeros(0), "history": [],
                 "seconds": 0.0, "launches": {}}
    else:
        print(f"resumed at step {saved['step']} from {resume_dir}", flush=True)
    trace = [saved["losses"].cpu()], [saved["errors"].cpu()]  # the steps before, on the host
    history = list(saved["history"])
    gen = torch.Generator(device=dev)
    losses, errors = [], []
    before = launch_counts()
    t0 = time.perf_counter()

    def flush() -> tuple[float, dict]:
        """The trace so far onto the host; (seconds, launches) over every call."""
        for done, new in zip(trace, (losses, errors)):
            if new:
                done.append(torch.stack(new).cpu())
                new.clear()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return (saved["seconds"] + time.perf_counter() - t0,
                add_counts(saved["launches"], launches_since(before)))

    def checkpoint(step: int) -> None:
        """The state announces ``step``, then its checkpoint is written, then
        the state records it."""
        seconds, launches = flush()
        state_file = os.path.join(resume_dir, "resume.json")
        ckpt_file = os.path.join(resume_dir, "resume.pt")
        rstate = {"settings": settings, "step": saved["step"], "pending": step}
        _write_json(state_file, rstate)
        torch.save({"network": state.network.state_dict(),
                    "optimizer": state.optimizer.state_dict(), "step": step,
                    "losses": torch.cat(trace[0]), "errors": torch.cat(trace[1]),
                    "history": history, "seconds": seconds, "launches": launches},
                   ckpt_file + ".tmp")
        os.replace(ckpt_file + ".tmp", ckpt_file)
        saved["step"] = step
        _write_json(state_file, {**rstate, "step": step, "pending": None})

    for i in range(saved["step"], num_steps):
        lr = learning_rate(i, num_steps)
        draws = steps.draw(gen.manual_seed((seed << 32) + i + 1), real=False)
        state, metrics = steps.synt_step(state, lr, draws)
        losses.append(metrics["loss"])
        errors.append(metrics["synt_joint_err"])
        if i % log_every == 0 or i == num_steps - 1:
            rec = {"step": i, "loss": float(metrics["loss"]),
                   "synt_joint_err_mm": float(metrics["synt_joint_err"]), "lr": lr}
            history.append(rec)
            print(f"step {i:6d}: loss {rec['loss']:10.2f}  err {rec['synt_joint_err_mm']:6.2f} mm"
                  f"  lr {lr:.1e}", flush=True)
        if resume_dir is not None and (i + 1) % SAVE_EVERY == 0:
            checkpoint(i + 1)
    seconds, launches = flush()
    return SyntheticRun(state, history, torch.cat(trace[0]).numpy(),
                        torch.cat(trace[1]).numpy(), seconds, launches)


def save_run(out_dir: str, run: SyntheticRun) -> dict[str, str]:
    """The run's checkpoint, flat params and history under ``out_dir``;
    returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {name: os.path.join(out_dir, name)
             for name in ("model_final.pt", "synthetic_params.npz", "history.json")}
    save_state(paths["model_final.pt"], run.state, epoch=0)
    save_flax_params_npz(paths["synthetic_params.npz"], flax_params(run.state.network))
    with open(paths["history.json"], "w") as f:
        json.dump(run.history, f, indent=1)
    return paths


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=75_000)
    ap.add_argument("batch", nargs="?", type=int, default=48)
    ap.add_argument("out", nargs="?", default=os.path.join("runs", "synthetic_full"))
    ap.add_argument("--mesh", default="full", choices=["full", "lite"])
    ap.add_argument("--bf16", action="store_true", help="bfloat16 convolutions")
    ap.add_argument("--resume", metavar="DIR",
                    help=f"checkpoint into DIR every {SAVE_EVERY} steps, and resume from it")
    ap.add_argument("--device", default="cuda", help="torch device (cpu: the plain path)")
    args = ap.parse_args(argv)
    determinism.enable()
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}, {args.steps} steps @ batch {args.batch}, mesh {args.mesh}, "
          f"bf16={args.bf16}")
    run = train_synthetic(args.steps, args.batch, args.mesh, args.bf16, dev,
                          resume_dir=args.resume)
    print(f"{args.steps} steps in {run.seconds:.1f}s ({args.steps / run.seconds:.2f} steps/s)")
    print(f"synthetic joint error: {run.errors[0]:.2f} -> {run.errors[-1]:.2f} mm")
    for path in save_run(args.out, run).values():
        print("wrote", path)


if __name__ == "__main__":
    main()
