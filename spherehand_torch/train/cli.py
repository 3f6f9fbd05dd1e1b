"""CLI: the JAX package's flags (``spherehand_tpu/train/cli.py``), with the
same names and defaults, plus ``--device``.

As in the reference (``network/run_engine.py:9-31``), the loss toggles are
default-on ``store_false`` flags: passing ``--synthesize`` DISABLES
synthesis.

Data parallelism, as the JAX engine takes every device: on a host with N > 1
cards the CLI starts one rank per card under ``torch.distributed.run``
(NCCL), each running this CLI; ``--no_data_parallel`` trains on one card.
Launched by ``torchrun`` (``WORLD_SIZE`` set), it joins the launcher's group
instead (gloo where ranks share a card). The decision is
``parallel.mesh.rank_plan``'s.

Usage:
    python -m spherehand_torch --mode Train --model_dir runs \\
        --dataset_dir data/nyu/npy-64
    torchrun --nproc_per_node 4 -m spherehand_torch --mode Train ...
    python -m spherehand_torch --mode Test --initial_model runs/<run>/model_74.pt \\
        --dataset_dir data/nyu/npy-64
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

from spherehand_torch.parallel.mesh import RankGroup, join_launcher, leave_group, rank_plan
from spherehand_torch.train.config import EngineConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # Loss toggles (reference run_engine.py:10-16).
    p.add_argument("--synthesize", default=True, action="store_false")
    p.add_argument("--mv_projection", default=True, action="store_false")
    p.add_argument("--mv_consistency", default=True, action="store_false")
    p.add_argument("--temporal", default=False, action="store_true")
    p.add_argument("--collision", default=True, action="store_false")
    p.add_argument("--bone_length", default=True, action="store_false")
    p.add_argument("--prior", default=True, action="store_false")
    # Run control (run_engine.py:17-30).
    p.add_argument("--mode", default="Test", type=str, choices=["Train", "Test"])
    p.add_argument("--model_dir", default="runs", type=str)
    p.add_argument("--initial_model", type=str,
                   help="a checkpoint file (model_<epoch>.pt): weights only")
    p.add_argument("--restore_from_model", type=str,
                   help="a run name under --model_dir: full resume")
    p.add_argument("--restore_from_epoch", default=-1, type=int,
                   help="the checkpoint to resume from (-1: the latest); training "
                        "goes on at the epoch after the one it holds")
    p.add_argument("--num_stacks", default=1, type=int)
    p.add_argument("--epoch", default=75, type=int)
    p.add_argument("--dataset_dir", default="data/nyu/npy-64", type=str)
    p.add_argument("--depth_resample", default=0, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--tag", default="", type=str)
    # Batch geometry and the rest of the JAX package's extras.
    p.add_argument("--real_batch", default=25, type=int)
    p.add_argument("--synt_batch", default=48, type=int)
    p.add_argument("--eval_batch", default=8, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--no_data_parallel", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv compute (parameters, heads and losses float32)")
    p.add_argument("--mesh", default="full", choices=["full", "lite"],
                   help="hand mesh for synthetic renders (lite: 1,700 faces)")
    p.add_argument("--steps_per_call", default=1, type=int,
                   help="combined-epoch steps a call (runs as plain steps; same math as 1)")
    p.add_argument("--device_data", default="auto", choices=["auto", "on", "off"],
                   help="hold the real splits on the device and gather batches "
                        "there (auto: when the split fits)")
    p.add_argument("--eval_precision", default="default", choices=["default", "highest"],
                   help="'highest' switches TF32 off in the eval step "
                        "(batch-invariant, parity-grade metrics)")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device (cuda by default; cpu runs the plain versions)")
    return p


def config_from_args(args: argparse.Namespace) -> EngineConfig:
    return EngineConfig(
        synthesize=args.synthesize,
        mv_projection=args.mv_projection,
        mv_consistency=args.mv_consistency,
        temporal=args.temporal,
        collision=args.collision,
        bone_length=args.bone_length,
        prior=args.prior,
        mode=args.mode,
        model_dir=args.model_dir,
        initial_model=args.initial_model,
        restore_from_model=args.restore_from_model,
        restore_from_epoch=args.restore_from_epoch,
        num_stacks=args.num_stacks,
        epoch=args.epoch,
        dataset_dir=args.dataset_dir,
        depth_resample=args.depth_resample,
        lr=args.lr,
        tag=args.tag,
        real_batch=args.real_batch,
        synt_batch=args.synt_batch,
        eval_batch=args.eval_batch,
        seed=args.seed,
        data_parallel=not args.no_data_parallel,
        bf16=args.bf16,
        mesh=args.mesh,
        steps_per_call=args.steps_per_call,
        device_data=args.device_data,
        eval_precision=args.eval_precision,
    )


def run(cfg: EngineConfig, device: torch.device, group: RankGroup | None = None):
    """Train or evaluate ``cfg`` (its ``mode``) on ``device``, or as one
    rank of ``group``; returns the engine."""
    from spherehand_torch.train.engine import Engine

    engine = Engine(cfg, device=device, group=group)
    if cfg.mode == "Train":
        engine.train()
    else:
        engine.eval()
    return engine


def spawn(argv: list[str], world: int) -> int:
    """Run this CLI as ``world`` ranks, one per card, under
    ``torch.distributed.run`` on this host; its exit code."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={world}", "-m", "spherehand_torch", *argv]
    return subprocess.run(cmd, check=False).returncode


def main(argv: list[str] | None = None):
    """The CLI; returns the engine that ran in this process (a spawning
    parent exits with its ranks' code instead)."""
    from spherehand_torch.device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.mode == "Test" and args.initial_model is None and args.restore_from_model is None:
        raise SystemExit("Test mode requires --initial_model or --restore_from_model")
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    count = torch.cuda.device_count() if device.type == "cuda" else 0
    plan = rank_plan(cfg, device, count, os.environ)
    if plan.note:
        print(plan.note)
    if plan.launch == "spawn":
        print(f"[cli] data-parallel over {plan.world} cards: one rank each "
              "(--no_data_parallel trains on one)")
        raise SystemExit(spawn(argv, plan.world))
    group = join_launcher(device.type) if plan.launch == "join" else None
    try:
        return run(cfg, device, group)
    finally:
        if group is not None:
            leave_group()


if __name__ == "__main__":
    main()
