"""The lite mesh's end-to-end quality gate: train on lite, evaluate on full.

Counterpart of the JAX package's ``tools/lite_mesh_e2e.py``. The lite
mesh exists to generate synthetic training data, so the deciding metric is
whether an estimator trained on lite renders matches one trained on full
renders when both are evaluated on full-mesh held-out renders. Each arm
(``lite``, ``full`` or ``<mesh>_bf16``) trains through
``train_synthetic_full.train_synthetic`` (its StepLR thirds switch at
``3 i // N``; the JAX tool's own loop switches at ``N // 3``, at most one
step earlier) and is evaluated in float32 with TF32 off on 2048 held-out
noisy full-mesh renders (``eval_synthetic.heldout_errors``).

Usage: python -m spherehand_torch.tools.lite_mesh_e2e [--steps N] [--arms lite,full]
       [--artifact PATH] [--seed S] [--device cpu]
       python -m spherehand_torch.tools.lite_mesh_e2e --merge A.json B.json ... --artifact PATH

The arms are independent, so they may train in separate processes sharing
the card (one ``--arms`` each); ``--merge`` joins their artifacts, which
must agree on ``steps`` and ``seed``, into one. Besides the JAX tool's keys
the artifact holds ``seed``, ``backend`` (the card's name and power limit,
as nvidia-smi gives them) and ``launches`` (the port's kernel launch
counters over the run), and the run prints the last two as a JSON line.

The artifact defaults to ``runs/lite_mesh_e2e.json``; the port's
convergence record is ``tests/goldens/torch_lite_mesh_e2e.json``. No run, of
any length, writes the JAX record ``tests/goldens/lite_mesh_e2e.json``
(``tools.refuse_golden``). The process runs with deterministic algorithms
(``utils.determinism``).
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from spherehand_torch.device import resolve_device
from spherehand_torch.hand.assets import load_hand_model
from spherehand_torch.tools import GOLDENS, launch_counts, launches_since, refuse_golden
from spherehand_torch.tools.eval_synthetic import heldout_errors
from spherehand_torch.tools.selfsup_demo import backend
from spherehand_torch.tools.train_synthetic_full import train_synthetic
from spherehand_torch.utils import determinism

GOLDEN = os.path.join(GOLDENS, "lite_mesh_e2e.json")  # the JAX record, never written here


def run_arms(arms: list[str], num_steps: int, artifact: str, batch: int = 48,
             eval_samples: int = 2048, eval_batch: int = 128,
             device: torch.device | str | None = None, seed: int = 0) -> dict:
    """Train (from ``seed``, ``train_synthetic``'s) and evaluate each arm;
    writes and returns {"steps", "seed", "backend", "launches", arm:
    {"train_secs", "heldout_mm"}}."""
    refuse_golden(artifact)
    dev = resolve_device(device)
    full = load_hand_model(device=dev)
    before = launch_counts()
    result = {"steps": num_steps, "seed": seed, "backend": backend(dev)}
    for arm in arms:
        mesh, _, suffix = arm.partition("_")
        run = train_synthetic(num_steps, batch, mesh, bf16=suffix == "bf16", device=dev,
                              seed=seed)
        network = run.state.network
        network.set_dtype(torch.float32)  # evaluated as the JAX tool's make_network(1)
        err = float(heldout_errors(network, full, eval_samples, eval_batch).mean())
        print(f"[{arm}] {num_steps} steps in {run.seconds:.1f}s; held-out joint error on "
              f"full-mesh renders: {err:.2f} mm", flush=True)
        result[arm] = {"train_secs": round(run.seconds, 1), "heldout_mm": round(err, 3)}
    result["launches"] = launches_since(before)
    print(json.dumps({"backend": result["backend"], "launches": result["launches"]}), flush=True)
    _write(artifact, result)
    return result


def _write(artifact: str, result: dict) -> None:
    art = os.path.abspath(artifact)
    os.makedirs(os.path.dirname(art), exist_ok=True)
    with open(art, "w") as f:
        json.dump(result, f, indent=1)


def merge(paths: list[str], artifact: str) -> dict:
    """Join per-arm artifacts of one run length and seed into ``artifact``;
    launches are summed, and the backends must agree."""
    refuse_golden(artifact)
    parts = []
    for path in paths:
        with open(path) as f:
            parts.append(json.load(f))
    merged: dict = {"launches": {}}
    for part in parts:
        for key in ("steps", "seed", "backend"):
            if merged.setdefault(key, part[key]) != part[key]:
                raise ValueError(f"{key} differs across the artifacts: "
                                 f"{merged[key]} vs {part[key]}")
        for name, n in part["launches"].items():
            merged["launches"][name] = merged["launches"].get(name, 0) + n
        arms = {k: v for k, v in part.items() if k not in ("steps", "seed", "backend", "launches")}
        if arms.keys() & merged.keys():
            raise ValueError(f"an arm appears twice: {sorted(arms.keys() & merged.keys())}")
        merged.update(arms)
    _write(artifact, merged)
    return merged


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10_000)
    ap.add_argument("--arms", default="lite,full")
    ap.add_argument("--artifact", default=os.path.join("runs", "lite_mesh_e2e.json"),
                    help="output path (the port's convergence record: "
                         "tests/goldens/torch_lite_mesh_e2e.json; never a JAX record)")
    ap.add_argument("--seed", type=int, default=0,
                    help="training seed (0: the JAX tool's keys; others: another reading)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu: the plain path)")
    ap.add_argument("--merge", nargs="+", metavar="JSON",
                    help="join these per-arm artifacts into --artifact, and train nothing")
    args = ap.parse_args(argv)
    try:
        refuse_golden(args.artifact)
    except ValueError as exc:
        raise SystemExit(str(exc)) from None
    if args.merge:
        merge(args.merge, args.artifact)
        print("wrote", os.path.abspath(args.artifact))
        return
    determinism.enable()
    run_arms(args.arms.split(","), args.steps, args.artifact, device=args.device,
             seed=args.seed)
    print("wrote", os.path.abspath(args.artifact))


if __name__ == "__main__":
    main()
