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
from spherehand_torch.tools import GOLDENS, refuse_golden
from spherehand_torch.tools.eval_synthetic import heldout_errors
from spherehand_torch.tools.train_synthetic_full import train_synthetic
from spherehand_torch.utils import determinism

GOLDEN = os.path.join(GOLDENS, "lite_mesh_e2e.json")  # the JAX record, never written here


def run_arms(arms: list[str], num_steps: int, artifact: str, batch: int = 48,
             eval_samples: int = 2048, eval_batch: int = 128,
             device: torch.device | str | None = None, seed: int = 0) -> dict:
    """Train (from ``seed``, ``train_synthetic``'s) and evaluate each arm;
    writes and returns {"steps", arm: {"train_secs", "heldout_mm"}}."""
    refuse_golden(artifact)
    art = os.path.abspath(artifact)
    dev = resolve_device(device)
    full = load_hand_model(device=dev)
    result = {"steps": num_steps}
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
    os.makedirs(os.path.dirname(art), exist_ok=True)
    with open(art, "w") as f:
        json.dump(result, f, indent=1)
    return result


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
    args = ap.parse_args(argv)
    try:
        refuse_golden(args.artifact)
    except ValueError as exc:
        raise SystemExit(str(exc)) from None
    determinism.enable()
    run_arms(args.arms.split(","), args.steps, args.artifact, device=args.device,
             seed=args.seed)
    print("wrote", os.path.abspath(args.artifact))


if __name__ == "__main__":
    main()
