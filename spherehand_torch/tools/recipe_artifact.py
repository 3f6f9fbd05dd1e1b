"""Harvest the reference-scale recipe runs into the port's record.

Counterpart of the JAX package's ``tools/recipe_artifact.py``. Reads two
``reference_recipe`` outputs:

  runs/reference_recipe/   the stock recipe (Adam lr 1e-3, StepLR /10 every
                           25 epochs, 75 epochs)
  runs/companion_lr3e5/    the companion (the same stack at lr 3e-5, 24 epochs)

and writes both eval trajectories with the run configs to
``tests/goldens/torch_recipe_at_scale.json`` (never to the JAX record
``recipe_at_scale.json``: ``tools.refuse_golden``). A run that has not
finished is taken from its ``recipe_state.json``, marked
``finished: false``. The port's evals run in float32 with TF32 off, so
the record says ``eval_precision: "highest"`` and carries no wobble note.
Its ``main()`` switches on the deterministic settings first, as every tool
of the evidence path does.

Usage: python -m spherehand_torch.tools.recipe_artifact [--stock DIR] [--companion DIR]
       [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os

from spherehand_torch.tools import GOLDENS, refuse_golden
from spherehand_torch.utils import determinism

OUT = os.path.join(GOLDENS, "torch_recipe_at_scale.json")


def _load_run(out_dir: str) -> dict:
    """The run's compact trajectory and metadata: from ``trajectory.json``
    when it finished, else from ``recipe_state.json`` (the same trajectory
    list) with ``finished: false``."""
    final = os.path.join(out_dir, "trajectory.json")
    if os.path.exists(final):
        with open(final) as f:
            blob = json.load(f)
        meta = {k: blob[k] for k in ("config", "samples", "test", "steps", "train_secs",
                                     "backend") if k in blob}
        meta["finished"] = True
    else:
        with open(os.path.join(out_dir, "recipe_state.json")) as f:
            blob = json.load(f)
        meta = {"train_secs": blob.get("train_secs"), "finished": False}
    meta["trajectory"] = [{"epoch": e["epoch"], "lr": e["lr"], "mm": e["avg_joint_error"],
                           "raw_mm": e["avg_joint_error_raw"]} for e in blob["trajectory"]]
    return meta


def build(stock: str, companion: str) -> dict:
    """The record of the two runs under ``stock`` and ``companion``."""
    return {
        "stock": _load_run(stock),
        "companion": _load_run(companion),
        "provenance": "spherehand_torch/tools/reference_recipe.py; PERF.md, the recipe pair",
        "eval_precision": "highest",
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stock", default=os.path.join("runs", "reference_recipe"))
    ap.add_argument("--companion", default=os.path.join("runs", "companion_lr3e5"))
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    try:
        refuse_golden(args.out)
    except ValueError as exc:
        raise SystemExit(str(exc)) from None
    determinism.enable()  # reads files only; enabled as every tool's main() does
    art = build(args.stock, args.companion)
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1)
    s, c = art["stock"]["trajectory"], art["companion"]["trajectory"]
    print(f"stock: {len(s)} evals, {s[0]['mm']} -> {s[-1]['mm']} mm "
          f"(finished={art['stock']['finished']})")
    print(f"companion: {len(c)} evals, {c[0]['mm']} -> {c[-1]['mm']} mm "
          f"best {min(e['mm'] for e in c)}")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
