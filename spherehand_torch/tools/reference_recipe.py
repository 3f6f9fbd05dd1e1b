"""The reference recipe at reference scale: the stock hyperparameters.

Counterpart of the JAX package's ``tools/reference_recipe.py``, with its
flags, defaults and result keys. The run:

  ~72k train samples x 3 views   pseudo-NYU (``data.pseudo_real``, the
                                 selfsup demo's shifted sensor), 2,048 test
  75 epochs                      (run_engine.py:23)
  Adam lr 1e-3, weight decay 1e-5, StepLR /10 every 25 epochs
                                 (engine.py:95-99)
  real bs 25 x 3 views + synthetic bs 48 a step (engine.py:326-330)
  is_mv for the first 1500 iterations of each epoch (engine.py:361)
  init = the shipped synthetic pretraining (README.md:40-49)

Each epoch is the engine's combined epoch (``Engine._epoch_combined``);
the evals run in float32 with TF32 off (``eval_precision="highest"``).
Writes ``<out>/trajectory.json``: every eval point, the run's config, its
seconds, ``backend`` (the card's name and power limit, as nvidia-smi gives
them), ``params_sha256`` of the final network and ``launches`` (the
port's kernels launched by this call's epochs and evals, and how often),
which it also prints as a JSON line.

Resumable: a rolling checkpoint (``model_-1.pt``) and
``recipe_state.json``; running again with the same ``--out`` resumes from
the checkpoint at the epoch after the one it holds (the port's resume
rule), and the resumed run equals an uninterrupted one bit for bit (the
engine's draws and batches are functions of seed, epoch and iteration).
The JAX tool's ``--steps_per_call`` (K steps in one ``lax.scan`` dispatch)
has no counterpart: the port launches one step at a time.

The process runs with deterministic algorithms (``utils.determinism``).

Usage: python -m spherehand_torch.tools.reference_recipe [--samples 72192] [--test 2048]
       [--epochs 75] [--lr 1e-3] [--out runs/reference_recipe] [--gen_only] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from spherehand_torch.convert import train_state_from_params
from spherehand_torch.data.pseudo_real import (
    DROPOUT,
    SHIFT_PIXEL_SIGMA,
    Z_SIGMA,
    generate_pseudo_nyu,
)
from spherehand_torch.device import resolve_device
from spherehand_torch.infer import load_params_npz
from spherehand_torch.tools import launch_counts, launches_since, refuse_golden
from spherehand_torch.tools.selfsup_demo import (
    PRETRAINED,
    TEST_SEED_OFFSET,
    backend,
    params_sha256,
)
from spherehand_torch.train.config import EngineConfig
from spherehand_torch.train.engine import Engine
from spherehand_torch.utils import determinism


def make_data(data_dir: str, samples: int, test: int, seed: int,
              device: torch.device | str | None = None) -> None:
    """The pseudo-NYU ``train/`` and ``test/`` shards under ``data_dir``,
    unless they are there already."""
    if os.path.exists(os.path.join(data_dir, "test", "mv_data_0_shape.pkl")):
        return
    t0 = time.time()
    generate_pseudo_nyu(os.path.join(data_dir, "train"), samples, seed, device)
    generate_pseudo_nyu(os.path.join(data_dir, "test"), test, seed + TEST_SEED_OFFSET, device)
    print(f"pseudo-NYU data: {samples}+{test} samples x 3 views in {time.time() - t0:.1f}s",
          flush=True)


def _fresh_state() -> dict:
    return {"next_epoch": 0, "trajectory": [], "run_name": None, "train_secs": 0.0}


def run(out: str = os.path.join("runs", "reference_recipe"), samples: int = 72_192,
        test: int = 2048, epochs: int = 75, lr: float = 1e-3, eval_every: int = 1,
        save_every: int = 1, bf16: bool = False, seed: int = 0, tag: str = "refrecipe_",
        gen_only: bool = False, device: torch.device | str | None = None,
        engine_overrides: dict | None = None) -> dict | None:
    """The recipe run (or its continuation); returns what it writes to
    ``<out>/trajectory.json``, or None under ``gen_only``.
    ``engine_overrides``: ``EngineConfig`` fields to change (e.g. batch
    sizes for a small run)."""
    final_path = os.path.join(out, "trajectory.json")
    refuse_golden(final_path)
    dev = resolve_device(device)
    data_dir = os.path.join(out, "data")
    make_data(data_dir, samples, test, seed, dev)
    if gen_only:
        return None
    before = launch_counts()

    state_file = os.path.join(out, "recipe_state.json")
    rstate = _fresh_state()
    if os.path.exists(state_file):
        with open(state_file) as f:
            rstate = json.load(f)
    cfg = dataclasses.replace(EngineConfig(
        mode="Train", model_dir=os.path.join(out, "runs"), dataset_dir=data_dir, epoch=epochs,
        num_stacks=1, lr=lr, bf16=bf16, eval_precision="highest", tag=tag, seed=seed,
    ), **(engine_overrides or {}))
    ckpt = (os.path.join(cfg.model_dir, rstate["run_name"], "model_-1.pt")
            if rstate["run_name"] else None)
    if ckpt and not os.path.exists(ckpt):
        # stopped inside the first --save_every window: no checkpoint, start again
        print(f"[recipe] no checkpoint at {ckpt}; restarting fresh", flush=True)
        rstate, ckpt = _fresh_state(), None
    if ckpt:
        engine = Engine(dataclasses.replace(cfg, restore_from_model=rstate["run_name"],
                                            restore_from_epoch=-1), device=dev)
        if engine.starting_epoch != rstate["next_epoch"]:
            raise RuntimeError(f"{ckpt} holds epoch {engine.starting_epoch - 1}, but "
                               f"{state_file} resumes at {rstate['next_epoch']}")
        print(f"[recipe] resumed at epoch {engine.starting_epoch} from {ckpt}", flush=True)
    else:
        engine = Engine(cfg, device=dev)
        engine.state = train_state_from_params(engine.steps.init_state,
                                               load_params_npz(PRETRAINED))
        rstate["run_name"] = engine.model_name

    def save_state() -> None:
        with open(state_file + ".tmp", "w") as f:
            json.dump(rstate, f, indent=2)
        os.replace(state_file + ".tmp", state_file)

    def evaluate(epoch: int, label: str) -> None:
        res = engine._epoch_real_eval(max(epoch, 0))
        point = {"epoch": epoch, "label": label, "lr": cfg.lr_at_epoch(max(epoch, 0)),
                 "step": int(engine.state.step),
                 "avg_joint_error": round(float(res["avg_joint_error"]), 4),
                 "avg_joint_error_raw": round(float(res["avg_joint_error_raw"]), 4)}
        rstate["trajectory"].append(point)
        print(f"[recipe] {json.dumps(point)}", flush=True)

    if not ckpt:
        evaluate(-1, "before")
        save_state()
    for epoch in range(engine.starting_epoch, cfg.epoch):
        t0 = time.time()
        engine._epoch_combined(epoch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rstate["train_secs"] += time.time() - t0
        saved = (epoch + 1) % save_every == 0 or epoch == cfg.epoch - 1
        if saved:
            engine.save_checkpoint(-1, epoch)
        if (epoch + 1) % eval_every == 0 or epoch == cfg.epoch - 1:
            evaluate(epoch, "train")
        if saved:  # the resume point moves only past epochs a checkpoint holds
            rstate["next_epoch"] = epoch + 1
            save_state()

    final = {
        "config": dataclasses.asdict(cfg),
        "samples": samples,
        "test": test,
        "sensor_shift": dict(shift_sigma=SHIFT_PIXEL_SIGMA, z_sigma=Z_SIGMA, dropout=DROPOUT),
        "steps": int(engine.state.step),
        "train_secs": round(rstate["train_secs"], 1),
        "trajectory": rstate["trajectory"],
        "backend": backend(dev),
        "params_sha256": params_sha256(engine.state.network),
        "launches": launches_since(before),
    }
    with open(final_path, "w") as f:
        json.dump(final, f, indent=2)
    traj = rstate["trajectory"]
    print(json.dumps({"backend": final["backend"], "launches": final["launches"]}), flush=True)
    print(f"[recipe] DONE: before {traj[0]['avg_joint_error']:.2f} mm -> final "
          f"{traj[-1]['avg_joint_error']:.2f} mm (best "
          f"{min(p['avg_joint_error'] for p in traj):.2f}) in {final['train_secs']:.0f}s; "
          f"wrote {final_path}", flush=True)
    return final


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=72_192,
                    help="train samples (x 3 views); NYU's 72,757 rounded to 256-hand chunks")
    ap.add_argument("--test", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=75)
    ap.add_argument("--lr", type=float, default=1e-3, help="the stock reference lr")
    ap.add_argument("--eval_every", type=int, default=1)
    ap.add_argument("--save_every", type=int, default=1,
                    help="rolling-checkpoint cadence in epochs (the resume granularity)")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 convolutions")
    ap.add_argument("--out", default=os.path.join("runs", "reference_recipe"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="refrecipe_")
    ap.add_argument("--gen_only", action="store_true",
                    help="write the pseudo-NYU set and exit (other tools reuse it)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu: the plain path)")
    args = ap.parse_args(argv)
    determinism.enable()
    run(**vars(args))


if __name__ == "__main__":
    main()
