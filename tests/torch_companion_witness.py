"""The companion recipe (lr 3e-5 from the shipped pretraining) at a cut size:
does the port's loop lower the eval on the port's pseudo-NYU hands as JAX's
loop does on the same hands, and as JAX's loop does on its own writer's
hands (the data of the JAX record, ``goldens/recipe_at_scale.json``)? And
does the port's loop on the card, where the recipe ran, do as on the CPU?

Five arms, each one process, at the same sizes and settings:

  ``jax_port``        JAX's Engine over the port's hands (``data.pseudo_real``)
  ``port_port``       the port's Engine over the same hands on the CPU, with
                      its own draws, as ``tools.reference_recipe`` runs it
  ``jax_jax``         JAX's Engine over the hands of the JAX writer
                      (``tools/selfsup_demo.generate_pseudo_nyu``)
  ``card_port``       ``port_port`` on the card under the tools'
                      deterministic settings, training with cuDNN's TF32
                      convolutions as the recipe did (imports no JAX)
  ``card_port_fp32``  ``card_port`` with TF32 off in training too

and one at reference scale:

  ``card_recipe_fp32``  the companion of ``tools.reference_recipe`` as the
                        card ran it for the record (72,192 + 2,048 hands
                        written on the card, 25 x 3 + 48 hands a step),
                        with TF32 off in training too; it goes on through
                        the recipe's 24 epochs, so run it under a time
                        limit: every epoch's eval is in
                        ``W/card_recipe_fp32/recipe_state.json``, and a
                        second run resumes it

Each engine is the recipe's (``EngineConfig`` defaults, float32, evals in
float32 with TF32 off) with the companion's lr, 3e-5, and its 24-epoch
StepLR, so the lr stays 3e-5 over the epochs run; only the sizes are cut:
``TRAIN`` train and ``TEST`` test hands, ``REAL`` hands x 3 views and
``SYNT`` synthetic hands a step, ``EPOCHS`` epochs, and the ``is_mv``
window the recipe's share of an epoch (1,500 of 2,887 iterations). Both writers run on the CPU, seed 0 for train
and 10,000 for test, in chunks of 256 hands (the JAX writer drops a
remainder). Every arm evaluates its test hands before the first epoch and
after each epoch; the port's arms and ``jax_port`` read the same shards
(the card arms read the shards the CPU wrote, copied under ``W``).

If ``port_port`` and ``jax_port`` fall alike and ``jax_jax`` falls further,
the gap of the card's companion to the JAX record is the data; if
``jax_port`` falls and ``port_port`` does not, it is the port's code.

Run from the repository root, the writers first (on one core the port's
writes 512 hands in about 15 minutes, JAX's 512 in about 10), then the arms
(one core each, in parallel; about 7.5 minutes an epoch at the defaults),
then the report::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_companion_witness.py --work W --arm write
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_companion_witness.py --work W --arm jax_port
    (and port_port, jax_jax, and on the card card_port, card_port_fp32;
    each writes W/<arm>.json)
    PYTHONPATH=. python tests/torch_companion_witness.py --work W --report
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("XLA_FLAGS", "--xla_cpu_multi_thread_eigen=false "
                                   "intra_op_parallelism_threads=1")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

ARMS = ("jax_port", "port_port", "jax_jax", "card_port", "card_port_fp32", "card_recipe_fp32")
LR, EPOCHS_SCHEDULE = 3e-5, 24  # the companion: --lr 3e-5 --epochs 24
MV_SHARE = 1500 / 2887  # the recipe's is_mv window over its epoch of 72,192 / 25 iterations
TEST_SEED = 10_000
TRAIN, TEST, REAL, SYNT, EPOCHS = 512, 256, 5, 10, 8


def write(work: str) -> None:
    """Both writers' train and test shards under ``work``."""
    import torch

    from spherehand_torch.data import pseudo_real

    torch.set_num_threads(1)
    for split, n, seed in (("train", TRAIN, 0), ("test", TEST, TEST_SEED)):
        out = os.path.join(work, "port_data", split)
        if not os.path.exists(os.path.join(out, "mv_data_0_shape.pkl")):
            t0 = time.time()
            pseudo_real.generate_pseudo_nyu(out, n, seed, "cpu")
            print(f"port writer: {split} {n} hands in {time.time() - t0:.0f} s", flush=True)
    sys.path.insert(0, os.path.join(HERE, "..", "tools"))
    import selfsup_demo as jax_writer

    for split, n, seed in (("train", TRAIN, 0), ("test", TEST, TEST_SEED)):
        out = os.path.join(work, "jax_data", split)
        if not os.path.exists(os.path.join(out, "mv_data_0_shape.pkl")):
            t0 = time.time()
            jax_writer.generate_pseudo_nyu(out, n, seed)
            print(f"JAX writer: {split} {n} hands in {time.time() - t0:.0f} s", flush=True)


def _config(cls, data_dir: str, model_dir: str, **extra):
    return dataclasses.replace(cls(), mode="Train", model_dir=model_dir, dataset_dir=data_dir,
                               epoch=EPOCHS_SCHEDULE, num_stacks=1, lr=LR, real_batch=REAL,
                               synt_batch=SYNT, mv_curriculum_iters=round(TRAIN // REAL * MV_SHARE),
                               eval_precision="highest", device_data="on", tag="witness_",
                               seed=0, **extra)


def _engine(arm: str, data: str, model_dir: str, monkeypatch):
    """The arm's engine at the shipped weights with a fresh Adam."""
    if arm.startswith("jax_"):
        import test_torch_trajectory as traj
        from spherehand_tpu.train.config import EngineConfig as JEngineConfig

        return traj._jax_engine(_config(JEngineConfig, data, model_dir, data_parallel=False),
                                monkeypatch)
    import torch

    from spherehand_torch.convert import train_state_from_params
    from spherehand_torch.infer import load_params_npz
    from spherehand_torch.tools.selfsup_demo import PRETRAINED
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.engine import Engine
    from spherehand_torch.utils import determinism

    device = "cpu"
    if arm.startswith("card_"):
        determinism.enable()
        torch.backends.cudnn.allow_tf32 = arm == "card_port"
        device = "cuda"
    engine = Engine(_config(EngineConfig, data, model_dir), device=device)
    engine.state = train_state_from_params(engine.steps.init_state, load_params_npz(PRETRAINED))
    return engine


def recipe_fp32(work: str) -> None:
    """``card_recipe_fp32``: the recipe's companion with TF32 off in training."""
    import torch

    from spherehand_torch.tools import reference_recipe
    from spherehand_torch.utils import determinism

    determinism.enable()
    torch.backends.cudnn.allow_tf32 = False
    reference_recipe.run(out=os.path.join(work, "card_recipe_fp32"), lr=LR,
                         epochs=EPOCHS_SCHEDULE, device="cuda")


def run_arm(arm: str, work: str) -> dict:
    """One arm's evals before and after each epoch, and its seconds."""
    import pytest
    import torch

    torch.set_num_threads(1)
    data = os.path.join(work, "jax_data" if arm == "jax_jax" else "port_data")
    model_dir = os.path.join(work, arm)
    with pytest.MonkeyPatch.context() as monkeypatch:
        engine = _engine(arm, data, model_dir, monkeypatch)
        monkeypatch.setattr(engine, "_dump_train_images", lambda *_a: None)
        evals, t0 = [], time.time()

        def evaluate(epoch: int) -> None:
            res = engine._epoch_real_eval(max(epoch, 0))
            evals.append({"epoch": epoch, "lr": engine.cfg.lr_at_epoch(max(epoch, 0)),
                          "avg_joint_error": round(float(res["avg_joint_error"]), 4),
                          "avg_joint_error_raw": round(float(res["avg_joint_error_raw"]), 4),
                          "secs": round(time.time() - t0, 1)})
            print(f"[{arm}] {json.dumps(evals[-1])}", flush=True)

        evaluate(-1)
        for epoch in range(EPOCHS):
            engine._epoch_combined(epoch)
            evaluate(epoch)
    cfg = engine.cfg
    return {"arm": arm, "data": os.path.basename(data), "train": TRAIN,
            "real_batch": cfg.real_batch, "synt_batch": cfg.synt_batch,
            "iters_per_epoch": TRAIN // cfg.real_batch, "is_mv_iters": cfg.mv_curriculum_iters,
            "lr": LR, "evals": evals}


def report(work: str) -> None:
    """One line an arm: the eval before and after each epoch, and the change."""
    for arm in ARMS[:-1]:
        path = os.path.join(work, f"{arm}.json")
        if not os.path.exists(path):
            print(f"{arm}: not run")
            continue
        with open(path) as f:
            rec = json.load(f)
        errs = [e["avg_joint_error"] for e in rec["evals"]]
        print(f"{arm} ({rec['data']}, {rec['train']} hands, {rec['iters_per_epoch']} steps an "
              f"epoch): " + " -> ".join(f"{e:.4f}" for e in errs)
              + f" mm; change {errs[-1] - errs[0]:+.4f}, best {min(errs) - errs[0]:+.4f}; "
              f"{rec['evals'][-1]['secs']:.0f} s")
    path = os.path.join(work, ARMS[-1], "recipe_state.json")
    if os.path.exists(path):
        with open(path) as f:
            state = json.load(f)
        errs = [e["avg_joint_error"] for e in state["trajectory"]]
        print(f"{ARMS[-1]} ({state['samples']} hands, {state['steps']} steps): "
              + " -> ".join(f"{e:.4f}" for e in errs) + f" mm; {state['train_secs']:.0f} train s")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--work", required=True, help="directory for the hands and the records")
    parser.add_argument("--arm", choices=("write",) + ARMS)
    parser.add_argument("--report", action="store_true")
    args = parser.parse_args(argv)
    if args.report:
        report(args.work)
    elif args.arm == "write":
        write(args.work)
    elif args.arm == ARMS[-1]:
        recipe_fp32(args.work)
    elif args.arm:
        rec = run_arm(args.arm, args.work)
        with open(os.path.join(args.work, f"{args.arm}.json"), "w") as f:
            json.dump(rec, f, indent=2)
    else:
        parser.error("give --arm or --report")


if __name__ == "__main__":
    main()
