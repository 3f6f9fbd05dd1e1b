"""The companion recipe (lr 3e-5 from the shipped pretraining): where does the
port's run leave the JAX record (``goldens/recipe_at_scale.json``: 49.8575
-> 39.0056 mm after epoch 0 on a TPU v5e), and is the port's code at fault?

Arms at a cut size, each one process at the same sizes and settings:

  ``jax_port``        JAX's Engine over the port's hands (``data.pseudo_real``)
  ``port_port``       the port's Engine over the same hands on the CPU, with
                      its own draws, as ``tools.reference_recipe`` runs it
  ``jax_jax``         JAX's Engine over the hands of the JAX writer
                      (``tools/selfsup_demo.generate_pseudo_nyu``)
  ``card_port``       ``port_port`` on the card under the tools'
                      deterministic settings, training with cuDNN's TF32
                      convolutions as the recipe did (imports no JAX)
  ``card_port_fp32``  ``card_port`` with TF32 off in training too
  ``card_cut_cardhands``  ``card_port`` over hands the card writes
                      (``generate_pseudo_nyu(..., "cuda")``, seeds 0 and
                      10,000, into ``W/card_data``)
  ``jax_cardhands`` / ``port_cardhands``  ``jax_port`` / ``port_port`` over
                      ``W/card_data`` (bring it back from the card first)

Each cut engine is the recipe's (``EngineConfig`` defaults, float32, evals in
float32 with TF32 off) with the companion's lr, 3e-5, and its 24-epoch
StepLR, so the lr stays 3e-5 over the epochs run; only the sizes are cut:
``TRAIN`` train and ``TEST`` test hands, ``REAL`` hands x 3 views and
``SYNT`` synthetic hands a step, ``EPOCHS`` epochs, and the ``is_mv``
window the recipe's share of an epoch (1,500 of 2,887 iterations). The CPU
writers run seed 0 for train and 10,000 for test, in chunks of 256 hands
(the JAX writer drops a remainder). Every arm evaluates its test hands
before the first epoch and after each epoch; ``port_port``, ``jax_port``
and the card's ``card_port*`` arms read the same shards (the card arms read
the shards the CPU wrote, copied under ``W``).

Arms at reference scale (72,192 + 2,048 hands x 3 views written on the
card, 25 x 3 + 48 hands a step, 2,887 steps an epoch), each the record's
companion (``tests/goldens/torch_recipe_at_scale.json``: the shipped
pretraining with a fresh Adam, the tools' deterministic settings, TF32 on
in training, evals of the test hands in float32 with TF32 off, the seed-0
split written on the card) but for what :data:`RECIPE_ARMS` changes:

  ``card_recipe_fp32``      TF32 off in training too; it goes on through the
                            recipe's 24 epochs (``reference_recipe.run``), so
                            run it under a time limit
  ``card_recipe_steps``     none: epochs 0-1, an eval every 289 iterations;
                            its eval after epoch 0 (step 2,887) is the
                            record's, bit for bit
  ``card_recipe_bf16``      ``bf16=True`` (bfloat16 convolutions)
  ``card_recipe_seed1``     ``--seed 1``: its own split and draws
  ``card_recipe_drawseed1`` the seed-0 split, engine seed 1 (draws and batch
                            order)
  ``card_recipe_cutbatch``  5 x 3 + 10 hands a step: 8,160 steps, an eval
                            every 816

A reference-scale arm steps the engine's own combined epoch
(``Engine._epoch_combined``); an eval between two steps touches no training
state and the draws are functions of (seed, epoch, iteration), so the
evals inside an epoch leave the run as it is. The seed-0 arms read the split
in ``W/seed0/data`` (write it once with ``reference_recipe --gen_only --out
W/seed0``) and refuse one whose SHA-256 is not the record's. Each arm
rewrites ``W/<arm>.json`` after every eval: its evals (epoch, iteration,
step), the card's name and power limit, the split's digest, the port's
kernel launches and its seconds.

``--report`` prints a line an arm; ``--report --artifact PATH`` also writes
the record of the companion arms (``tests/goldens/torch_companion_arms.json``)
with the conclusion that :func:`conclude` draws under the decision rule in
``PERF.md``'s Findings (the companion arms), and with ``--full DIR`` the seed-1 companion run to
its 24th epoch (``card_records.sh recipe GUARD_S FROM 1``).

Run from the repository root; the CPU arms take about 7.5 minutes an epoch
on one core each; on the card ``card_records.sh companion`` runs the six
arms of the record in parallel::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_companion_witness.py --work W --arm write
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_companion_witness.py --work W --arm jax_port
    (and the others; each writes W/<arm>.json)
    PYTHONPATH=. python tests/torch_companion_witness.py --work W --report
    (with --artifact PATH, and --full DIR: the record)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("XLA_FLAGS", "--xla_cpu_multi_thread_eigen=false "
                                   "intra_op_parallelism_threads=1")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CUT_ARMS = ("jax_port", "port_port", "jax_jax", "card_port", "card_port_fp32",
            "card_cut_cardhands", "jax_cardhands", "port_cardhands")
# arm: (split seed, EngineConfig changes, epochs, eval every N iterations,
# stop before iteration N of the last epoch)
RECIPE_ARMS = {
    "card_recipe_steps": (0, {}, 2, 289, None),
    "card_recipe_bf16": (0, {"bf16": True}, 3, 0, None),
    "card_recipe_seed1": (1, {"seed": 1}, 3, 0, None),
    "card_recipe_drawseed1": (0, {"seed": 1}, 3, 0, None),
    "card_recipe_cutbatch": (0, {"real_batch": 5, "synt_batch": 10}, 1, 816, 8160),
}
ARMS = CUT_ARMS + ("card_recipe_fp32",) + tuple(RECIPE_ARMS)
# The record's card arms, and the CPU arms it holds when the rule calls for them.
RECORD_ARMS = tuple(RECIPE_ARMS) + ("card_cut_cardhands",)
CPU_ARMS = ("jax_cardhands", "port_cardhands")
ISOLATES = {
    "card_recipe_steps": "where inside epoch 0 the port turns",
    "card_recipe_bf16": "the training numerics",
    "card_recipe_seed1": "the split and the draws",
    "card_recipe_drawseed1": "the draws alone",
    "card_recipe_cutbatch": "the recipe's batch, at the record's data",
    "card_cut_cardhands": "the card writer's hands",
    "jax_cardhands": "JAX's loop on the card's hands",
    "port_cardhands": "the port's loop on the card's hands, on the CPU",
}
LR, EPOCHS_SCHEDULE = 3e-5, 24  # the companion: --lr 3e-5 --epochs 24
MV_SHARE = 1500 / 2887  # the recipe's is_mv window over its epoch of 72,192 / 25 iterations
TEST_SEED = 10_000
TRAIN, TEST, REAL, SYNT, EPOCHS = 512, 256, 5, 10, 8
RECIPE_SAMPLES, RECIPE_TEST = 72_192, 2048
PORT_RECORD = os.path.join(HERE, "goldens", "torch_recipe_at_scale.json")

# The decision rule (PERF.md's Findings, the companion arms; written before they ran).
JAX_EPOCH0 = 39.0056  # TPU v5e, the JAX record after epoch 0
NEAR_MM = 2.0         # "within 2 mm of" JAX's epoch 0
GAP_BAR_MM = 10.0     # the JAX bar: best under before - 10
CUT_GAIN_MM = 7.0     # what the cut arms closed by step 816 (7.36-11.37 mm)
CARD_PORT_GAIN_MM = 8.24  # what card_port closed over its 816 steps (PERF.md)
MISS_MM = 3.0         # a cut arm that closes this much less than card_port misses
CODE_GAP_MM = 3.0     # JAX's loop closing this much more than the port's on one set of hands
TURN_MM = 44.0        # the steps arm's curve: below this inside epoch 0?


class _Stop(Exception):
    """Ends an arm's run before the iteration its spec names."""


def _write_json(path: str, rec: dict) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f, indent=2)
    os.replace(path + ".tmp", path)


def write(work: str) -> None:
    """Both CPU writers' train and test shards under ``work``."""
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


def write_card_hands(work: str) -> None:
    """The cut size's train and test hands written by the port's writer on
    the card into ``W/card_data``."""
    from spherehand_torch.data import pseudo_real

    for split, n, seed in (("train", TRAIN, 0), ("test", TEST, TEST_SEED)):
        out = os.path.join(work, "card_data", split)
        if not os.path.exists(os.path.join(out, "mv_data_0_shape.pkl")):
            t0 = time.time()
            pseudo_real.generate_pseudo_nyu(out, n, seed, "cuda")
            print(f"card writer: {split} {n} hands in {time.time() - t0:.1f} s", flush=True)


def _data_dir(arm: str) -> str:
    if arm == "jax_jax":
        return "jax_data"
    return "card_data" if arm.endswith("cardhands") else "port_data"


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
    from spherehand_torch.convert import train_state_from_params
    from spherehand_torch.infer import load_params_npz
    from spherehand_torch.tools.selfsup_demo import PRETRAINED
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.engine import Engine

    device = "cuda" if arm.startswith("card_") else "cpu"
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


def _card_settings(arm: str) -> None:
    """The tools' deterministic settings; TF32 in training as the arm says."""
    import torch

    from spherehand_torch.utils import determinism

    determinism.enable()
    torch.backends.cudnn.allow_tf32 = arm != "card_port_fp32"


def run_arm(arm: str, work: str) -> dict:
    """A cut arm: its evals before and after each epoch, and its seconds."""
    import pytest
    import torch

    from spherehand_torch.tools import launch_counts, launches_since
    from spherehand_torch.tools.reference_recipe import data_digest
    from spherehand_torch.tools.selfsup_demo import backend

    torch.set_num_threads(1)
    if arm.startswith("card_"):
        _card_settings(arm)
    if arm == "card_cut_cardhands":
        write_card_hands(work)
    data = os.path.join(work, _data_dir(arm))
    model_dir = os.path.join(work, arm)
    with pytest.MonkeyPatch.context() as monkeypatch:
        engine = _engine(arm, data, model_dir, monkeypatch)
        monkeypatch.setattr(engine, "_dump_train_images", lambda *_a: None)
        before = launch_counts()
        evals, t0 = [], time.time()
        iters = TRAIN // engine.cfg.real_batch

        def evaluate(epoch: int) -> None:
            res = engine._epoch_real_eval(max(epoch, 0))
            evals.append({"epoch": epoch, "it": 0 if epoch < 0 else iters, "end": epoch >= 0,
                          "step": (epoch + 1) * iters, "lr": engine.cfg.lr_at_epoch(max(epoch, 0)),
                          "mm": round(float(res["avg_joint_error"]), 4),
                          "raw_mm": round(float(res["avg_joint_error_raw"]), 4),
                          "secs": round(time.time() - t0, 1)})
            print(f"[{arm}] {json.dumps(evals[-1])}", flush=True)

        evaluate(-1)
        for epoch in range(EPOCHS):
            engine._epoch_combined(epoch)
            evaluate(epoch)
    cfg = engine.cfg
    rec = {"arm": arm, "isolates": ISOLATES.get(arm), "data": os.path.basename(data),
           "train": TRAIN, "test": TEST, "real_batch": cfg.real_batch,
           "synt_batch": cfg.synt_batch, "iters_per_epoch": iters,
           "is_mv_iters": cfg.mv_curriculum_iters, "lr": LR, "evals": evals,
           "steps": EPOCHS * iters, "secs": evals[-1]["secs"], "data_sha256": data_digest(data),
           "backend": backend(torch.device("cuda" if arm.startswith("card_") else "cpu"))}
    if not arm.startswith("jax_"):
        rec["launches"] = launches_since(before)
    return rec


def recipe_arm(arm: str, work: str, device: str = "cuda", samples: int = RECIPE_SAMPLES,
               test: int = RECIPE_TEST, spec: tuple | None = None,
               overrides: dict | None = None) -> dict:
    """A reference-scale arm of :data:`RECIPE_ARMS` (``spec`` in its place
    and ``overrides``, more ``EngineConfig`` changes, serve a small run on
    the CPU); writes ``W/<arm>.json`` after every eval and returns it."""
    import torch

    from spherehand_torch.convert import train_state_from_params
    from spherehand_torch.infer import load_params_npz
    from spherehand_torch.tools import launch_counts, launches_since
    from spherehand_torch.tools.reference_recipe import data_digest, make_data
    from spherehand_torch.tools.selfsup_demo import PRETRAINED, backend
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.engine import Engine

    seed, changes, epochs, every, stop = spec or RECIPE_ARMS[arm]
    dev = torch.device(device)
    if dev.type == "cuda":
        _card_settings(arm)
    else:
        torch.set_num_threads(1)
    data_dir = os.path.join(work, f"seed{seed}", "data")
    make_data(data_dir, samples, test, seed, dev)
    digest = data_digest(data_dir)
    if (seed, samples, test) == (0, RECIPE_SAMPLES, RECIPE_TEST):
        with open(PORT_RECORD) as f:
            record_digest = json.load(f)["companion"]["data_sha256"]
        if digest != record_digest:
            raise RuntimeError(f"{data_dir} holds shards of sha256 {digest}, not the record's "
                               f"{record_digest}")
    cfg = dataclasses.replace(EngineConfig(
        mode="Train", model_dir=os.path.join(work, arm), dataset_dir=data_dir,
        epoch=EPOCHS_SCHEDULE, num_stacks=1, lr=LR, eval_precision="highest",
        tag="refrecipe_", seed=seed), **{**changes, **(overrides or {})})
    engine = Engine(cfg, device=dev)
    engine.state = train_state_from_params(engine.steps.init_state, load_params_npz(PRETRAINED))
    engine._dump_train_images = lambda *_a: None
    iters = samples // cfg.real_batch
    rec = {"arm": arm, "isolates": ISOLATES.get(arm), "changes": changes, "split_seed": seed,
           "samples": samples, "test": test,
           "real_batch": cfg.real_batch, "synt_batch": cfg.synt_batch, "iters_per_epoch": iters,
           "is_mv_iters": cfg.mv_curriculum_iters, "lr": LR, "config": dataclasses.asdict(cfg),
           "backend": backend(dev), "data_sha256": digest, "evals": [], "steps": 0,
           "secs": 0.0, "eval_secs": 0.0, "finished": False}
    path = os.path.join(work, f"{arm}.json")
    before, t0 = launch_counts(), time.time()

    def evaluate(epoch: int, it: int, end: bool) -> None:
        t = time.time()
        res = engine._epoch_real_eval(max(epoch, 0))
        step = int(engine.state.step)
        rec["evals"].append({"epoch": epoch, "it": it, "end": end, "step": step,
                             "lr": cfg.lr_at_epoch(max(epoch, 0)),
                             "mm": round(float(res["avg_joint_error"]), 4),
                             "raw_mm": round(float(res["avg_joint_error_raw"]), 4)})
        rec.update(steps=step, launches=launches_since(before),
                   eval_secs=round(rec["eval_secs"] + time.time() - t, 1),
                   secs=round(time.time() - t0, 1))
        print(f"[{arm}] {json.dumps(rec['evals'][-1])} {rec['secs']} s", flush=True)
        _write_json(path, rec)

    combined_step = engine.combined_step

    def step_with_evals(epoch: int, it: int, batch):
        if every and it and it % every == 0:
            evaluate(epoch, it, False)
        if it == stop and epoch == epochs - 1:
            raise _Stop
        return combined_step(epoch, it, batch)

    engine.combined_step = step_with_evals
    evaluate(-1, 0, False)
    try:
        for epoch in range(epochs):
            engine._epoch_combined(epoch)
            evaluate(epoch, iters, True)
    except _Stop:
        pass
    rec["finished"] = True
    _write_json(path, rec)
    return rec


def _evals(rec: dict) -> list[float]:
    return [e["mm"] for e in rec["evals"]]


def conclude(arms: dict[str, dict]) -> dict:
    """The decision rule in PERF.md's Findings on the arms' evals."""
    def before(a):
        return arms[a]["evals"][0]["mm"]

    def best(a):
        return min(_evals(arms[a])[1:])

    def epoch0(a):
        return next(e["mm"] for e in arms[a]["evals"] if e["epoch"] == 0 and e["end"])

    def at_step(a, step):
        return next(e["mm"] for e in arms[a]["evals"] if e["step"] == step)

    def cut_gain(a):  # before less the eval after the last epoch
        return before(a) - _evals(arms[a])[-1]

    spread = [a for a in ("card_recipe_seed1", "card_recipe_drawseed1")
              if epoch0(a) <= JAX_EPOCH0 + NEAR_MM or best(a) < before(a) - GAP_BAR_MM]
    numerics = not spread and epoch0("card_recipe_bf16") <= JAX_EPOCH0 + NEAR_MM
    cut_816 = before("card_recipe_cutbatch") - at_step("card_recipe_cutbatch", 816)
    steps_gain = before("card_recipe_steps") - best("card_recipe_steps")
    batch = cut_816 >= CUT_GAIN_MM and steps_gain < CUT_GAIN_MM
    hands_miss = cut_gain("card_cut_cardhands") < CARD_PORT_GAIN_MM - MISS_MM
    cpu = all(a in arms for a in CPU_ARMS)
    code = data = False
    if cpu:
        jax_gain, port_gain = cut_gain("jax_cardhands"), cut_gain("port_cardhands")
        code = jax_gain >= port_gain + CODE_GAP_MM
        data = (not code and max(jax_gain, port_gain) < CARD_PORT_GAIN_MM - MISS_MM
                and abs(jax_gain - port_gain) < CODE_GAP_MM)
    outcome = next((name for name, shown in (("code", code), ("spread", bool(spread)),
                                              ("numerics", numerics), ("batch", batch),
                                              ("data", data)) if shown), "none")
    inside = [e for e in arms["card_recipe_steps"]["evals"] if e["epoch"] == 0 and not e["end"]]
    low = min(inside, key=lambda e: e["mm"])
    return {
        "outcome": outcome,
        "item6": "closed" if outcome in ("code", "spread", "numerics", "data") else "narrowed",
        "spread_arms": spread,
        "bf16_epoch0": epoch0("card_recipe_bf16"),
        "cutbatch_gain_at_816": round(cut_816, 4),
        "steps_best_gain": round(steps_gain, 4),
        "cardhands_gain": round(cut_gain("card_cut_cardhands"), 4),
        "cardhands_miss": hands_miss,
        "cpu_arms_needed": hands_miss,
        "cpu_arms_run": cpu,
        "shape": {"epoch0_low_mm": low["mm"], "epoch0_low_step": low["step"],
                  "below_turn_mm": low["mm"] < TURN_MM,
                  "gives_back_by_2887": low["mm"] < epoch0("card_recipe_steps")},
    }


def artifact(work: str, path: str, full: str | None = None) -> dict:
    """The record of the companion arms, with the rule's conclusion; with
    ``full``, a ``reference_recipe`` output directory, also that companion
    run to its end (``seed1_companion``, as ``recipe_artifact`` reads a run)."""
    from spherehand_torch.tools import refuse_golden
    from spherehand_torch.tools.recipe_artifact import _port_run

    refuse_golden(path)
    arms = {}
    for arm in RECORD_ARMS + CPU_ARMS:
        src = os.path.join(work, f"{arm}.json")
        if os.path.exists(src):
            with open(src) as f:
                arms[arm] = {**json.load(f), "isolates": ISOLATES[arm]}
        elif arm in RECORD_ARMS:
            raise FileNotFoundError(f"{src}: the record needs every card arm")
    bad = [a for a, r in arms.items() if not all(math.isfinite(m) for m in _evals(r))]
    if bad:
        raise ValueError(f"non-finite evals in {bad}")
    rec = {"jax_record": {"device": "TPU v5e", "before": 49.8575, "epoch0": JAX_EPOCH0,
                          "best": 35.5863, "final": 39.8008},
           "port_record": {"before": 49.4868, "epoch0": 44.9737, "epoch0_step": 2887},
           "rule": {"near_mm": NEAR_MM, "gap_bar_mm": GAP_BAR_MM, "cut_gain_mm": CUT_GAIN_MM,
                    "card_port_gain_mm": CARD_PORT_GAIN_MM, "miss_mm": MISS_MM,
                    "code_gap_mm": CODE_GAP_MM, "turn_mm": TURN_MM},
           "arms": arms, "conclusion": conclude(arms)}
    if full:
        rec["seed1_companion"] = _port_run(full)
    _write_json(path, rec)
    return rec


def report(work: str) -> None:
    """One line an arm: its evals, the change, its seconds."""
    for arm in ARMS:
        path = os.path.join(work, f"{arm}.json")
        if arm == "card_recipe_fp32":
            path = os.path.join(work, arm, "recipe_state.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            rec = json.load(f)
        if arm == "card_recipe_fp32":
            errs = [e["avg_joint_error"] for e in rec["trajectory"]]
            print(f"{arm} ({rec['samples']} hands, {rec['steps']} steps): "
                  + " -> ".join(f"{e:.4f}" for e in errs) + f" mm; {rec['train_secs']:.0f} train s")
            continue
        errs = _evals(rec)
        print(f"{arm} ({rec.get('backend')}, {rec['iters_per_epoch']} iterations an epoch, "
              f"{rec['steps']} steps): "
              + " -> ".join(f"{e['mm']:.4f}@{e['step']}" for e in rec["evals"])
              + f" mm; change {errs[-1] - errs[0]:+.4f}, best {min(errs[1:]) - errs[0]:+.4f}; "
              f"{rec['secs']:.0f} s")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--work", required=True, help="directory for the hands and the records")
    parser.add_argument("--arm", choices=("write",) + ARMS)
    parser.add_argument("--report", action="store_true")
    parser.add_argument("--artifact", help="with --report: write the companion arms' record here")
    parser.add_argument("--full", help="with --artifact: the seed-1 companion run's directory "
                                       "(card_records.sh recipe GUARD_S FROM 1)")
    args = parser.parse_args(argv)
    if args.report:
        report(args.work)
        if args.artifact:
            print(json.dumps(artifact(args.work, args.artifact, args.full)["conclusion"]))
    elif args.arm == "write":
        write(args.work)
    elif args.arm == "card_recipe_fp32":
        recipe_fp32(args.work)
    elif args.arm in RECIPE_ARMS:
        recipe_arm(args.arm, args.work)
    elif args.arm:
        _write_json(os.path.join(args.work, f"{args.arm}.json"), run_arm(args.arm, args.work))
    else:
        parser.error("give --arm or --report")


if __name__ == "__main__":
    main()
