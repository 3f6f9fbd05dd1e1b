"""What drives the stock recipe's divergence: per-term gradients, the lr
boundary, the term ablations and the is_mv curriculum.

Counterpart of the JAX package's ``tools/divergence_study.py``, with its
flags, defaults, probe names and record keys. Each probe starts a fresh
engine from the shipped synthetic pretraining on the same pseudo-NYU data
as the recipe run (``reference_recipe``), with no checkpoints:

  A ``stock_instrumented``  the stock run (lr 1e-3) driven step by step:
                   ``combined_term_diag`` (each term's value, gradient norm
                   and cosine with the total; the update and parameter
                   norms) every ``--diag_every`` steps on the step's own
                   state, draws, batch and is_mv, and an eval every
                   ``--eval_every_steps`` steps inside the epoch;
  B ``lr_<X>``     the lr between the stable 3e-5 and the stock 1e-3;
  C ``no_<term>``  mv_projection, mv_consistency, prior, collision or
                   bone_length off, at the stock lr;
  D ``mv_always`` / ``mv_never``  the is_mv window pinned on / off.

The evals run in float32 with TF32 off (``eval_precision="highest"``). The
device-resident splits are the same for every probe, so they are uploaded
once a process and handed to each fresh engine (``device_data``).

Writes ``<out>/study.json`` (every trajectory and diag record; a probe
already in it is not run again) and, with ``--artifact``, the distilled
record ``tests/goldens/torch_divergence_study.json`` (or the path given;
never a JAX record: ``tools.refuse_golden``). The probes are independent,
so they may run in separate processes sharing the card, each with its own
``--out`` and ``--skip``; ``--merge`` then joins their ``study.json``
files into ``--out`` before the conclusions are drawn. Each probe records
the port's kernel launch counters over it (``launches``), and the run
prints their sum as a JSON line. The process runs with deterministic
algorithms (``utils.determinism``).

Usage: python -m spherehand_torch.tools.divergence_study [--data runs/reference_recipe/data]
       [--epochs 3] [--stock_epochs 2] [--skip a,b] [--out runs/divergence_study]
       [--merge DIR ...] [--artifact [PATH]] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from spherehand_torch.convert import train_state_from_params
from spherehand_torch.device import resolve_device
from spherehand_torch.infer import load_params_npz
from spherehand_torch.tools import GOLDENS, launch_counts, launches_since, refuse_golden
from spherehand_torch.tools.reference_recipe import make_data
from spherehand_torch.tools.selfsup_demo import PRETRAINED, backend
from spherehand_torch.train.config import EngineConfig
from spherehand_torch.train.engine import Engine
from spherehand_torch.utils import determinism

STOCK_LR = 1e-3  # run_engine.py:23
ARTIFACT = os.path.join(GOLDENS, "torch_divergence_study.json")
TERMS = ("mv_projection", "mv_consistency", "prior", "collision", "bone_length")

# The device-resident splits, by train flag: the same for every probe of a
# process, uploaded once and handed to each fresh engine.
_RESIDENT_CACHE: dict = {}


def _fresh_engine(base_cfg: EngineConfig, device: torch.device, **overrides) -> Engine:
    engine = Engine(dataclasses.replace(base_cfg, **overrides), device=device)
    engine.state = train_state_from_params(engine.steps.init_state, load_params_npz(PRETRAINED))
    engine._resident_data.update(_RESIDENT_CACHE)
    for train in (True, False):
        _RESIDENT_CACHE.setdefault(train, engine._resident(train))
    return engine


def _eval_mm(engine: Engine, epoch: int) -> float:
    return round(float(engine._epoch_real_eval(max(epoch, 0))["avg_joint_error"]), 4)


def run_standard_probe(base_cfg: EngineConfig, name: str, epochs: int, device: torch.device,
                       **overrides) -> dict:
    """Probes B-D: ``epochs`` combined epochs of the engine, an eval before
    and after each."""
    t0 = time.time()
    before = launch_counts()
    engine = _fresh_engine(base_cfg, device, **overrides)
    traj = [{"epoch": -1, "mm": _eval_mm(engine, -1)}]
    for epoch in range(epochs):
        engine._epoch_combined(epoch)
        traj.append({"epoch": epoch, "mm": _eval_mm(engine, epoch)})
    probe = {"name": name, "overrides": {k: v for k, v in overrides.items() if k != "tag"},
             "trajectory": traj, "secs": round(time.time() - t0, 1),
             "launches": launches_since(before)}
    print(f"[study] {name}: " + " -> ".join(f"{p['mm']:.1f}" for p in traj)
          + f" mm ({probe['secs']:.0f}s)", flush=True)
    return probe


def run_instrumented_stock(base_cfg: EngineConfig, epochs: int, diag_every: int,
                           eval_every_steps: int, device: torch.device) -> dict:
    """Probe A: the stock run with per-term gradient attribution, driven a
    step at a time through the engine's own step (its draws, lr and is_mv),
    with ``combined_term_diag`` on the same inputs before every
    ``diag_every``-th step and evals inside the epoch."""
    t0 = time.time()
    before = launch_counts()
    engine = _fresh_engine(base_cfg, device, lr=STOCK_LR, tag="divstudy_stock_")
    cfg = engine.cfg
    if engine._resident(True) is None:
        raise RuntimeError("the study needs the device-resident split (device_data)")
    traj = [{"epoch": -1, "it": 0, "step": 0, "mm": _eval_mm(engine, -1)}]
    print(f"[study] stock before: {traj[0]['mm']:.2f} mm", flush=True)
    diag_records: list[dict] = []
    for epoch in range(epochs):
        for it, (_, batch) in enumerate(engine.batches(True, cfg.real_batch, epoch)):
            if it % diag_every == 0:
                diag = engine.steps.combined_term_diag(
                    engine.state, engine.step_draws(epoch, it), batch,
                    it < cfg.mv_curriculum_iters)
                keys = list(diag)
                values = torch.stack([diag[k].detach().float().reshape(()) for k in keys])
                diag_records.append({"epoch": epoch, "it": it,
                                     **dict(zip(keys, values.cpu().tolist()))})
            if eval_every_steps and it and it % eval_every_steps == 0:
                mm = _eval_mm(engine, epoch)
                traj.append({"epoch": epoch, "it": it, "step": int(engine.state.step), "mm": mm})
                print(f"[study] stock {epoch}-{it}: {mm:.2f} mm", flush=True)
            engine.combined_step(epoch, it, batch)
        mm = _eval_mm(engine, epoch)
        traj.append({"epoch": epoch, "it": -1, "step": int(engine.state.step), "mm": mm})
        print(f"[study] stock epoch {epoch} done: {mm:.2f} mm", flush=True)
    return {"name": "stock_instrumented", "lr": STOCK_LR, "trajectory": traj,
            "diag": diag_records, "secs": round(time.time() - t0, 1),
            "launches": launches_since(before)}


def summarize_diag(diag_records: list[dict]) -> dict:
    """Per-term medians and maxima of the gradient norm, its share of the
    total, the value and the cosine with the total."""
    if not diag_records:
        return {}
    terms = sorted({k.split("/")[0] for k in diag_records[0] if k.endswith("/value")})
    total = np.asarray([r["total_grad_norm"] for r in diag_records])
    out = {"total_grad_norm": {"median": float(np.median(total)), "max": float(total.max())}}
    for t in terms:
        g = np.asarray([r[f"{t}/grad_norm"] for r in diag_records])
        v = np.asarray([r[f"{t}/value"] for r in diag_records])
        c = np.asarray([r[f"{t}/cos_total"] for r in diag_records])
        out[t] = {
            "grad_norm_median": float(np.median(g)),
            "grad_norm_max": float(g.max()),
            "share_of_total_median": float(np.median(g / total)),
            "value_median": float(np.median(v)),
            "value_max": float(v.max()),
            "cos_total_median": float(np.median(c)),
        }
    return out


def collapse_row(study: dict, name: str, margin: float = 5.0) -> dict | None:
    """A probe's first and last eval, its trajectory, and whether it ended
    more than ``margin`` mm above where it started."""
    probe = study["probes"].get(name)
    if not probe:
        return None
    t = [e["mm"] for e in probe["trajectory"]]
    if not t:
        return None
    return {"before_mm": t[0], "final_mm": t[-1], "trajectory_mm": t,
            "collapsed": bool(t[-1] > t[0] + margin)}


def probe_names(lrs: str = "3e-4,1e-4") -> list[str]:
    """The study's probes, in the order it runs them."""
    return ["stock_instrumented", *(f"lr_{lr}" for lr in filter(None, lrs.split(","))),
            *(f"no_{term}" for term in TERMS), "mv_always", "mv_never"]


def _write_json(path: str, blob: dict) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(blob, f, indent=1)
    os.replace(path + ".tmp", path)


def run(data: str = os.path.join("runs", "reference_recipe", "data"), samples: int = 72_192,
        test: int = 2048, epochs: int = 3, stock_epochs: int = 2, diag_every: int = 50,
        eval_every_steps: int = 500, lrs: str = "3e-4,1e-4", skip: str = "",
        out: str = os.path.join("runs", "divergence_study"), seed: int = 0,
        merge: list[str] | None = None, artifact: str | None = None,
        device: torch.device | str | None = None, engine_overrides: dict | None = None) -> dict:
    """The study (the probes not yet in ``<out>/study.json`` and not in
    ``skip``); returns the study with its conclusions. ``engine_overrides``:
    ``EngineConfig`` fields to change (e.g. batch sizes for a small run)."""
    if artifact:
        refuse_golden(artifact)
    dev = resolve_device(device)
    make_data(data, samples, test, seed, dev)
    os.makedirs(out, exist_ok=True)
    base_cfg = dataclasses.replace(EngineConfig(
        mode="Train", model_dir=os.path.join(out, "runs"), dataset_dir=data,
        epoch=75,  # keeps lr_at_epoch the recipe run's schedule
        num_stacks=1, lr=STOCK_LR, eval_precision="highest", seed=seed, tag="divstudy_",
    ), **(engine_overrides or {}))
    skipped = set(filter(None, skip.split(",")))
    state_path = os.path.join(out, "study.json")
    study = {"probes": {}}
    if os.path.exists(state_path):
        with open(state_path) as f:
            study = json.load(f)
    for other in merge or ():
        with open(os.path.join(other, "study.json")) as f:
            for name, probe in json.load(f)["probes"].items():
                study["probes"].setdefault(name, probe)
    study["backend"] = backend(dev)
    study["data"] = {"samples": samples, "test": test, "root": data}

    def record(probe: dict) -> None:
        study["probes"][probe["name"]] = probe
        _write_json(state_path, study)

    def todo(name: str) -> bool:
        return name not in study["probes"] and name not in skipped

    if todo("stock_instrumented"):
        record(run_instrumented_stock(base_cfg, stock_epochs, diag_every, eval_every_steps, dev))
    for lr_s in filter(None, lrs.split(",")):
        if todo(f"lr_{lr_s}"):
            record(run_standard_probe(base_cfg, f"lr_{lr_s}", epochs, dev, lr=float(lr_s),
                                      tag=f"divstudy_{lr_s}_"))
    for term in TERMS:
        if todo(f"no_{term}"):
            record(run_standard_probe(base_cfg, f"no_{term}", epochs, dev, **{term: False},
                                      tag=f"divstudy_no{term}_"))
    for name, iters in (("mv_always", 10**9), ("mv_never", 0)):
        if todo(name):
            record(run_standard_probe(base_cfg, name, epochs, dev, mv_curriculum_iters=iters,
                                      tag=f"divstudy_{name}_"))

    stock = study["probes"].get("stock_instrumented", {})
    diag_summary = summarize_diag(stock.get("diag", []))
    collapse = {n: collapse_row(study, n) for n in sorted(study["probes"])}
    launches: dict[str, int] = {}
    for probe in study["probes"].values():
        for k, n in probe.get("launches", {}).items():
            launches[k] = launches.get(k, 0) + n
    study["conclusions"] = {"collapse": collapse, "diag_summary": diag_summary}
    _write_json(state_path, study)
    print(f"[study] wrote {state_path}")
    print(json.dumps(collapse, indent=1))
    print(json.dumps({"backend": study["backend"], "launches": launches}), flush=True)
    if artifact:
        golden = {
            "backend": study["backend"],
            "data": study["data"],
            "stock_lr": STOCK_LR,
            "collapse": collapse,
            "diag_summary": diag_summary,
            "stock_trajectory": stock.get("trajectory", []),
            "launches": launches,
            "provenance": "spherehand_torch/tools/divergence_study.py",
        }
        _write_json(artifact, golden)
        print(f"[study] wrote {artifact}")
    return study


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=os.path.join("runs", "reference_recipe", "data"),
                    help="pseudo-NYU root with train/ and test/ shards (the recipe run's; "
                         "written if missing)")
    ap.add_argument("--samples", type=int, default=72_192)
    ap.add_argument("--test", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=3, help="epochs a standard probe")
    ap.add_argument("--stock_epochs", type=int, default=2)
    ap.add_argument("--diag_every", type=int, default=50)
    ap.add_argument("--eval_every_steps", type=int, default=500,
                    help="eval cadence inside the instrumented probe's epochs")
    ap.add_argument("--lrs", default="3e-4,1e-4",
                    help="lr probes between 3e-5 (stable) and 1e-3 (stock)")
    ap.add_argument("--skip", default="", help="comma list of probe names to skip")
    ap.add_argument("--out", default=os.path.join("runs", "divergence_study"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--merge", nargs="+", metavar="DIR",
                    help="join the probes of these runs' study.json into --out's first")
    ap.add_argument("--artifact", nargs="?", const=ARTIFACT, default=None,
                    help="write the distilled record (default path "
                         "tests/goldens/torch_divergence_study.json; never a JAX record)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu: the plain path)")
    args = ap.parse_args(argv)
    if args.artifact:
        try:
            refuse_golden(args.artifact)
        except ValueError as exc:
            raise SystemExit(str(exc)) from None
    determinism.enable()
    run(**vars(args))


if __name__ == "__main__":
    main()
