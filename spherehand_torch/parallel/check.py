"""N data-parallel ranks held against one device, on the same inputs.

Each rank of a group runs the step functions on its block of one seeded
batch (the real batch of ``tests/test_parallel.py``'s ``_fake_batch``:
a 16 x 16 blob of random depth in each view, identity cameras) and saves
what it computed; :func:`reference` computes the same on
one device without a group (the batch unpadded); :func:`compare` holds the
two to each other. The checks, by name:

- ``grads``: ``combined_grads`` at ``real_aug=False`` (loss, terms and the
  summed gradients), on the rank's synthetic rows rendered once;
- ``steps``: two ``combined_step`` calls (resize-crop on); the parameters
  after them (bit-identical across ranks);
- ``eval``: ``eval_step``'s metrics and the denoised joints, gathered to
  rank 0 in the global order with the pad rows dropped;
- ``synt``: a ``synt_step`` at ``synt_batch`` 5 (padded on 2 ranks);
- ``diag``: ``combined_term_diag``'s values and norms on the same inputs;
- ``temporal``: ``combined_grads`` with the temporal term on (4 real
  samples, 2 a rank, a carried previous skeleton): each rank's first row
  follows the rank before it;
- ``identity`` (one rank): the group's ``combined_grads`` against the same
  call without a group in the same process: loss and terms equal bit for
  bit, the group's sum of the ungrouped gradients equal to them bit for
  bit, and the gradients' gap (of each tensor's largest entry) beside a
  second ungrouped backward's (the device's run-to-run spread; CUDA's bilinear upsample adds its backward
  with atomics);
- ``timing`` (on the card): the median CUDA-event time of a combined step
  at the reference widths (48 + 25 x 3, TF32 at PyTorch's defaults) and,
  under a group, of the gradient sum alone.

Every rank initialises from the same CPU generator (``init_state``
broadcasts rank 0's parameters and checks the rest) and draws the whole
batch's draws from the same seeds.

Run one rank: ``python -m spherehand_torch.parallel.check --rank R --world N
--init file:///tmp/x/rdzv --out DIR [--device cpu|cuda] [--backend gloo]
[--synt_batch 8] [--mesh full]``;
:func:`launch` starts N such processes and waits for them with a timeout.
Without ``--rank`` the command does all of it: ``python -m
spherehand_torch.parallel.check --world 4`` launches 4 ranks (one card
each: NCCL), computes the one-device reference, holds the ranks to it
(on the card each term against the loss, at ``CARD_LOSS_RTOL``) and
prints one JSON line of the worst gaps and the timings.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

from spherehand_torch.parallel.mesh import RankGroup, form_group, leave_group

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHECKS = ("grads", "steps", "eval", "synt", "diag", "temporal")
REAL_SAMPLES = 3   # 3 x 3 real rows: padded to 4 over 2 ranks
SYNT_BATCH = 8
SYNT_PADDED_BATCH = 5  # the synt check: one pad row over 2 ranks
EVAL_SAMPLES = 3
RUN_TIMEOUT_S = 900.0
TIMING_WARMUP = 3
TIMING_STEPS = 10
TEMPORAL_SAMPLES = 4  # divisible by 2 ranks: --temporal admits no padding
SEED = 100
LR = 1e-3
# Two ranks against one (tests/test_parallel.py:103-182): the loss and
# terms relative; gradients against their
# tensor's largest entry; eval metrics relative and joints in mm; the
# term-diag values and norms relative.
LOSS_RTOL = 1e-6
CARD_LOSS_RTOL = 1e-5  # cuDNN rounds a row by batch size
GRAD_SCALE_TOL = 5e-3
EVAL_RTOL = 2e-4
JOINTS_ATOL = 1e-4
DIAG_RTOL = 1e-5


def config(synt_batch: int = SYNT_BATCH, mesh: str = "full"):
    from spherehand_torch.train.config import EngineConfig

    return EngineConfig(synt_batch=synt_batch, real_batch=REAL_SAMPLES, num_stacks=1,
                        eval_batch=EVAL_SAMPLES, eval_precision="highest", mesh=mesh)


def real_batch(device, samples: int, seed: int):
    """``tests/test_parallel.py``'s ``_fake_batch`` (a ``RealBatch``,
    unpadded) from ``numpy.random.RandomState(seed)``."""
    from spherehand_torch.train.steps import RealBatch

    rng = np.random.RandomState(seed)
    dms = np.full((samples, 3, 64, 64), 100.0, np.float32)
    dms[:, :, 24:40, 24:40] = rng.uniform(20, 60, (samples, 3, 16, 16))
    joints = rng.uniform(-80, 80, (samples, 3, 36, 3)).astype(np.float32)
    eye = np.tile(np.eye(4, dtype=np.float32), (samples, 3, 1, 1))
    return RealBatch(*(torch.as_tensor(a, device=device) for a in (dms, joints, eye, eye)))


def rank_batch(batch, group: RankGroup | None):
    """``group``'s rank's block of ``batch`` (padded at weight 0), with the
    global total; ``batch`` itself without a group."""
    if group is None:
        return batch
    rows = group.rows(batch.dms.shape[0])
    idx = torch.as_tensor(rows.index, device=batch.dms.device)
    weights = None if rows.weights is None else torch.as_tensor(rows.weights,
                                                                device=batch.dms.device)
    return type(batch)(*(x[idx] for x in batch[:4]), weights, rows.total)


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def run_checks(device, group: RankGroup | None = None, checks=CHECKS, hand=None,
               synt_batch: int = SYNT_BATCH, mesh: str = "full") -> dict:
    """The named checks on ``device`` (as ``group``'s rank, or alone), TF32
    off: a flat dict of numpy arrays."""
    from spherehand_torch.infer import float32_precision

    device = torch.device(device)
    with float32_precision("highest"):
        out = _run_checks(device, group, checks, hand, config(synt_batch, mesh))
    if "timing" in checks:
        out.update(_timing(device, group, hand))
    return out


def _timing(device, group, hand) -> dict:
    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.steps import build_steps

    cfg = EngineConfig(num_stacks=1)
    hand = load_hand_model(device=device) if hand is None else hand
    fns = build_steps(cfg, hand, group=group)
    state = fns.init_state(torch.Generator().manual_seed(0))
    batch = rank_batch(real_batch(device, cfg.real_batch, SEED), group)
    gen = torch.Generator(device=device).manual_seed(60)

    def median_ms(fn, reps: int) -> float:
        times = []
        for i in range(TIMING_WARMUP + reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            if i >= TIMING_WARMUP:
                times.append(start.elapsed_time(end))
        return float(np.median(times))

    def step():
        fns.combined_step(state, LR, fns.draw(gen), batch, True)

    out = {"timing/step_ms": np.float64(median_ms(step, TIMING_STEPS))}
    if group is not None:
        params = list(state.network.parameters())
        out["timing/allreduce_ms"] = np.float64(median_ms(lambda: group.sum_grads(params),
                                                          TIMING_STEPS))
    return out


def _run_checks(device, group, checks, hand, cfg) -> dict:
    from spherehand_torch.data.synthesizer import synthesize_from_draws
    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.train.steps import build_steps

    if hand is None:
        hand = load_hand_model(device=device, lite=cfg.mesh == "lite")
    fns = build_steps(cfg, hand, group=group)
    batch = rank_batch(real_batch(device, REAL_SAMPLES, SEED), group)
    out: dict[str, np.ndarray] = {}

    def fresh():
        return fns.init_state(torch.Generator().manual_seed(0))

    def draws(seed: int, **kw):
        return fns.draw(torch.Generator(device=device).manual_seed(seed), **kw)

    shared = draws(7)
    if "grads" in checks or "diag" in checks:
        synt = synthesize_from_draws(hand, shared.poses, shared.synthesis, add_noise=True)
    if "grads" in checks:
        loss, terms, grads = fns.combined_grads(fresh(), shared, batch, True, real_aug=False,
                                                synt=synt)
        out["grads/loss"] = _host(loss)
        out.update({f"grads/term/{k}": _host(v) for k, v in terms.items()})
        out.update({f"grads/grad/{k}": _host(g) for k, g in grads.items()})
    if "steps" in checks:
        state = fresh()
        for i in range(2):
            state, metrics, _ = fns.combined_step(state, LR, draws(20 + i), batch, i == 0)
            out[f"steps/loss{i}"] = _host(metrics["loss"])
        out.update({f"steps/param/{k}": _host(p) for k, p in state.network.named_parameters()})
    if "eval" in checks:
        ev = rank_batch(real_batch(device, EVAL_SAMPLES, SEED + 1), group)
        metrics, denoised = fns.eval_step(fresh(), draws(30, synt=False,
                                                         real_rows=EVAL_SAMPLES * 3), ev)
        out.update({f"eval/metric/{k}": _host(v) for k, v in metrics.items()})
        joints = _host(denoised)
        if group is not None:
            parts = group.gather_objects(joints)
            joints = None if parts is None else np.concatenate(parts)[:EVAL_SAMPLES]
        if joints is not None:
            out["eval/joints"] = joints
    if "synt" in checks:
        synt_fns = build_steps(dataclasses.replace(cfg, synt_batch=SYNT_PADDED_BATCH), hand,
                               group=group)
        state = synt_fns.init_state(torch.Generator().manual_seed(0))
        _, metrics = synt_fns.synt_step(
            state, LR, synt_fns.draw(torch.Generator(device=device).manual_seed(40),
                                     real=False))
        out.update({f"synt/metric/{k}": _host(v) for k, v in metrics.items()})
    if "diag" in checks:
        diag = fns.combined_term_diag(fresh(), shared, batch, True, real_aug=False, synt=synt)
        out.update({f"diag/{k}": _host(v) for k, v in diag.items()})
    if "identity" in checks:
        out.update(_identity(group, fns, build_steps(cfg, hand), fresh, shared, batch))
    if "temporal" in checks:
        t_fns = build_steps(dataclasses.replace(cfg, temporal=True, real_batch=TEMPORAL_SAMPLES),
                            hand, group=group)
        state = t_fns.init_state(torch.Generator().manual_seed(0))
        state.prev_skel = torch.full_like(state.prev_skel, 5.0)
        state.has_prev = torch.ones_like(state.has_prev)
        t_batch = rank_batch(real_batch(device, TEMPORAL_SAMPLES, SEED + 2), group)
        loss, terms, grads = t_fns.combined_grads(
            state, t_fns.draw(torch.Generator(device=device).manual_seed(50)), t_batch, True,
            real_aug=False)
        out["temporal/loss"] = _host(loss)
        out.update({f"temporal/term/{k}": _host(v) for k, v in terms.items()})
        out.update({f"temporal/grad/{k}": _host(g) for k, g in grads.items()})
    return out


def _identity(group, grouped, alone, fresh, draws, batch) -> dict:
    def grads_of(fns):
        loss, terms, grads = fns.combined_grads(fresh(), draws, batch, True, real_aug=False)
        return [loss, *terms.values()], [g.clone() for g in grads.values()]

    values, grads = grads_of(grouped)
    ref_values, ref_grads = grads_of(alone)
    _, again = grads_of(alone)
    grouped_sum = group.sum_tensors([g.clone() for g in ref_grads])
    if not all(torch.equal(a, b) for a, b in zip(values, ref_values)):
        raise AssertionError("the group's loss or terms differ from the ungrouped call's")
    if not all(torch.equal(a, b) for a, b in zip(grouped_sum, ref_grads)):
        raise AssertionError("the group's gradient sum changed the gradients")

    def gap(xs, ys):  # against each tensor's largest entry
        return max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                   for x, y in zip(xs, ys))

    return {"identity/grad_gap": np.float64(gap(grads, ref_grads)),
            "identity/spread": np.float64(gap(again, ref_grads))}


def reference(device, checks=CHECKS, hand=None, synt_batch: int = SYNT_BATCH,
              mesh: str = "full") -> dict:
    """:func:`run_checks` on one device, without a group."""
    return run_checks(device, None, checks, hand, synt_batch, mesh)


def compare(ranks: list[dict], ref: dict, loss_rtol: float = LOSS_RTOL,
            terms_against_loss: bool = False) -> dict[str, float]:
    """Hold every rank's results to the one-device ``ref`` (the limits
    above; ``loss_rtol`` for the loss and for each term, relative to
    itself or, with ``terms_against_loss``, to the loss it sums into) and
    the ranks' parameters to each other bit for bit; the worst gap of each
    kind. Raises ``AssertionError`` on a failure."""
    worst = {"loss_rel": 0.0, "term_rel": 0.0, "grad_scale": 0.0, "eval_rel": 0.0, "joints_mm": 0.0,
             "diag_rel": 0.0, "param_ranks_max_abs": 0.0}

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))

    def hold(kind, key, value, limit):
        worst[kind] = max(worst[kind], value)
        if not value <= limit:
            raise AssertionError(f"{key}: {kind} {value:.3g} > {limit:g}")

    for r, got in enumerate(ranks):
        for key, b in ref.items():
            if key == "eval/joints" and r > 0:
                continue
            a = got[key]
            if key.startswith(("grads/grad/", "temporal/grad/")):
                hold("grad_scale", key, float(np.max(np.abs(a - b)))
                     / max(float(np.max(np.abs(b))), 1e-30), GRAD_SCALE_TOL)
            elif key.startswith(("grads/term/", "temporal/term/")):
                scale = (abs(float(ref[key.split("/")[0] + "/loss"])) if terms_against_loss
                         else max(abs(float(b)), 1e-30))
                hold("term_rel", key, float(np.max(np.abs(a - b))) / scale, loss_rtol)
            elif key.startswith(("grads/loss", "synt/metric/", "steps/loss0", "temporal/loss")):
                hold("loss_rel", key, rel(a, b), loss_rtol)
            elif key.startswith("eval/metric/"):
                hold("eval_rel", key, rel(a, b), EVAL_RTOL)
            elif key == "eval/joints":
                hold("joints_mm", key, float(np.max(np.abs(a - b))), JOINTS_ATOL)
            elif key.startswith("diag/"):
                hold("diag_rel", key, rel(a, b), DIAG_RTOL)
    params = [k for k in ref if k.startswith("steps/param/")]
    for got in ranks[1:]:
        for key in params:
            hold("param_ranks_max_abs", key,
                 0.0 if np.array_equal(got[key], ranks[0][key]) else float("inf"), 0.0)
    return worst


def launch(world: int, out_dir: str, device: str = "cpu", checks=CHECKS,
           timeout_s: float = 300.0, backend: str | None = None,
           synt_batch: int = SYNT_BATCH, mesh: str = "full") -> list[dict]:
    """Run the checks as ``world`` ranks, one process each, rendezvous in
    ``out_dir``; every rank's results, in rank order. A rank that fails or
    outlasts ``timeout_s`` fails the launch (the rest are killed)."""
    init = "file://" + os.path.join(os.path.abspath(out_dir), "rendezvous")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "spherehand_torch.parallel.check", "--rank", str(r),
         "--world", str(world), "--init", init, "--out", out_dir, "--device", device,
         "--checks", ",".join(checks), "--synt_batch", str(synt_batch), "--mesh", mesh]
        + (["--backend", backend] if backend else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout_s)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks failed: {failed}")
    results = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            results.append({k: f[k] for k in f.files})
    return results


def _launch_and_compare(args, checks) -> int:
    """Every rank, the one-device reference and the comparison."""
    import json
    import tempfile

    with tempfile.TemporaryDirectory(prefix="spherehand_ranks_") as tmp:
        ranks = launch(args.world, tmp, args.device, checks, timeout_s=RUN_TIMEOUT_S,
                       backend=args.backend, synt_batch=args.synt_batch, mesh=args.mesh)
    on_card = torch.device(args.device).type == "cuda"
    ref = reference(args.device, checks, synt_batch=args.synt_batch, mesh=args.mesh)
    worst = compare(ranks, ref, CARD_LOSS_RTOL if on_card else LOSS_RTOL,
                    terms_against_loss=on_card)
    timing = {f"rank{r}": {k.split("/")[1]: float(v) for k, v in got.items()
                           if k.startswith("timing/")} for r, got in enumerate(ranks)}
    if "timing/step_ms" in ref:
        timing["one device"] = float(ref["timing/step_ms"])
    print(json.dumps({"world": args.world, "device": args.device, "checks": list(checks),
                      "worst": worst, "timing_ms": timing}))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, default=None,
                    help="this process's rank (without it: launch --world ranks and compare)")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", help="the group's init method (file://...), with --rank")
    ap.add_argument("--out", help="directory for rank<R>.npz, with --rank")
    ap.add_argument("--device", default="cuda", help="cuda (the rank's card) or cpu")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: by topology)")
    ap.add_argument("--checks", default=",".join(CHECKS))
    ap.add_argument("--timeout", type=float, default=60.0, help="the group's timeout, s")
    ap.add_argument("--synt_batch", type=int, default=SYNT_BATCH)
    ap.add_argument("--mesh", default="full", choices=["full", "lite"])
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    checks = tuple(args.checks.split(","))
    if args.rank is None:
        return _launch_and_compare(args, checks)
    if args.init is None or args.out is None:
        ap.error("--rank needs --init and --out")
    group = form_group(args.rank, args.world, torch.device(args.device).type, args.init,
                       backend=args.backend, timeout_s=args.timeout)
    try:
        out = run_checks(group.device, group, checks, synt_batch=args.synt_batch,
                         mesh=args.mesh)
    finally:
        leave_group()
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **out)
    print(f"rank {args.rank}/{args.world} ({group.backend}, {group.device}): "
          f"{len(out)} results")
    return 0


if __name__ == "__main__":
    sys.exit(main())
