"""The NYU accuracy parity drill in one command: ``.pth`` or ``.npz`` ->
the 14-point eval error.

Counterpart of the JAX package's ``tools/parity_eval.py``, with the same
flow, outputs and flags:

    python -m spherehand_torch.tools.parity_eval ckpt.pth /path/to/nyu_dataset \
        [--num_stacks 2] [--out runs/parity] [--batch_size 8] [--device cpu]

- a ``.pth`` is imported through ``tools.import_torch_checkpoint`` (into
  ``imported_params.npz`` in ``--out``); a flat ``.npz`` loads directly;
- the port's engine ``eval_step`` with ``eval_precision="highest"`` (TF32
  off) runs over ``NyuDataset`` / ``NyuLoader(shuffle=False)`` of the
  ``test/`` split (or a bare shard directory): view 0, last stack, palm
  denoiser, the 14-point average joint error;
- ``result.npz`` (gt, est), the offline evaluator's files, and
  ``parity.json`` {avg_joint_error_mm, offline_mean_error_mm, num_samples,
  checkpoint}.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from spherehand_torch.convert import train_state_from_params
from spherehand_torch.data.nyu import NyuDataset, NyuLoader
from spherehand_torch.device import resolve_device
from spherehand_torch.evaluation.offline import evaluate_result_file
from spherehand_torch.hand.assets import load_hand_model
from spherehand_torch.infer import load_params_npz
from spherehand_torch.tools.import_torch_checkpoint import import_checkpoint
from spherehand_torch.train.config import EngineConfig
from spherehand_torch.train.steps import NUM_VIEWS, RealBatch, build_steps


def run_parity_eval(ckpt: str, dataset_dir: str, num_stacks: int, out_dir: str,
                    batch_size: int = 8, device: torch.device | str | None = None) -> dict:
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    if ckpt.endswith(".npz"):
        params = load_params_npz(ckpt)
    else:
        params = import_checkpoint(ckpt, os.path.join(out_dir, "imported_params.npz"),
                                   num_stacks)

    cfg = EngineConfig(num_stacks=num_stacks, eval_precision="highest")
    steps = build_steps(cfg, load_hand_model(device=dev))
    state = train_state_from_params(steps.init_state, params)

    test_dir = os.path.join(dataset_dir, "test")
    if not os.path.isdir(test_dir):
        test_dir = dataset_dir  # a bare shard directory
    loader = NyuLoader(NyuDataset(test_dir), batch_size, shuffle=False, seed=0)

    gen = torch.Generator(device=dev)
    all_gt, all_est, errs, ns = [], [], [], []
    for it, raw in enumerate(loader):
        batch = RealBatch(*(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in raw))
        draws = steps.draw(gen.manual_seed(it), synt=False, real_rows=len(raw[0]) * NUM_VIEWS)
        metrics, denoised = steps.eval_step(state, draws, batch)
        all_gt.append(raw[1][:, 0])
        all_est.append(denoised.cpu().numpy())
        errs.append(float(metrics["avg_joint_error"]))
        ns.append(len(raw[0]))

    mean_err = float(np.average(errs, weights=ns))
    result_path = os.path.join(out_dir, "result.npz")
    np.savez_compressed(result_path, gt=np.concatenate(all_gt), est=np.concatenate(all_est))
    offline = evaluate_result_file(result_path, make_plot=False)
    summary = {
        "avg_joint_error_mm": round(mean_err, 4),
        "offline_mean_error_mm": round(offline["mean_error"], 4),
        "num_samples": int(np.sum(ns)),
        "checkpoint": ckpt,
    }
    with open(os.path.join(out_dir, "parity.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt", help=".pth torch checkpoint or flat .npz params")
    ap.add_argument("dataset_dir", help="NYU shard root (with test/) or shard dir")
    ap.add_argument("--num_stacks", type=int, default=2)
    ap.add_argument("--out", default=os.path.join("runs", "parity"))
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="torch device (cpu: the plain path)")
    args = ap.parse_args(argv)
    summary = run_parity_eval(args.ckpt, args.dataset_dir, args.num_stacks, args.out,
                              args.batch_size, args.device)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
