"""Pole pixels in pseudo-NYU and what they do to the self-supervision gain.

The rasterizers of both packages interpolate 1/z across a face (the
reference CUDA rule, ``render.raster``), and the hand crop is centred at
z = 0: a face whose vertices straddle it has a line of 1/z = 0 inside it,
and a sample near that line reads a depth of -1e4 to -1e6 mm, a "pole
pixel". A sample holding one has a mutual-projection loss up to 1e9 (the
squared gap to the projected spheres), whose gradient inflates Adam's second
moments for hundreds of steps.

For one data draw (``--seed``, the selfsup demo's layout under ``--out``):
writes the split unless present, prints the lowest per-sample depths, holds
``combined_grads`` on the ``--drop`` lowest samples on the device against
the CPU (TF32 off, no resize-crop), then writes the split without them
under ``<out>_drop<K>`` and runs ``selfsup_demo`` there. One JSON line.

The command line runs with deterministic algorithms (``utils.determinism``).

Usage: python -m spherehand_torch.tools.pole_study [--seed 0] [--drop 6]
       [--out runs/selfsup_demo] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np
import torch

from spherehand_torch.convert import train_state_from_params
from spherehand_torch.data.nyu import NyuDataset, write_shard
from spherehand_torch.data.pseudo_real import generate_pseudo_nyu
from spherehand_torch.device import resolve_device
from spherehand_torch.hand.assets import load_hand_model
from spherehand_torch.infer import float32_precision, load_params_npz
from spherehand_torch.tools import selfsup_demo
from spherehand_torch.train.config import EngineConfig
from spherehand_torch.train.steps import RealBatch, build_steps
from spherehand_torch.utils import determinism


def lowest_depths(split_dir: str) -> np.ndarray:
    """(N,) the lowest depth (mm) of each sample of a split, over its views."""
    data = NyuDataset(split_dir)
    dms = data.gather_dms(np.arange(len(data)))
    return dms.reshape(len(dms), -1).min(axis=1)


def drop_lowest(src_dir: str, dst_dir: str, k: int) -> np.ndarray:
    """Write ``src_dir``'s split without its ``k`` lowest samples as the shard
    ``mv_data_0`` of ``dst_dir``; returns the dropped indices, lowest first."""
    dropped = np.argsort(lowest_depths(src_dir), kind="stable")[:k]
    data = NyuDataset(src_dir)
    dms, joints, poses, _ = data.gather(np.setdiff1d(np.arange(len(data)), dropped))
    os.makedirs(dst_dir, exist_ok=True)
    write_shard(dst_dir, "mv_data_0", dms, joints, poses)
    return dropped


def grads_against_cpu(split_dir: str, indices: np.ndarray, device: torch.device) -> dict:
    """``combined_grads`` from the shipped weights on ``indices`` (4 synthetic
    rows, the same CPU-drawn draws, TF32 off, no resize-crop) on ``device``
    and on the CPU: both losses and the largest relative gap of a tensor's
    gradient norm."""
    raw = NyuDataset(split_dir).gather(np.asarray(indices))
    params = load_params_npz(selfsup_demo.PRETRAINED)
    runs = {}
    for dev in (device, torch.device("cpu")):
        steps = build_steps(EngineConfig(synt_batch=4, real_batch=len(indices)),
                            load_hand_model(device=dev))
        state = train_state_from_params(steps.init_state, params)
        draws = steps.draw(torch.Generator().manual_seed(0)).to(dev)
        batch = RealBatch(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in raw))
        with float32_precision("highest"):
            loss, _, grads = steps.combined_grads(state, draws, batch, True, real_aug=False)
        runs[dev.type] = (float(loss), {k: float(g.norm()) for k, g in grads.items()})
    (loss_d, norms_d), (loss_c, norms_c) = runs[device.type], runs["cpu"]
    gap = max(abs(norms_d[k] - norms_c[k]) / max(norms_c[k], 1e-30) for k in norms_c)
    return {"loss_device": loss_d, "loss_cpu": loss_c, "grad_norm_max_rel_gap": gap}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--drop", type=int, default=6)
    ap.add_argument("--out", default=os.path.join("runs", "selfsup_demo"))
    ap.add_argument("--device", default="cuda", help="torch device (cpu: the plain path)")
    args = ap.parse_args(argv)
    determinism.enable()
    dev = resolve_device(args.device)
    data = os.path.join(args.out, "data")
    if not os.path.exists(os.path.join(data, "test", "mv_data_0_shape.pkl")):
        generate_pseudo_nyu(os.path.join(data, "train"), 4096, args.seed, dev)
        generate_pseudo_nyu(os.path.join(data, "test"), 512,
                            args.seed + selfsup_demo.TEST_SEED_OFFSET, dev)
    train = os.path.join(data, "train")
    low = lowest_depths(train)
    order = np.argsort(low, kind="stable")
    record = {"seed": args.seed, "samples": len(low),
              "lowest_mm": [[int(i), float(low[i])] for i in order[:10]],
              "samples_below_-150mm": int((low < -150).sum()),
              "samples_below_-1e4mm": int((low < -1e4).sum())}
    if dev.type != "cpu":
        record["grads_on_dropped"] = grads_against_cpu(train, order[:args.drop], dev)
    out = f"{args.out}_drop{args.drop}"
    drop_lowest(train, os.path.join(out, "data", "train"), args.drop)
    shutil.copytree(os.path.join(data, "test"), os.path.join(out, "data", "test"),
                    dirs_exist_ok=True)
    result = selfsup_demo.run(out=out, samples=len(low) - args.drop, seed=args.seed, device=dev)
    record["without_lowest"] = {k: result[k] for k in
                                ("samples", "steps", "before_mm", "after_mm", "before_raw_mm",
                                 "after_raw_mm", "train_secs", "backend")}
    print(json.dumps(record))


if __name__ == "__main__":
    main()
