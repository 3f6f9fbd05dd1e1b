"""Held-out synthetic evaluation: render unseen poses, predict, score in mm.

Counterpart of the JAX package's ``tools/eval_synthetic.py``: sampler poses
from a seed space of their own (batch ``i`` from a generator seeded
``777_000 + i``; training seeds its steps ``1..N``), noisy renders
(``synthesize(add_noise=True)``), the estimator's last stack with TF32 off,
per-joint errors and the reference's max-error curve
(dataset/evaluation.py:69-79). Writes ``synthetic_eval.npz`` (errors,
thresholds, fractions) beside the checkpoint.

The command line runs with deterministic algorithms (``utils.determinism``).

Usage: python -m spherehand_torch.tools.eval_synthetic [checkpoint=runs/synthetic_full/model_final.pt]
       [num_samples=2048] [batch=128] [--device cpu]
(the checkpoint: the engine's ``.pt`` or a flat params ``.npz``)
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch import nn

from spherehand_torch.convert import load_hourglass
from spherehand_torch.data.sampler import sample_poses
from spherehand_torch.data.synthesizer import synthesize
from spherehand_torch.device import resolve_device
from spherehand_torch.evaluation.metrics import max_error_curve
from spherehand_torch.hand.assets import HandModel, load_hand_model
from spherehand_torch.infer import float32_precision, load_params_npz
from spherehand_torch.models.estimator import forward, make_network
from spherehand_torch.utils import determinism

HELDOUT_SEED = 777_000


def load_network(path: str, device: torch.device | str | None = None) -> nn.Module:
    """A one-stack estimator network from the engine's ``.pt`` checkpoint
    or a flat params ``.npz``."""
    dev = resolve_device(device)
    network = make_network(1)
    if path.endswith(".npz"):
        load_hourglass(network, load_params_npz(path))
    else:
        network.load_state_dict(torch.load(path, map_location="cpu", weights_only=True)["network"])
    return network.to(dev)


@torch.no_grad()
def heldout_errors(network: nn.Module, hand: HandModel, num_samples: int = 2048,
                   batch: int = 128) -> np.ndarray:
    """(num_samples, 41) joint errors (mm) of ``network`` on held-out noisy
    renders of ``hand``, on the hand model's device."""
    dev = hand.kp_radius.device
    errors = []
    for i, start in enumerate(range(0, num_samples, batch)):
        gen = torch.Generator(device=dev).manual_seed(HELDOUT_SEED + i)
        synt = synthesize(hand, gen, sample_poses(gen, min(batch, num_samples - start)),
                          add_noise=True)
        with float32_precision("highest"):
            est = forward(network, synt_dms=synt.dms).synt_xyz[-1]
        errors.append(torch.linalg.norm(est - synt.xyz, dim=-1).cpu().numpy())
    return np.concatenate(errors)


def evaluate(checkpoint: str, num_samples: int = 2048, batch: int = 128,
             device: torch.device | str | None = None) -> dict:
    """Errors and their summary for ``checkpoint``; writes
    ``synthetic_eval.npz`` beside it."""
    dev = resolve_device(device)
    errors = heldout_errors(load_network(checkpoint, dev), load_hand_model(device=dev),
                            num_samples, batch)
    per_joint = errors.mean(axis=0)
    thresholds, fractions = max_error_curve(errors)
    out_path = os.path.join(os.path.dirname(os.path.abspath(checkpoint)), "synthetic_eval.npz")
    np.savez_compressed(out_path, errors=errors, thresholds=thresholds, fractions=fractions)
    return {"errors": errors, "mean_mm": float(errors.mean()),
            "median_sample_mean_mm": float(np.median(errors.mean(axis=1))),
            "worst_joint": int(per_joint.argmax()), "worst_joint_mm": float(per_joint.max()),
            "thresholds": thresholds, "fractions": fractions, "path": out_path}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", nargs="?",
                    default=os.path.join("runs", "synthetic_full", "model_final.pt"))
    ap.add_argument("num_samples", nargs="?", type=int, default=2048)
    ap.add_argument("batch", nargs="?", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="torch device (cpu: the plain path)")
    args = ap.parse_args(argv)
    determinism.enable()
    r = evaluate(args.checkpoint, args.num_samples, args.batch, args.device)
    print(f"samples: {r['errors'].shape[0]}  (noisy renders, held-out poses)")
    print(f"mean joint error: {r['mean_mm']:.2f} mm")
    print(f"median sample mean error: {r['median_sample_mean_mm']:.2f} mm")
    print(f"worst joint: {r['worst_joint']} at {r['worst_joint_mm']:.2f} mm")
    print("max-error PCK curve (thresh mm -> fraction):")
    for t, f in zip(r["thresholds"], r["fractions"]):
        print(f"  {t:5.1f}  {f:.3f}")
    print("saved:", r["path"])


if __name__ == "__main__":
    main()
