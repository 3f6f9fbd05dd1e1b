"""Training by fitting: the combined self-supervised loop closes a sensor
domain gap with no ground truth in any loss.

Counterpart of the JAX package's ``tools/selfsup_demo.py``, with its flags,
defaults and result keys:

1. pseudo-NYU shards (``data.pseudo_real.generate_pseudo_nyu``): rendered
   hands from three cameras through a shifted depth sensor (4x the
   training pixel jitter, 1.6x its z noise, 12 % holes); the ground-truth
   joints feed the metric only;
2. the start: the shipped synthetic pretraining
   (``assets/pretrained/synthetic_params.npz``), or ``--init short``, a
   fresh network after ``--pretrain_steps`` synthetic steps;
3. eval, then ``--epochs`` epochs of the engine's combined loop (mutual
   projection, multi-view consistency, VAE prior, collision, bone length,
   synthetic co-training; ``--adapt real`` drops the co-training,
   ``--no_mv`` the two multi-view terms), then eval again, with TF32 off
   in the eval steps;
4. the result JSON {before_mm, after_mm, ...}; ``backend`` names the card
   and its power limit as nvidia-smi gives them.

The artifact goes to ``--out`` (``selfsup_demo.json``, or
``selfsup_ablation.json`` under ``--no_mv``) unless ``--artifact`` names
another path; never to a JAX record under ``tests/goldens/``
(``tools.refuse_golden``). The result also holds ``seed`` and
``params_sha256``, a hash of the adapted network's parameters: with the
deterministic algorithms :func:`main` switches on (``utils.determinism``),
two runs of one seed give the same hash.

Usage: python -m spherehand_torch.tools.selfsup_demo [--samples 4096] [--test 512]
       [--epochs 30] [--no_mv] [--artifact PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import time

import torch

from spherehand_torch.bench import gpu_identity
from spherehand_torch.convert import train_state_from_params
from spherehand_torch.data.pseudo_real import (
    BLUR_KERNEL,
    DROPOUT,
    SHIFT_PIXEL_SIGMA,
    Z_SIGMA,
    generate_pseudo_nyu,
)
from spherehand_torch.device import resolve_device
from spherehand_torch.infer import load_params_npz
from spherehand_torch.tools import ROOT, refuse_golden
from spherehand_torch.train.config import EngineConfig
from spherehand_torch.train.engine import Engine, step_seed
from spherehand_torch.utils import determinism

PRETRAINED = os.path.join(ROOT, "assets", "pretrained", "synthetic_params.npz")
TEST_SEED_OFFSET = 10_000  # the test split's generator seed: seed + this
SHORT_INIT_LR = 1e-3


def backend(device: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or the device type."""
    if device.type != "cuda":
        return device.type
    ident = gpu_identity()
    return f"{ident['gpu_name']}, {ident['gpu_power_limit']}"


def params_sha256(network: torch.nn.Module) -> str:
    """SHA-256 over the network's parameters and buffers, in state-dict
    order, as float32 bytes."""
    digest = hashlib.sha256()
    for name, t in network.state_dict().items():
        digest.update(name.encode())
        digest.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def run(out: str = os.path.join("runs", "selfsup_demo"), samples: int = 4096, test: int = 512,
        epochs: int = 30, lr: float = 3e-5, init: str = "pretrained",
        pretrain_steps: int = 2000, adapt: str = "combined", no_mv: bool = False,
        artifact: str | None = None, seed: int = 0,
        device: torch.device | str | None = None, engine_overrides: dict | None = None) -> dict:
    """The demo; returns the result it writes. ``engine_overrides``:
    ``EngineConfig`` fields to change (e.g. batch sizes for a small run)."""
    art = artifact or os.path.join(out, "selfsup_ablation.json" if no_mv else "selfsup_demo.json")
    refuse_golden(art)
    dev = resolve_device(device)
    data_dir = os.path.join(out, "data")
    train_dir, test_dir = os.path.join(data_dir, "train"), os.path.join(data_dir, "test")
    if not os.path.exists(os.path.join(test_dir, "mv_data_0_shape.pkl")):
        t0 = time.time()
        gap = generate_pseudo_nyu(train_dir, samples, seed, dev)
        generate_pseudo_nyu(test_dir, test, seed + TEST_SEED_OFFSET, dev)
        print(f"pseudo-NYU data: {samples}+{test} samples x 3 views in {time.time() - t0:.1f}s "
              f"(sensor shift: jitter {SHIFT_PIXEL_SIGMA}px, z {Z_SIGMA}, dropout {DROPOUT}; "
              f"self-check {gap:.4f} mm)")

    cfg = EngineConfig(
        mode="Train", model_dir=os.path.join(out, "runs"), dataset_dir=data_dir, epoch=epochs,
        num_stacks=1, lr=lr, synthesize=adapt == "combined", mv_projection=not no_mv,
        mv_consistency=not no_mv, eval_precision="highest", tag="selfsup_",
    )
    engine = Engine(dataclasses.replace(cfg, **(engine_overrides or {})), device=dev)
    if init == "pretrained":
        engine.state = train_state_from_params(engine.steps.init_state,
                                               load_params_npz(PRETRAINED))
    else:  # a deliberately degraded start: a fresh short synthetic pretraining
        t0 = time.time()
        gen = torch.Generator(device=dev)
        for it in range(pretrain_steps):
            draws = engine.steps.draw(gen.manual_seed(step_seed(seed + 7, 0, it)), real=False)
            engine.state, _ = engine.steps.synt_step(engine.state, SHORT_INIT_LR, draws)
        print(f"degraded init: {pretrain_steps} synthetic steps in {time.time() - t0:.1f}s")

    before = engine.eval()
    print(f"BEFORE adaptation: {before}")
    t0 = time.time()
    engine.train()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_secs = time.time() - t0
    after = engine.eval()
    print(f"AFTER {epochs} self-supervised ({adapt}) epochs: {after}")

    result = {
        "sensor_shift": dict(shift_sigma=SHIFT_PIXEL_SIGMA, z_sigma=Z_SIGMA, dropout=DROPOUT,
                             blur=BLUR_KERNEL),
        "samples": samples,
        "epochs": epochs,
        "lr": lr,
        "init": init,
        "adapt": adapt,
        "no_mv": no_mv,
        "seed": seed,
        "steps": int(engine.state.step),
        "train_secs": round(train_secs, 1),
        "before_mm": round(float(before["avg_joint_error"]), 3),
        "after_mm": round(float(after["avg_joint_error"]), 3),
        "before_raw_mm": round(float(before["avg_joint_error_raw"]), 3),
        "after_raw_mm": round(float(after["avg_joint_error_raw"]), 3),
        "backend": backend(dev),
        "params_sha256": params_sha256(engine.state.network),
    }
    os.makedirs(os.path.dirname(os.path.abspath(art)), exist_ok=True)
    with open(art, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    print(f"wrote {art}")
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--test", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--out", default=os.path.join("runs", "selfsup_demo"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-5,
                    help="adaptation LR (the pretraining 1e-3 diverges on the small set)")
    ap.add_argument("--init", choices=["pretrained", "short"], default="pretrained",
                    help="starting point: the shipped 75k-step weights, or a deliberately "
                         "degraded fresh short synthetic pretrain")
    ap.add_argument("--pretrain_steps", type=int, default=2000)
    ap.add_argument("--adapt", choices=["combined", "real"], default="combined",
                    help="combined = reference mixed loop; real = pure self-supervision, "
                         "no synthetic co-training")
    ap.add_argument("--artifact", default=None,
                    help="result JSON path (default: under --out; a port record goes to "
                         "tests/goldens/torch_*.json, never to a JAX record)")
    ap.add_argument("--no_mv", action="store_true",
                    help="ablation: disable the multi-view self-supervision terms "
                         "(projection + consistency), keeping everything else")
    ap.add_argument("--device", default="cuda", help="torch device (cpu: the plain path)")
    args = ap.parse_args(argv)
    determinism.enable()
    run(**vars(args))


if __name__ == "__main__":
    main()
