"""How far a crop's joints move with the batch it is served in, with TF32
on and off, and what TF32 off costs on the card.

Counterpart of the JAX package's ``tools/measure_wobble.py``, with its keys.
There the TPU's default float32 convolutions run bf16 passes and XLA
compiles other layouts for other batch sizes, so one crop's joints depend
on the program that served it. On the card the counterpart is TF32: cuDNN
runs float32 convolutions in TF32 by default and picks its algorithms by
batch size. The port's rule that parity and eval paths switch TF32 off
(``infer.float32_precision("highest")``) rests on this measurement.

1,024 synthetic crops (``synthesize(add_noise=False)``) go through the
shipped one-stack network (``assets/pretrained/synthetic_params.npz``) as
one B = 1024 forward and as eight B = 128 forwards; the per-joint |diff|
(mm) of each crop is summarised in two modes, ``default`` (PyTorch's
defaults: TF32 convolutions) and ``highest`` (TF32 off). On the card each
mode's forward is also timed at B = 128 and B = 1024 (CUDA events over
``--iters`` forwards, best of 3 windows): ``b128_ms_device`` /
``b1024_ms_device``; on the CPU those are null. The process runs with
deterministic algorithms (``utils.determinism``).

Usage: python -m spherehand_torch.tools.measure_wobble [--artifact PATH]
       [--crops 1024] [--small 128] [--iters 20] [--device cpu]
(the card's record: ``--artifact tests/goldens/torch_precision_wobble.json``)
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from spherehand_torch.convert import load_hourglass
from spherehand_torch.data.sampler import sample_poses
from spherehand_torch.data.synthesizer import synthesize
from spherehand_torch.device import resolve_device
from spherehand_torch.hand.assets import load_hand_model
from spherehand_torch.infer import float32_precision, load_params_npz
from spherehand_torch.models.estimator import forward, make_network
from spherehand_torch.tools import ROOT, refuse_golden
from spherehand_torch.tools.selfsup_demo import backend
from spherehand_torch.utils import determinism

PRETRAINED = os.path.join(ROOT, "assets", "pretrained", "synthetic_params.npz")
BIG, SMALL = 1024, 128
CHUNK = 256
POSE_SEED, SYNTH_SEED = 0, 1_000
MODES = (("default", None), ("highest", "highest"))


def crops(hand, num: int) -> torch.Tensor:
    """(num, 64, 64) noise-free synthetic crops (scaled depth), rendered
    ``CHUNK`` at a time."""
    dev = hand.kp_radius.device
    out = []
    for i, start in enumerate(range(0, num, CHUNK)):
        poses = sample_poses(torch.Generator(device=dev).manual_seed(POSE_SEED + i),
                             min(CHUNK, num - start))
        gen = torch.Generator(device=dev).manual_seed(SYNTH_SEED + i)
        out.append(synthesize(hand, gen, poses, add_noise=False).dms)
    return torch.cat(out)


@torch.no_grad()
def joints_of(network, dms: torch.Tensor) -> torch.Tensor:
    """(B, 41, 3) mm joints of the crops, served as one batch."""
    return forward(network, real_dms=dms[:, None]).real_xyz[-1][:, 0]


def forward_ms(network, dms: torch.Tensor, iters: int) -> float:
    """Device ms a forward: ``iters`` forwards between two CUDA events,
    best of 3 windows after a warm-up."""
    joints_of(network, dms)
    best = float("inf")
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            joints_of(network, dms)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def measure(network, dms: torch.Tensor, small: int, iters: int, precision: str | None) -> dict:
    """One mode: the per-crop |B=N - B=small| joint gaps, and on the card
    the forward's device ms at both batch sizes."""
    with float32_precision(precision):
        big = joints_of(network, dms)
        parts = torch.cat([joints_of(network, dms[i:i + small])
                           for i in range(0, dms.shape[0], small)])
        d = torch.linalg.norm(big - parts, dim=-1).cpu().numpy()
        on_card = dms.device.type == "cuda"
        ms_small = forward_ms(network, dms[:small], iters) if on_card else None
        ms_big = forward_ms(network, dms, iters) if on_card else None
    return {"max_mm": float(d.max()), "mean_mm": float(d.mean()),
            "p99_mm": float(np.percentile(d, 99)),
            "b128_ms_device": None if ms_small is None else round(ms_small, 3),
            "b1024_ms_device": None if ms_big is None else round(ms_big, 3)}


def run(num_crops: int = BIG, small: int = SMALL, iters: int = 20,
        artifact: str | None = None, device: torch.device | str | None = None) -> dict:
    """Both modes; writes ``artifact`` when given and returns the record."""
    if artifact is not None:
        refuse_golden(artifact)
    dev = resolve_device(device)
    network = load_hourglass(make_network(1), load_params_npz(PRETRAINED)).to(dev).eval()
    dms = crops(load_hand_model(device=dev), num_crops)
    results = {}
    for label, precision in MODES:
        r = results[label] = measure(network, dms, small, iters, precision)
        print(f"{label:8s}: |B={num_crops} - B={small}| max {r['max_mm']:.5f} mm, mean "
              f"{r['mean_mm']:.6f}, p99 {r['p99_mm']:.5f}; device forward B={small} "
              f"{r['b128_ms_device']} ms, B={num_crops} {r['b1024_ms_device']} ms", flush=True)

    def ratio(key):
        on, off = results["highest"][key], results["default"][key]
        return None if on is None else round(on / off, 3)

    out = {"backend": backend(dev), "batches": [num_crops, small], "torch": torch.__version__,
           **results, "highest_cost_ratio_b128": ratio("b128_ms_device"),
           "highest_cost_ratio_b1024": ratio("b1024_ms_device")}
    print(json.dumps(out))
    if artifact is not None:
        os.makedirs(os.path.dirname(os.path.abspath(artifact)), exist_ok=True)
        with open(artifact, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {artifact}")
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact", default=None,
                    help="write the record here (the card's: "
                         "tests/goldens/torch_precision_wobble.json)")
    ap.add_argument("--crops", type=int, default=BIG, help="crops, served as one batch")
    ap.add_argument("--small", type=int, default=SMALL, help="the smaller batch")
    ap.add_argument("--iters", type=int, default=20, help="timed forwards a window")
    ap.add_argument("--device", default="cuda", help="torch device (cpu: the plain path)")
    args = ap.parse_args(argv)
    determinism.enable()
    run(args.crops, args.small, args.iters, args.artifact, args.device)


if __name__ == "__main__":
    main()
