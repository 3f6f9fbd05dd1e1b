"""Kernel parity of the port on the card: the counterpart of
``tools/tpu_kernel_parity.py`` and ``tools/tpu_sphere_parity.py``.

Raster, at ``RASTER_BATCH`` = 32 sampler poses on the 128 x 128 bilinear sample
grid of ``render_depth_64``, passed as a plain grid (no shortcut):

- ``oracle``: the plain exact rule (``render/raster.rasterize_depth``);
- ``exact``: the ``raster_exact`` kernel (``raster_cuda.rasterize_exact``);
- ``fast``: the ``raster_fast`` kernel (``raster_cuda.rasterize_fast``), raw;
- ``fastpool``: the ``raster_fast_pooled`` kernel, clamped to 100 and 2x2-pooled;

with the statistics of ``tpu_kernel_parity.py:83-105``. The TPU's ``fastp``
(its packed 16-bit sort payloads, raw) has no counterpart: the port sorts no
faces.

Sphere, on the fixture of ``tpu_sphere_parity.py:49-61`` (N = 225, J = 41,
S = 64, numpy ``RandomState(77)``): the forward relative error and the
cotangent-weighted gradient relative error of ``sphere_min_depth``,
``d2m_nearest`` and the fused ``sphere_min_depth_and_d2m``, each against its
plain field (``render/sphere_cuda.*_primal_plain``) and autograd through it;
then ``stack_loss`` and the norm of its joint gradient on the loss fixture
(``tpu_sphere_parity.py:64-98``, ``RandomState(99)``), through the fused
loss (``stack_loss``) and the unfused one (``stack_loss_unfused``).
``rel(a, b)`` is max |a - b| / max |b|.

Usage: python -m spherehand_torch.kernel_parity [--seed 0] [--out PATH]

Prints one JSON line of these statistics (``--out`` also writes it to PATH),
then the card's name and power limit. Runs on CUDA (``--device cpu`` runs the plain versions against
themselves, a check of the script alone).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

RASTER_BATCH = 32
SIZE = 64
N, J = 225, 41
B, V = 25, 3


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def hand_geometry(model, generator: torch.Generator, batch: int):
    """Sampler poses -> (face vertices (B, F, 3, 3), their (u, v, z) planes),
    the posed full mesh under the nominal orthographic camera at 640."""
    from spherehand_torch.data.sampler import sample_poses
    from spherehand_torch.hand.kinematics import forward_kinematics
    from spherehand_torch.hand.skinning import project_faces_planes

    planes = project_faces_planes(model, forward_kinematics(model, sample_poses(generator, batch)),
                                  640.0)
    u, v, z = planes
    return torch.stack([u, v, z], dim=-1).reshape(batch, -1, 3, 3), planes


def raster_buffers(fv, planes, samples) -> dict:
    """The four buffers of the raster parity on one geometry."""
    from spherehand_torch.render import raster_cuda
    from spherehand_torch.render.raster import rasterize_depth

    return {
        "oracle": rasterize_depth(fv, samples, samples),
        "exact": raster_cuda.rasterize_exact(samples, samples, planes=planes),
        "fast": raster_cuda.rasterize_fast(samples, samples, planes=planes),
        "fastpool": raster_cuda.rasterize_fast_pooled(samples, samples, planes=planes),
    }


def raster_stats(buffers: dict) -> dict:
    """The statistics of ``tpu_kernel_parity.py:83-105`` (without ``fastp``)."""
    oracle, exact, fast, fastpool = (_np(buffers[k]) for k in
                                     ("oracle", "exact", "fast", "fastpool"))
    batch, sy, sx = oracle.shape
    pooled_oracle = np.minimum(oracle, 100.0).reshape(batch, sy // 2, 2, sx // 2, 2).mean(
        axis=(2, 4))
    fg_o, fg_e, fg_f = oracle < 999, exact < 999, fast < 999
    diff_e = np.abs(oracle - exact)
    both_f = fg_o & fg_f
    diff_f = np.abs(oracle - fast)[both_f]
    diff_p = np.abs(fastpool - pooled_oracle)
    return {
        "batch": batch,
        "exact_coverage_match": float((fg_o == fg_e).mean()),
        "exact_median_diff": float(np.median(diff_e)),
        "exact_big_diff_frac": float((diff_e > 1.0).mean()),
        "fast_iou": float(both_f.sum() / max((fg_o | fg_f).sum(), 1)),
        "fast_p99_diff": float(np.percentile(diff_f, 99)),
        "fastpool_median": float(np.median(diff_p)),
        "fastpool_p99": float(np.percentile(diff_p, 99)),
        "fastpool_big_frac": float((diff_p > 5.0).mean()),
    }


def sphere_fixture(device, n: int = N, num_j: int = J, size: int = SIZE):
    """``tpu_sphere_parity.fixture``: (centers, radii, w, w2, z) on ``device``."""
    rng = np.random.RandomState(77)
    centers = rng.uniform(-80, 80, (n, num_j, 3)).astype(np.float32)
    radii = rng.uniform(4, 12, (num_j,)).astype(np.float32)
    w = rng.uniform(-1, 1, (n, size, size)).astype(np.float32)
    w2 = rng.uniform(-1, 1, (n, size, size)).astype(np.float32)
    z = np.full((n, size, size), 100.0, np.float32)
    lo, hi = size // 4, 3 * size // 4
    z[:, lo:hi, lo:hi] = rng.uniform(-60, 60, (n, hi - lo, hi - lo))
    return tuple(torch.as_tensor(a, device=device) for a in (centers, radii, w, w2, z))


def loss_fixture(device, batch: int = B, views: int = V, num_j: int = J, size: int = SIZE):
    """``tpu_sphere_parity.loss_fixture``: (joints, dms, poses, inv_poses)."""
    rng = np.random.RandomState(99)
    joints = rng.uniform(-70, 70, (batch, views, num_j, 3)).astype(np.float32)
    dms = np.full((batch, views, size, size), 100.0, np.float32)
    lo, hi = 3 * size // 16, 13 * size // 16
    dms[:, :, lo:hi, lo:hi] = rng.uniform(-60, 60, (batch, views, hi - lo, hi - lo))
    angles = rng.uniform(-0.7, 0.7, (views,))
    poses = np.zeros((batch, views, 4, 4), np.float32)
    poses[:, :, 3, 3] = 1.0
    for v in range(views):
        c, s = np.cos(angles[v]), np.sin(angles[v])
        poses[:, v, :3, :3] = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    inv = np.swapaxes(poses, -1, -2)
    return tuple(torch.as_tensor(a, device=device) for a in (joints, dms, poses, inv))


def stack_loss(joints, dms, poses, inv_poses, radii, fused: bool | None = None):
    """``tpu_sphere_parity.stack_loss``: mutual projection (is_mv) + 1e-3
    consistency + collision + bone length."""
    from spherehand_torch.losses.geometric import bone_length_loss, collision_loss
    from spherehand_torch.losses.multiview import multiview_consistency_loss, mutual_projection_loss

    mv_proj, _ = mutual_projection_loss(poses, inv_poses, joints, dms, radii, is_mv=True,
                                        fused=fused)
    flat = joints.reshape(-1, *joints.shape[2:])
    return (mv_proj + 1e-3 * multiview_consistency_loss(poses, joints) + collision_loss(flat)
            + bone_length_loss(flat))


def _value_and_grad(fn, x):
    leaf = x.detach().clone().requires_grad_(True)
    value = fn(leaf)
    value.backward()
    return value.detach(), leaf.grad


def sphere_stats(device, n: int = N, batch: int = B) -> dict:
    """Section A and B of ``tpu_sphere_parity.py`` for the port's ops."""
    from spherehand_torch.render import sphere_cuda as sc

    centers, radii, w, w2, z = sphere_fixture(device, n)
    size = z.shape[-1]
    stats = {}
    ops = {
        "min_depth": (lambda c: sc.sphere_min_depth(c, radii, size),
                      lambda c: sc.min_depth_primal_plain(c, radii, size), w),
        "d2m": (lambda c: sc.d2m_nearest(z, c, radii, size),
                lambda c: sc.d2m_primal_plain(z, c, radii, size), w2),
    }
    for name, (op, plain, cot) in ops.items():
        with torch.no_grad():
            stats[f"{name}_fwd_rel"] = rel(_np(op(centers)), _np(plain(centers)))
        _, g_k = _value_and_grad(lambda c, f=op, g=cot: (g * f(c)).sum(), centers)
        _, g_o = _value_and_grad(lambda c, f=plain, g=cot: (g * f(c)).sum(), centers)
        stats[f"{name}_grad_rel"] = rel(_np(g_k), _np(g_o))

    def fused(fields):
        def value(c):
            depth, dist = fields(c)
            return (w * depth).sum() + (w2 * dist).sum()
        return value

    v_k, g_k = _value_and_grad(fused(lambda c: sc.sphere_min_depth_and_d2m(c, z, radii, size)),
                               centers)
    v_o, g_o = _value_and_grad(fused(lambda c: sc.fused_primal_plain(c, z, radii, size)), centers)
    stats["fused_val_rel"] = rel(_np(v_k), _np(v_o))
    stats["fused_grad_rel"] = rel(_np(g_k), _np(g_o))

    joints, dms, poses, inv = loss_fixture(device, batch)
    for key, fused_loss in (("stack", None), ("stack_unfused", False)):
        val, grad = _value_and_grad(
            lambda j, f=fused_loss: stack_loss(j, dms, poses, inv, radii, fused=f), joints)
        stats[f"{key}_loss"] = float(val)
        stats[f"{key}_grad_norm"] = float(torch.linalg.norm(grad))
    return stats


def run(device, seed: int = 0, raster_batch: int = RASTER_BATCH, sphere_n: int = N,
        sphere_batch: int = B) -> dict:
    """Both sections on ``device``; the sizes default to the TPU tools'."""
    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.render.raster import bilinear_sample_positions

    model = load_hand_model(device=device)
    samples = torch.as_tensor(bilinear_sample_positions(64, 10), device=device)
    fv, planes = hand_geometry(model, torch.Generator(device=device).manual_seed(seed),
                               raster_batch)
    return {**raster_stats(raster_buffers(fv, planes, samples)),
            **sphere_stats(device, sphere_n, sphere_batch)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default cuda")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    from spherehand_torch.device import resolve_device

    dev = resolve_device(args.device)
    stats = run(dev, args.seed, RASTER_BATCH, N, B)
    line = json.dumps({"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                       **stats})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
