"""Build the decimated "lite" hand mesh for the fast synthetic-render path.

Counterpart of the JAX package's ``tools/make_lite_mesh.py``. At the 64 x 64
output resolution the rasterizer samples the 640 canvas every 5 px (about
1.3 mm on the hand), so the full 3,382-triangle mesh carries more geometry
than a depth map resolves. This tool welds the asset's triangle soup into
shared vertices (exact: duplicates carry identical skin weights), collapses
edges lowest-quadric-error-first down to a face budget (``_qem_decimate``:
endpoint folds, so kept vertices keep their positions and skin weights;
normal-flip, degeneracy and skinning guards), and writes the result in
``hand_model.npz``'s schema: ``load_hand_model(path=...)`` reads it as the
lite mesh. At the default budget the output equals the committed
``assets/hand_model_lite.npz`` bit for bit; the tool never writes over that
file (``--out`` defaults to ``runs/hand_model_lite.npz``).

``--validate N`` renders N sampled poses with the full and the new mesh
through the port's ``render_depth_64`` (the plain exact raster on the CPU,
the kernels on the card) and prints the coverage IoU and the matched
foreground's depth gaps.

Usage: python -m spherehand_torch.tools.make_lite_mesh [--target 1700] [--validate 32]
       [--out runs/hand_model_lite.npz] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from spherehand_torch.data.sampler import sample_poses
from spherehand_torch.device import resolve_device
from spherehand_torch.hand.assets import load_hand_model
from spherehand_torch.hand.kinematics import forward_kinematics
from spherehand_torch.render.raster import render_depth_64
from spherehand_torch.tools import ROOT
from spherehand_torch.tools._qem_decimate import qem_decimate

ASSET_DIR = os.path.join(ROOT, "assets")
FULL = os.path.join(ASSET_DIR, "hand_model.npz")
SHIPPED = os.path.join(ASSET_DIR, "hand_model_lite.npz")
# The lite mesh's raster truncation bound (HandModel.raster_valid_frac; the
# JAX tool's value).
LITE_VALID_FRAC = np.float32(0.70)
VALIDATE_SEED = 123


def weld(vertices: np.ndarray, faces: np.ndarray, weights: np.ndarray):
    """Merge duplicate-position vertices (exact byte match) -> (vertices',
    faces', weights'); raises if duplicates differ in their weights."""
    pos = np.ascontiguousarray(vertices[:, :3])
    key = pos.view([("", pos.dtype)] * 3).ravel()
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    grp_w = weights[:, first]
    chk = np.abs(grp_w[:, inv] - weights).max()
    if chk != 0.0:
        raise ValueError(f"weld not exact: weight diff {chk}")
    return vertices[first], inv[faces].astype(faces.dtype), grp_w


def build(target: int = 1700, source: str = FULL) -> dict[str, np.ndarray]:
    """The lite mesh's arrays: welded, decimated to ``target`` faces,
    compacted to the used vertices; the source's other tables carried
    unchanged (its ``skin_matrix``, if any, dropped: the loader rebuilds
    it)."""
    with np.load(source) as src:
        arrays = {k: src[k] for k in src.files}
    vertices, faces, weights = weld(arrays["vertices"], arrays["faces"],
                                    arrays["skin_weights"])
    lite_faces, used = qem_decimate(vertices, faces, weights, target)
    remap = np.full(vertices.shape[0], -1, np.int64)
    remap[used] = np.arange(used.shape[0])
    out = {"vertices": vertices[used],
           "faces": remap[lite_faces].astype(faces.dtype),
           "skin_weights": weights[:, used]}
    for k, v in arrays.items():
        if k not in out and k != "skin_matrix":
            out[k] = v
    out["raster_valid_frac"] = LITE_VALID_FRAC
    return out


def write(arrays: dict[str, np.ndarray], path: str) -> None:
    """Save ``arrays`` to ``path``; refuses the committed assets."""
    real = os.path.realpath(path)
    if real in (os.path.realpath(SHIPPED), os.path.realpath(FULL)):
        raise ValueError(f"refusing to write over the committed asset {path}; "
                         "use --out elsewhere")
    os.makedirs(os.path.dirname(real), exist_ok=True)
    np.savez_compressed(path, **arrays)


def validate(num_poses: int, path: str, device: torch.device | str | None = None) -> dict:
    """Full against the mesh at ``path``, rendered at ``num_poses`` sampled
    poses: coverage IoU and the matched foreground's |dz| (mm)."""
    dev = resolve_device(device)
    full = load_hand_model(device=dev)
    lite = load_hand_model(path=path, device=dev)
    params = sample_poses(torch.Generator(device=dev).manual_seed(VALIDATE_SEED), num_poses)
    df, dl = (render_depth_64(m, forward_kinematics(m, params)).cpu().numpy()
              for m in (full, lite))
    fg_f, fg_l = df < 99.9, dl < 99.9
    both = fg_f & fg_l
    diff = np.abs(df - dl)[both]
    return {"poses": num_poses, "iou": float(both.sum() / max((fg_f | fg_l).sum(), 1)),
            "p50_mm": float(np.percentile(diff, 50)), "p99_mm": float(np.percentile(diff, 99)),
            "max_mm": float(diff.max())}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", type=int, default=1700)
    ap.add_argument("--validate", type=int, default=32,
                    help="poses for the full-against-lite render comparison (0: none)")
    ap.add_argument("--out", default=os.path.join("runs", "hand_model_lite.npz"))
    ap.add_argument("--device", default="cuda", help="torch device (cpu: the plain path)")
    args = ap.parse_args(argv)
    arrays = build(args.target)
    print(f"faces -> {arrays['faces'].shape[0]}, vertices {arrays['vertices'].shape[0]}")
    write(arrays, args.out)
    print(f"wrote {args.out}")
    if args.validate:
        v = validate(args.validate, args.out, args.device)
        print(f"validation over {v['poses']} poses: coverage IoU {v['iou']:.4f}, matched-fg "
              f"|dz| p50 {v['p50_mm']:.3f} p99 {v['p99_mm']:.3f} max {v['max_mm']:.2f}")


if __name__ == "__main__":
    main()
