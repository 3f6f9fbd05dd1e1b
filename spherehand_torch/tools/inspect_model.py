"""Hand-model inspection aids: keypoint order, 3D scatter, synthetic against
NYU.

Counterpart of the JAX package's ``tools/inspect_model.py`` (itself a
compact replacement of the reference's ``mesh/joint_order.py``,
``mesh/vis_utils.py`` and ``mesh/scale_test.py``):

- ``order``: the keypoint table (owning bone, radius) and the 14-point
  synthetic-to-NYU correspondence, printed as the JAX tool prints it;
- ``scatter``: a 3D scatter of the rest-pose mesh vertices (every fifth)
  and the 41 sphere centres;
- ``align <npy_dir>``: an NYU-format shard's first sample (view 0) with its
  ground-truth keypoints, beside the synthesized rest-pose keypoints.

The data of each figure comes from a function that needs no matplotlib
(:func:`order_lines`, :func:`scatter_points`, :func:`align_points`);
matplotlib is imported only where a figure is drawn, shown on screen, or
written to ``--out`` under the Agg backend.

Usage: python -m spherehand_torch.tools.inspect_model order
       python -m spherehand_torch.tools.inspect_model scatter [--out scatter.png]
       python -m spherehand_torch.tools.inspect_model align <npy_dir> [--out align.png]
       (on the card by default; ``--device cpu`` for the plain path)
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from spherehand_torch import constants as C
from spherehand_torch.data.nyu import NyuDataset
from spherehand_torch.hand.assets import HandModel, load_hand_model
from spherehand_torch.hand.kinematics import forward_kinematics
from spherehand_torch.hand.skinning import lbs_keypoints, lbs_mesh

FINGERS = ["index(f1)", "middle(f2)", "ring(f3)", "pinky(f4)", "thumb(f5)"]


def order_lines(model: HandModel) -> list[str]:
    """The keypoint table and the synthetic-to-NYU correspondence, line by
    line."""
    kp_bone = model.kp_bone.cpu().numpy()
    radii = model.kp_radius.cpu().numpy()
    lines = ["keypoint -> owning bone (41 spheres; 11 palm + 6 per finger):"]
    for k in range(model.num_keypoints):
        bone = int(kp_bone[k])
        label = "palm" if bone < 2 else f"{FINGERS[(bone - 2) // 3]} j{(bone - 2) % 3 + 1}"
        lines.append(f"  kp {k:2d}: bone {bone:2d} ({label}), radius {radii[k]:.1f} mm")
    lines.append("\n14-point synt<->NYU correspondence (constants.py):")
    lines += [f"  synt {s:2d} <-> nyu {r:2d}"
              for s, r in zip(C.SYNT_KEY_POINTS, C.REAL_KEY_POINTS)]
    return lines


def _rest_transforms(model: HandModel) -> torch.Tensor:
    return forward_kinematics(model, torch.zeros((1, 26), device=model.kp_radius.device))


def scatter_points(model: HandModel) -> tuple[np.ndarray, np.ndarray]:
    """Rest-pose mesh vertices (V, 3) and sphere centres (41, 3), mm."""
    transforms = _rest_transforms(model)
    verts = lbs_mesh(model, transforms)[0, :, :3].cpu().numpy()
    kps = lbs_keypoints(model, transforms)[0, :, :3].cpu().numpy()
    return verts, kps


def align_points(npy_dir: str, model: HandModel) -> dict[str, np.ndarray]:
    """The first sample of the shards in ``npy_dir``: its view-0 depth map,
    its 14 ground-truth keypoints and the 14 synthesized rest-pose
    keypoints, both in that map's pixels."""
    dms, joints, _, _ = NyuDataset(npy_dir).gather(np.asarray([0]))
    synt_kps = lbs_keypoints(model, _rest_transforms(model))[0].cpu().numpy()
    size = dms.shape[-1]

    def to_px(pts):
        return pts[:, :2] * size / C.Constants().cube_mm + size / 2

    return {"depth": dms[0, 0], "real_px": to_px(joints[0, 0][list(C.REAL_KEY_POINTS)]),
            "synt_px": to_px(synt_kps[list(C.SYNT_KEY_POINTS)])}


def _finish(fig, out: str | None) -> None:
    import matplotlib.pyplot as plt

    if out is None:
        plt.show()
    else:
        fig.savefig(out)
        print(f"wrote {out}")
    plt.close(fig)


def _pyplot(out: str | None):
    import matplotlib

    if out is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def scatter(model: HandModel, out: str | None = None) -> None:
    plt = _pyplot(out)
    verts, kps = scatter_points(model)
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.scatter(verts[::5, 0], verts[::5, 1], verts[::5, 2], c="b", s=2)
    ax.scatter(kps[:, 0], kps[:, 1], kps[:, 2], c="r", s=30)
    print(f"vertex z range: {verts[:, 2].min():.1f} .. {verts[:, 2].max():.1f} mm")
    _finish(fig, out)


def align(npy_dir: str, model: HandModel, out: str | None = None) -> None:
    plt = _pyplot(out)
    pts = align_points(npy_dir, model)
    size = pts["depth"].shape[-1]
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    axes[0].imshow(pts["depth"])
    axes[0].scatter(pts["real_px"][:, 0], pts["real_px"][:, 1], c="r")
    axes[0].set_title("NYU GT keypoints (view 0)")
    axes[1].imshow(np.zeros((size, size)))
    axes[1].scatter(pts["synt_px"][:, 0], pts["synt_px"][:, 1], c="g")
    axes[1].set_title("synthesized keypoints (rest pose)")
    _finish(fig, out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("command", nargs="?", default="order", choices=["order", "scatter", "align"])
    ap.add_argument("npy_dir", nargs="?", help="align: a directory of NYU-format shards")
    ap.add_argument("--out", default=None, help="write the figure here instead of showing it")
    ap.add_argument("--device", default="cuda", help="torch device (cpu: the plain path)")
    args = ap.parse_args(argv)
    model = load_hand_model(device=args.device)
    if args.command == "order":
        print("\n".join(order_lines(model)))
    elif args.command == "scatter":
        scatter(model, args.out)
    else:
        if args.npy_dir is None:
            ap.error("align needs <npy_dir>")
        align(args.npy_dir, model, args.out)


if __name__ == "__main__":
    main()
