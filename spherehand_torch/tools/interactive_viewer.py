"""Interactive hand-model viewer: pose sliders re-render the sphere and the
triangle depth maps side by side.

Counterpart of the JAX package's ``tools/interactive_viewer.py`` (a
re-design of the reference's ``mesh/interactive_viewer.py:13-80``): sliders
over the 26 pose parameters and a global scale. :func:`render_views` is the
work of one update, with no matplotlib: forward kinematics, the 41 sphere
centres through the port's sphere render (the ``sphere_min_depth`` kernel
on the card, its plain version on the CPU) and the mesh through
``render_depth_64`` (the raster kernels on the card, the plain exact raster
on the CPU). The sliders exist only in :func:`main`.

Usage: python -m spherehand_torch.tools.interactive_viewer [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from spherehand_torch.device import resolve_device
from spherehand_torch.hand.assets import HandModel, load_hand_model
from spherehand_torch.hand.kinematics import forward_kinematics
from spherehand_torch.hand.skinning import lbs_keypoints
from spherehand_torch.render.raster import render_depth_64
from spherehand_torch.render.sphere_cuda import sphere_min_depth

SIZE = 64
PARAM_NAMES = (
    ["palm_rx", "palm_ry", "palm_rz", "palm_tx", "palm_ty", "palm_tz"]
    + [f"{finger}_{dof}" for finger in ["index", "middle", "ring", "pinky", "thumb"]
       for dof in ["abduct", "flex1", "flex2", "flex3"]]
)


@torch.no_grad()
def render_views(hand: HandModel, params, scale: float = 1.0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pose parameters (26,) or (B, 26) and a global scale of the skeleton
    -> (sphere depth map, triangle depth map), each (64, 64) or
    (B, 64, 64) mm, background 100, on the hand model's device."""
    p = torch.as_tensor(params, dtype=torch.float32, device=hand.kp_radius.device)
    single = p.dim() == 1
    transforms = forward_kinematics(hand, p.reshape(-1, 26))
    if scale != 1.0:
        transforms = transforms * torch.tensor([scale, scale, scale, 1.0],
                                               device=p.device)[None, None, :, None]
    centers = lbs_keypoints(hand, transforms)[..., :3].contiguous()
    sphere_dm = sphere_min_depth(centers, hand.kp_radius, SIZE)
    mesh_dm = render_depth_64(hand, transforms)
    return (sphere_dm[0], mesh_dm[0]) if single else (sphere_dm, mesh_dm)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (cpu: the plain path)")
    args = ap.parse_args(argv)
    import matplotlib.pyplot as plt
    from matplotlib.widgets import Slider

    hand = load_hand_model(device=resolve_device(args.device))

    def views(p, s):
        return [v.cpu().numpy() for v in render_views(hand, p, s)]

    sphere_dm, mesh_dm = views(np.zeros(26, np.float32), 1.0)
    fig = plt.figure(figsize=(10, 12))
    ax_sphere = fig.add_axes([0.08, 0.55, 0.4, 0.4])
    ax_mesh = fig.add_axes([0.55, 0.55, 0.4, 0.4])
    ax_sphere.set_title("sphere primitives")
    ax_mesh.set_title("triangle raster")
    im_sphere = ax_sphere.imshow(sphere_dm, vmin=-100, vmax=100, cmap="gray")
    im_mesh = ax_mesh.imshow(mesh_dm, vmin=-100, vmax=100, cmap="gray")

    sliders = []
    for i, name in enumerate(PARAM_NAMES):
        ax = fig.add_axes([0.15, 0.5 - i * 0.018, 0.55, 0.012])
        lo, hi = (-40, 40) if 3 <= i < 6 else (-3.2, 3.2)
        sliders.append(Slider(ax, name, lo, hi, valinit=0.0))
    scale = Slider(fig.add_axes([0.15, 0.5 - len(PARAM_NAMES) * 0.018, 0.55, 0.012]),
                   "scale", 0.7, 1.3, valinit=1.0)

    def update(_):
        s_dm, m_dm = views(np.asarray([s.val for s in sliders], np.float32), scale.val)
        im_sphere.set_data(s_dm)
        im_mesh.set_data(m_dm)
        fig.canvas.draw_idle()

    for s in sliders + [scale]:
        s.on_changed(update)
    plt.show()


if __name__ == "__main__":
    main()
