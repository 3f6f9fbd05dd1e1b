"""Synthetic training-sample generator.

Counterpart of ``spherehand_tpu/data/synthesizer.py`` (reference
network/util_modules.py:86-122): pose parameters -> FK -> random anisotropic
scale -> random focal jitter -> triangle-raster depth map (+ sensor noise) ->
GT heatmaps + joints. Every output is detached, as in the reference.

Following the port's RNG rule, :func:`draw_synthesis` makes the random draws
from a ``torch.Generator`` and :func:`synthesize_from_draws` is the
deterministic core that takes them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from spherehand_torch.constants import Constants
from spherehand_torch.data.noise import PixelNoiseDraws, apply_pixel_noise, draw_pixel_noise
from spherehand_torch.hand.assets import HandModel
from spherehand_torch.hand.kinematics import forward_kinematics
from spherehand_torch.hand.skinning import apply_scale, draw_random_scale
from spherehand_torch.render.heatmap import render_joint_heatmaps
from spherehand_torch.render.raster import render_depth_64

_C = Constants()

SCALE_RANGE = 0.1


class SyntheticBatch(NamedTuple):
    """Ground-truth supervision for one synthetic batch (all detached)."""

    dms: torch.Tensor     # (B, 64, 64) scaled depth (background 1.0)
    uv_hms: torch.Tensor  # (B, 41, 16, 16) Gaussian GT heatmaps
    d_hms: torch.Tensor   # (B, 41, 16, 16) scaled GT depth heatmaps
    xyz: torch.Tensor     # (B, 41, 3) GT joints, mm camera space


class SynthesisDraws(NamedTuple):
    scale_u: torch.Tensor      # (B, 3) U[0, 1), see skinning.apply_scale
    rand_f: torch.Tensor       # (B,) focal jitter in [0.9, 1.1)
    noise: PixelNoiseDraws     # standard normals, each (B, 64, 64)


def draw_synthesis(generator: torch.Generator, batch: int) -> SynthesisDraws:
    """Draw the random inputs of one synthetic batch on the generator's device."""
    scale_u = draw_random_scale(generator, batch)
    rand_f = torch.rand((batch,), generator=generator, device=generator.device) * 0.2 + 0.9
    size = _C.depthmap_size
    return SynthesisDraws(scale_u, rand_f, draw_pixel_noise(generator, (batch, size, size)))


@torch.no_grad()
def synthesize_from_draws(
    model: HandModel,
    pose_params: torch.Tensor,
    draws: SynthesisDraws,
    add_noise: bool = True,
    exact: bool = False,
) -> SyntheticBatch:
    """Render a supervised batch from pose parameters (B, 26) and the draws.

    ``exact`` selects the scanline-parity raster mode on the GPU (the CPU
    always renders exactly, see ``render_depth_64``)."""
    transforms = forward_kinematics(model, pose_params)
    transforms = apply_scale(transforms, draws.scale_u, SCALE_RANGE)
    rand_f = draws.rand_f

    dms = render_depth_64(model, transforms, rand_f, exact=exact) * _C.depth_scale
    if add_noise:
        dms = apply_pixel_noise(dms, draws.noise)

    uv_hms, d_hms, xyz = render_joint_heatmaps(model, transforms, _C.heatmap_size, rand_f)
    return SyntheticBatch(
        dms=dms,
        uv_hms=uv_hms * _C.uv_hm_scale,
        d_hms=d_hms * _C.depth_scale,
        xyz=xyz[..., :3],
    )


def synthesize(
    model: HandModel,
    generator: torch.Generator,
    pose_params: torch.Tensor,
    add_noise: bool = True,
    exact: bool = False,
) -> SyntheticBatch:
    """Draw step + core, the counterpart of the JAX ``synthesize``."""
    draws = draw_synthesis(generator, pose_params.shape[0])
    dev = pose_params.device
    draws = SynthesisDraws(
        draws.scale_u.to(dev), draws.rand_f.to(dev),
        PixelNoiseDraws(*(n.to(dev) for n in draws.noise)),
    )
    return synthesize_from_draws(model, pose_params, draws, add_noise, exact)
