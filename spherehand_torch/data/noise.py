"""Depth-map sensor noise.

Counterpart of ``depth_pixel_noise`` in ``spherehand_tpu/data/noise.py``
(reference network/util_modules.py:60-84). Following the port's RNG rule,
:func:`draw_pixel_noise` makes the three standard-normal draws from a
``torch.Generator`` and :func:`apply_pixel_noise` is the deterministic core.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Offsets are trunc(N(0.5, 0.5)); the JAX package bounds them to [-2, 3]
# (P(outside) ~ 3e-7 per axis) and so does the port.
_SHIFT_LO, _SHIFT_HI = -2, 3


class PixelNoiseDraws(NamedTuple):
    """Standard-normal draws, each (B, H, W)."""

    dx: torch.Tensor
    dy: torch.Tensor
    z: torch.Tensor


def draw_pixel_noise(generator: torch.Generator, shape) -> PixelNoiseDraws:
    dev = generator.device
    return PixelNoiseDraws(
        *(torch.randn(shape, generator=generator, device=dev) for _ in range(3))
    )


def apply_pixel_noise(dms: torch.Tensor, draws: PixelNoiseDraws) -> torch.Tensor:
    """Random per-pixel integer shifts + Gaussian z noise on the foreground.

    dms: (B, H, W) in scaled units (background 1.0). Output pixel (y, x)
    reads source pixel (clip(y + dy), clip(x + dx)) with integer offsets
    trunc(N(0.5, 0.5)) bounded to [-2, 3]; foreground values (< 1) get
    sigma = 0.05 z noise.
    """
    batch, height, width = dms.shape
    dev = dms.device

    def offsets(n: torch.Tensor) -> torch.Tensor:
        # float -> int conversion truncates toward zero, like torch .long()
        return torch.trunc(n * 0.5 + 0.5).to(torch.int64).clamp(_SHIFT_LO, _SHIFT_HI)

    rows = torch.arange(height, device=dev)[None, :, None]
    cols = torch.arange(width, device=dev)[None, None, :]
    src_y = (rows + offsets(draws.dy)).clamp(0, height - 1)
    src_x = (cols + offsets(draws.dx)).clamp(0, width - 1)
    flat = dms.reshape(batch, height * width)
    shifted = torch.gather(flat, 1, (src_y * width + src_x).reshape(batch, -1))
    shifted = shifted.reshape(batch, height, width)
    return torch.where(shifted < 1.0, shifted + draws.z * 0.05, shifted)


def depth_pixel_noise(generator: torch.Generator, dms: torch.Tensor) -> torch.Tensor:
    """Draw step + core."""
    draws = draw_pixel_noise(generator, dms.shape)
    return apply_pixel_noise(dms, PixelNoiseDraws(*(d.to(dms.device) for d in draws)))
