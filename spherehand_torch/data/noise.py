"""Depth-map sensor noise and the train-time resize-crop augmentation.

Counterpart of ``depth_pixel_noise``, ``depth_resample``, ``resize_crop``
and ``sample_resize_scales`` in ``spherehand_tpu/data/noise.py`` (reference
network/util_modules.py:10-84,383-424, create_network_and_criterion.py:42-48).
Following the port's RNG rule, each stochastic function is a draw step from
a ``torch.Generator`` (:func:`draw_pixel_noise`, :func:`draw_depth_resample`,
:func:`draw_resize_scales`) and a deterministic core that takes the draws
(:func:`apply_pixel_noise`, :func:`depth_resample`, :func:`resize_scales`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

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


_GAUSS = {
    3: np.asarray([[1, 2, 1], [2, 6, 2], [1, 2, 1]], np.float32),
    5: np.asarray([[1, 4, 7, 4, 1], [4, 16, 26, 16, 4], [7, 26, 41, 26, 7],
                   [4, 16, 26, 16, 4], [1, 4, 7, 4, 1]], np.float32),
}


def draw_depth_resample(generator: torch.Generator, n: int, size: int = 64) -> torch.Tensor:
    """U[0, 1) draws of the pixel dropout, (n, size, size), on the
    generator's device."""
    return torch.rand((n, size, size), generator=generator, device=generator.device)


def depth_resample(dms: torch.Tensor, uniforms: torch.Tensor, sample_ratio: float = 0.95,
                   kernel_size: int = 3) -> torch.Tensor:
    """Drop the pixels whose draw exceeds ``sample_ratio`` to background
    (1.0), then blur with the normalised 3x3 or 5x5 Gaussian.

    dms (B, H, W) scaled units, uniforms (B, H, W). The blur pads with 0, as
    the JAX package's convolution does, so border pixels blur toward 0. It
    is a sum of shifted planes in float32 on every device (no cuDNN, so no
    TF32). Off by default (run_engine.py:27)."""
    if kernel_size not in _GAUSS:
        raise ValueError(f"depth_resample takes kernel_size 3 or 5, got {kernel_size}")
    kern = (_GAUSS[kernel_size] / _GAUSS[kernel_size].sum()).tolist()
    dropped = torch.where(uniforms <= sample_ratio, dms, torch.ones_like(dms))
    pad = kernel_size // 2
    padded = F.pad(dropped, (pad, pad, pad, pad))
    height, width = dms.shape[-2:]
    out = torch.zeros_like(dms)
    for i, row in enumerate(kern):
        for j, w in enumerate(row):
            out = out + padded[:, i:i + height, j:j + width] * w
    return out


class ResizeDraws(NamedTuple):
    """Uniform [0, 1) draws of the resize-crop scales: one coin for the
    batch, and a base and two per-axis jitters for each of the n rows."""

    coin: torch.Tensor  # ()
    base: torch.Tensor  # (n,)
    u: torch.Tensor     # (n,)
    v: torch.Tensor     # (n,)


def draw_resize_scales(generator: torch.Generator, n: int) -> ResizeDraws:
    dev = generator.device
    coin = torch.rand((), generator=generator, device=dev)
    return ResizeDraws(coin, *(torch.rand((n,), generator=generator, device=dev)
                               for _ in range(3)))


def resize_scales(draws: ResizeDraws) -> tuple[torch.Tensor, torch.Tensor]:
    """(u_scales, v_scales), each (n,): identity with p = 0.5 (one coin for
    the whole batch), else a shared base in [0.75, 0.95) plus +-0.05 jitter
    per axis."""
    base = draws.base * 0.2 + 0.75
    u = base + draws.u * 0.1 - 0.05
    v = base + draws.v * 0.1 - 0.05
    identity = draws.coin < 0.5
    ones = torch.ones_like(u)
    return torch.where(identity, ones, u), torch.where(identity, ones, v)


def sample_resize_scales(generator: torch.Generator, n: int):
    """Draw step + core."""
    return resize_scales(draw_resize_scales(generator, n))


def _axis_index(scales: torch.Tensor, size: int):
    """Nearest-neighbour source index and paste mask along one axis."""
    new_size = torch.floor(size * scales + 0.5).to(torch.int64)  # (B,)
    used = torch.floor(size * scales).to(torch.int64)  # int(width * scale)
    start = (size - new_size) // 2
    rel = torch.arange(size, device=scales.device)[None, :] - start[:, None]
    inside = (rel >= 0) & (rel < used[:, None])
    # torch nearest-neighbour: src = floor(dst * in_size / out_size)
    src = (rel * size) // torch.clamp(new_size[:, None], min=1)
    return torch.clamp(src, 0, size - 1), inside


def resize_crop(dms: torch.Tensor, u_scales: torch.Tensor, v_scales: torch.Tensor) -> torch.Tensor:
    """Anisotropic shrink + centred paste on background 1.0, per sample.

    dms (B, H, W), scales (B,) in (0, 1]: nearest-neighbour resize to
    (round(H v), round(W u)), pasted centred (the torch ResizeCropImage
    shrink path, util_modules.py:396-423). A scale of exactly 1 on both axes
    is the identity. The index map is separable, so it is one gather."""
    batch, height, width = dms.shape
    src_u, in_u = _axis_index(u_scales, width)
    src_v, in_v = _axis_index(v_scales, height)
    rows = torch.arange(batch, device=dms.device)[:, None, None]
    gathered = dms[rows, src_v[:, :, None], src_u[:, None, :]]
    inside = in_v[:, :, None] & in_u[:, None, :]
    identity = ((u_scales >= 1.0) & (v_scales >= 1.0))[:, None, None]
    return torch.where(identity, dms, torch.where(inside, gathered, torch.ones_like(dms)))
