"""Palm-pose denoiser MLP, the eval-time post-process.

Counterpart of ``spherehand_tpu/models/pose_denoiser.py`` (reference
network/pose_denoiser.py): a GroupNorm MLP that reads the 30 finger joints in
3D plus the 11 palm joints in 2D (112 inputs, x0.01) and rewrites the 11 palm
joints' 3D positions (33 outputs, /0.01). The frozen released weights and the
checkpoint's own index tables load from ``assets/pose_denoiser.npz``; a fresh
module holds the current reference layout (``INPUT_INDICES`` /
``OUTPUT_INDICES``). At train time the input takes N(0, 0.1^2) noise, drawn
by :func:`draw_denoiser_noise` (the port's RNG rule).
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from spherehand_torch.convert import load_denoiser
from spherehand_torch.device import resolve_device
from spherehand_torch.hand.assets import DEFAULT_ASSET_DIR

# Input and output index tables (reference pose_denoiser.py:12-19) into the
# flattened (41, 3) joint vector: finger x, y, z blocks then palm x, y in;
# palm xyz out.
_FINGER = np.arange(11, 41)
_PALM = np.arange(11)
INPUT_INDICES = np.concatenate(
    [_FINGER * 3, _FINGER * 3 + 1, _FINGER * 3 + 2, _PALM * 3, _PALM * 3 + 1])
OUTPUT_INDICES = np.stack([_PALM * 3, _PALM * 3 + 1, _PALM * 3 + 2], axis=1).reshape(-1)
NOISE_STD = 0.1


class MlpBlock(nn.Module):
    """Linear -> GroupNorm(16) -> ReLU (``MlpBlock`` of models/pose_vae.py)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.dense = nn.Linear(in_features, features)
        self.gn = nn.GroupNorm(16, features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.gn(self.dense(x)))


class PoseDenoiser(nn.Module):
    """Index tables are buffers: the released checkpoint was trained with an
    older input layout than the reference source defaults, and restores its
    own tables. A fresh module holds the default tables."""

    def __init__(self, scale_factor: float = 0.01):
        super().__init__()
        self.scale_factor = scale_factor
        # copies: loading a checkpoint writes its own tables into the buffers
        self.register_buffer("input_indices", torch.tensor(INPUT_INDICES, dtype=torch.int64))
        self.register_buffer("output_indices", torch.tensor(OUTPUT_INDICES, dtype=torch.int64))
        num_inputs, num_outputs = len(INPUT_INDICES), len(OUTPUT_INDICES)
        self.l0 = MlpBlock(num_inputs, 256)
        self.l1 = MlpBlock(256, 256)
        self.out = nn.Linear(256, num_outputs)

    def forward(self, joints: torch.Tensor, noise: torch.Tensor | None = None) -> torch.Tensor:
        """joints (..., 41, 3) or (..., 123) in mm -> same shape, palm replaced.
        ``noise`` (rows, inputs) standard normals, x 0.1 onto the scaled
        input: the train-time form (``None`` at eval)."""
        flat = joints.reshape(-1, 123)
        x = flat[:, self.input_indices] * self.scale_factor
        if noise is not None:
            x = x + noise * NOISE_STD
        out = self.out(self.l1(self.l0(x))) / self.scale_factor
        denoised = flat.clone()
        denoised[:, self.output_indices] = out
        return denoised.reshape(joints.shape)


def draw_denoiser_noise(generator: torch.Generator, rows: int,
                        inputs: int = len(INPUT_INDICES)) -> torch.Tensor:
    """(rows, inputs) standard normals on the generator's device: the
    train-time input noise (the JAX package draws it batch-shaped from one
    key, pose_denoiser.py:56-57)."""
    return torch.randn((rows, inputs), generator=generator, device=generator.device)


def denoiser_loss(gt: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """MSE over the palm outputs (reference pose_denoiser.py:75-81)."""
    out = torch.as_tensor(OUTPUT_INDICES, device=gt.device)
    return ((gt.reshape(-1, 123)[:, out] - est.reshape(-1, 123)[:, out]) ** 2).mean()


def load_pose_denoiser(
    path: str | None = None, device: torch.device | str | None = None
) -> PoseDenoiser:
    """The released frozen denoiser on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    if path is None:
        path = os.path.join(DEFAULT_ASSET_DIR, "pose_denoiser.npz")
    with np.load(path) as raw:
        arrays = {k: raw[k] for k in raw.files}
    return load_denoiser(PoseDenoiser(), arrays).to(dev).eval()
