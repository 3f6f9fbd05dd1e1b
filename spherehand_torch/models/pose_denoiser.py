"""Palm-pose denoiser MLP, the eval-time post-process.

Counterpart of ``spherehand_tpu/models/pose_denoiser.py`` (reference
network/pose_denoiser.py): a GroupNorm MLP that reads the 30 finger joints in
3D plus the 11 palm joints in 2D (112 inputs, x0.01) and rewrites the 11 palm
joints' 3D positions (33 outputs, /0.01). The frozen released weights and the
checkpoint's own index tables load from ``assets/pose_denoiser.npz``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from spherehand_torch.convert import load_denoiser
from spherehand_torch.device import resolve_device
from spherehand_torch.hand.assets import DEFAULT_ASSET_DIR


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
    own tables."""

    def __init__(self, num_inputs: int = 112, num_outputs: int = 33,
                 scale_factor: float = 0.01):
        super().__init__()
        self.scale_factor = scale_factor
        self.register_buffer("input_indices", torch.zeros(num_inputs, dtype=torch.int64))
        self.register_buffer("output_indices", torch.zeros(num_outputs, dtype=torch.int64))
        self.l0 = MlpBlock(num_inputs, 256)
        self.l1 = MlpBlock(256, 256)
        self.out = nn.Linear(256, num_outputs)

    def forward(self, joints: torch.Tensor) -> torch.Tensor:
        """joints (..., 41, 3) or (..., 123) in mm -> same shape, palm replaced."""
        flat = joints.reshape(-1, 123)
        x = flat[:, self.input_indices] * self.scale_factor
        out = self.out(self.l1(self.l0(x))) / self.scale_factor
        denoised = flat.clone()
        denoised[:, self.output_indices] = out
        return denoised.reshape(joints.shape)


def load_pose_denoiser(
    path: str | None = None, device: torch.device | str | None = None
) -> PoseDenoiser:
    """The released frozen denoiser on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    if path is None:
        path = os.path.join(DEFAULT_ASSET_DIR, "pose_denoiser.npz")
    with np.load(path) as raw:
        arrays = {k: raw[k] for k in raw.files}
    model = PoseDenoiser(len(arrays["input_indices"]), len(arrays["output_indices"]))
    return load_denoiser(model, arrays).to(dev).eval()
