"""Pose VAE prior: the learned pose-plausibility loss.

Counterpart of ``spherehand_tpu/models/pose_vae.py`` (reference
network/pose_vae.py:11-99): a 123-d (41 joints x 3, scaled by 1/100) VAE
with GroupNorm MLP encoder and decoder and a 32-d latent. The frozen
released weights load from ``assets/pose_vae.npz`` (already in PyTorch
layout) through ``convert.load_pose_vae``.

The prior loss is reconstruction MSE (mean) + KL divergence (sum), with the
reparameterisation std scaled by 0.1. Following the port's RNG rule,
:func:`draw_vae_noise` draws the standard normals and :func:`prior_loss`
takes them as an input.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from spherehand_torch.convert import load_pose_vae
from spherehand_torch.device import resolve_device
from spherehand_torch.hand.assets import DEFAULT_ASSET_DIR
from spherehand_torch.models.pose_denoiser import MlpBlock
from spherehand_torch.ops.reduce import bmean, bsum

LATENT = 32


class PoseVae(nn.Module):
    def __init__(self, pose_features: int = 123, latent_features: int = LATENT):
        super().__init__()
        self.enc0 = MlpBlock(pose_features, 256)
        self.enc1 = MlpBlock(256, 256)
        self.mu = nn.Linear(256, latent_features)
        self.logvar = nn.Linear(256, latent_features)
        self.dec0 = MlpBlock(latent_features, 256)
        self.dec1 = MlpBlock(256, 256)
        self.dec_out = nn.Linear(256, pose_features)

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None):
        """x (B, 123) -> (recon, mu, logvar, likelihood). ``noise`` (B, 32)
        standard normals reparameterise the latent; ``None`` decodes mu."""
        h = self.enc1(self.enc0(x))
        mu, logvar = self.mu(h), self.logvar(h)
        z = mu if noise is None else mu + noise * (torch.exp(0.5 * logvar) * 0.1)
        recon = self.decode(z)
        return recon, mu, logvar, self.likelihood(x, recon, mu, logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latent (B, 32) -> pose (B, 123)."""
        return self.dec_out(self.dec1(self.dec0(z)))

    @staticmethod
    def likelihood(x, recon, mu, logvar) -> torch.Tensor:
        """Recon MSE (mean) + KLD (sum) (reference pose_vae.py:55-62)."""
        recon_loss = ((x - recon) ** 2).mean()
        kld = -0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar)).sum()
        return recon_loss + kld


def draw_vae_noise(generator: torch.Generator, rows: int, latent: int = LATENT) -> torch.Tensor:
    """(rows, latent) standard normals on the generator's device, drawn row
    by row: row i's noise does not depend on how many rows follow it, as the
    JAX package's per-row keys (pose_vae.py:53-64)."""
    dev = generator.device
    return torch.stack([torch.randn(latent, generator=generator, device=dev) for _ in range(rows)])


def prior_loss(
    vae: PoseVae,
    joints: torch.Tensor,
    noise: torch.Tensor,
    weights: torch.Tensor | None = None,
    total=None,
) -> torch.Tensor:
    """VAE prior loss on joints already divided by 100: (..., 41, 3) or
    (..., 123), flattened to (N, 123), always reparameterised with ``noise``
    (N, 32). ``weights`` (N,) marks padded rows with 0; ``total`` is the
    global row count on one rank of several (``ops.reduce``)."""
    x = joints.reshape(-1, vae.dec_out.out_features)
    recon, mu, logvar, likelihood = vae(x, noise)
    if weights is None and total is None:
        return likelihood
    recon_loss = bmean((x - recon) ** 2, weights, total)
    kld = -0.5 * bsum(1.0 + logvar - mu * mu - torch.exp(logvar), weights)
    return recon_loss + kld


def load_pose_vae_model(path: str | None = None,
                        device: torch.device | str | None = None) -> PoseVae:
    """The released frozen VAE on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    if path is None:
        path = os.path.join(DEFAULT_ASSET_DIR, "pose_vae.npz")
    with np.load(path) as raw:
        arrays = {k: raw[k] for k in raw.files}
    model = load_pose_vae(PoseVae(), arrays).to(dev).eval()
    for p in model.parameters():
        p.requires_grad_(False)
    return model
