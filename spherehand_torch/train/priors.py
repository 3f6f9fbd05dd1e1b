"""Offline trainers of the frozen prior networks (VAE, denoiser) and the PCA
pose prior (``build_pca_prior``).

Counterpart of ``spherehand_tpu/train/priors.py`` (reference
network/pose_vae.py:140-189, network/pose_denoiser.py:98-150,
mesh/pose_prior.py:42-76), as plain step loops on the card. Every step
samples poses and skeletons on the device (``data.sampler`` ->
``hand.skeleton.skeleton_fk``), so no data loader runs.

- ``train_pose_vae`` and ``train_pose_denoiser``: ``torch.optim.Adam`` at lr
  1e-3 without decay (optax ``adam``), from a flax-like init (Dense kernels
  lecun-normal, biases 0, GroupNorm 1 / 0). Each returns the module and the
  loss of every step. One step is :func:`vae_step` / :func:`denoiser_step`,
  deterministic in its inputs.
- ``build_pca_prior``: each batch's sum and ``x^T x`` in float32 on the
  device (TF32 off), added up on the host in float64, then the eigh of the
  covariance. :func:`pca_prior_from_poses` is the core over given poses.
- ``save_flax_params_npz`` writes what the JAX function of that name writes:
  the flax ``a/b/c`` keys (``convert.flax_params`` gives the tree).
"""
from __future__ import annotations

import math
import os
from typing import Iterable

import numpy as np
import torch
from torch import nn

from spherehand_torch.data.sampler import sample_poses
from spherehand_torch.hand.assets import HandModel
from spherehand_torch.hand.skeleton import skeleton_fk
from spherehand_torch.infer import float32_precision
from spherehand_torch.models.pose_denoiser import PoseDenoiser, denoiser_loss, draw_denoiser_noise
from spherehand_torch.models.pose_vae import PoseVae, draw_vae_noise

# flax lecun_normal: a normal truncated at +-2 std, rescaled to unit variance
# (jax.nn.initializers.variance_scaling, "truncated_normal").
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Dense kernels lecun-normal (variance 1 / fan_in), biases 0, GroupNorm
    scale 1 and bias 0: the flax defaults of the JAX prior networks."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2.0 * std, b=2.0 * std,
                                  generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module


def vae_step(vae: PoseVae, optimizer: torch.optim.Optimizer, joints: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """One VAE step on skeletons (B, 41, 3) in mm (the net reads them / 100)
    with reparameterisation noise (B, 32); returns the loss before it."""
    x = (joints / 100.0).reshape(joints.shape[0], -1)
    _, _, _, likelihood = vae(x, noise)
    optimizer.zero_grad(set_to_none=True)
    likelihood.backward()
    optimizer.step()
    return likelihood.detach()


def denoiser_step(denoiser: PoseDenoiser, optimizer: torch.optim.Optimizer,
                  joints: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One denoiser step: clean skeletons (B, 41, 3) in, the input noise
    (B, 112) drawn by ``draw_denoiser_noise``; returns the loss before it."""
    loss = denoiser_loss(joints, denoiser(joints, noise))
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def _train(module, step, draw_noise, hand, steps, batch, lr, seed, log_every, tag):
    gen = torch.Generator(device=hand.device).manual_seed(seed)
    module = init_like_flax(module, torch.Generator().manual_seed(seed + 1)).to(hand.device)
    optimizer = torch.optim.Adam(module.parameters(), lr=lr)
    losses = []
    for i in range(steps):
        joints = skeleton_fk(hand, sample_poses(gen, batch))
        losses.append(step(module, optimizer, joints, draw_noise(gen, batch)))
        if log_every and i % log_every == 0:
            print(f"[{tag} {i}] loss {float(losses[-1]):.5f}")
    return module, torch.stack(losses)


def train_pose_vae(hand: HandModel, steps: int = 15_000, batch: int = 128, lr: float = 1e-3,
                   seed: int = 0, log_every: int = 1000) -> tuple[PoseVae, torch.Tensor]:
    """Train the pose VAE on sampled skeletons / 100, on the hand model's
    device. Returns (module, the loss of every step)."""
    return _train(PoseVae(), vae_step, draw_vae_noise, hand, steps, batch, lr, seed,
                  log_every, "vae")


def train_pose_denoiser(hand: HandModel, steps: int = 15_000, batch: int = 128,
                        lr: float = 1e-3, seed: int = 0, log_every: int = 1000
                        ) -> tuple[PoseDenoiser, torch.Tensor]:
    """Train the palm denoiser: noisy skeleton in, clean palm out, on the
    hand model's device. Returns (module, the loss of every step)."""
    return _train(PoseDenoiser(), denoiser_step, draw_denoiser_noise, hand, steps, batch, lr,
                  seed, log_every, "denoiser")


def pca_prior_from_poses(hand: HandModel, pose_batches: Iterable[torch.Tensor],
                         num_components: int = 30) -> tuple[np.ndarray, np.ndarray]:
    """PCA over the root-centred skeletons of the given pose batches (each
    (B, 26)): (mean (123,), components (num_components, 123)), float32."""
    dim = hand.num_keypoints * 3
    total = np.zeros(dim)
    outer = np.zeros((dim, dim))
    n = 0
    for poses in pose_batches:
        with float32_precision("highest"):
            joints = skeleton_fk(hand, poses.to(hand.device))
            flat = (joints - joints[:, 0:1]).reshape(joints.shape[0], -1)
            s, o = flat.sum(0), flat.T @ flat
        total += s.cpu().numpy().astype(np.float64)
        outer += o.cpu().numpy().astype(np.float64)
        n += flat.shape[0]
    mean = total / n
    cov = outer / n - np.outer(mean, mean)
    _, eigvecs = np.linalg.eigh(cov)
    components = eigvecs[:, ::-1][:, :num_components].T
    return mean.astype(np.float32), components.astype(np.float32)


def build_pca_prior(hand: HandModel, num_samples: int = 1_200_000, num_components: int = 30,
                    batch: int = 4096, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """PCA over ``num_samples // batch`` batches of sampled skeletons on the
    hand model's device (mesh/pose_prior.py:42-76, exact covariance instead
    of sklearn's fit)."""
    gen = torch.Generator(device=hand.device).manual_seed(seed)
    batches = (sample_poses(gen, batch) for _ in range(num_samples // batch))
    return pca_prior_from_poses(hand, batches, num_components)


def save_flax_params_npz(path: str, params: dict) -> None:
    """Flatten a flax param tree to 'a/b/c' keys in an .npz archive."""
    flat = {}

    def rec(prefix, tree):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                rec(key, v)
            else:
                flat[key] = np.asarray(v)

    rec("", params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)
