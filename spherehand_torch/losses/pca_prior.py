"""PCA pose prior: projection-residual loss and reconstruction.

Counterpart of ``spherehand_tpu/losses/pca_prior.py`` (reference
network/util_modules.py:243-306). Both root-centre the skeleton (joint 0),
subtract the PCA mean and project onto the span of the components
(``x @ C^T C``). The products run in true float32: TF32 is switched off for
them on the card, as the JAX package passes ``Precision.HIGHEST``. The
arrays ship in ``assets/pose_prior_pca.npz`` (``hand.load_pose_prior_pca``).
"""
from __future__ import annotations

import torch

from spherehand_torch.infer import float32_precision


def _center_flatten(joints: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    root = joints[..., 0:1, :]
    return (joints - root).reshape(-1, joints.shape[-2] * 3), root


def _project(mean: torch.Tensor, components: torch.Tensor, flat: torch.Tensor):
    x = flat - mean[None, :]
    with float32_precision("highest"):
        return x, (x @ components.T) @ components


def pca_prior_loss(mean: torch.Tensor, components: torch.Tensor,
                   joints: torch.Tensor) -> torch.Tensor:
    """MSE between the centred joints and their PCA-subspace projection.
    joints (..., J, 3); mean (J*3,); components (K, J*3)."""
    flat, _ = _center_flatten(joints)
    x, proj = _project(mean, components, flat)
    return ((x - proj) ** 2).mean()


def pca_reconstruct(mean: torch.Tensor, components: torch.Tensor,
                    joints: torch.Tensor) -> torch.Tensor:
    """Project the joints into the PCA subspace and reconstruct (same shape)."""
    flat, root = _center_flatten(joints)
    _, proj = _project(mean, components, flat)
    return (proj + mean[None, :]).reshape(joints.shape) + root
