"""Multi-task loss assembly: the whole self-supervision objective.

Counterpart of ``spherehand_tpu/losses/multitask.py`` (reference
network/create_network_and_criterion.py:147-263): one function returning a
dict of loss terms with the same keys and weights. Quirks kept:

- collision and bone length on multi-view joints index the flattened (V*J)
  axis with 41-joint tables, so they see view 0 only
  (mesh/render.py:170-171,198-199);
- ``is_mv`` gates both the projection variant and the consistency weight;
- the temporal term compares consecutive batch elements with carried
  previous-skeleton state, passed in and returned;
- the domain term is computed at weight 0.0.

On one rank of several (``parallel.mesh``), ``real_total`` / ``synt_total``
are the batch's global row counts: every weighted mean divides by them, so
each term is the rank's exact share of the global term. The temporal term
takes each rank's first predecessor from the rank before it (``group``).
The domain term is a batch statistic without weights (means over (B, H, W),
then squared): on a rank it is the rank's own, at its weight 0.0.

The VAE prior takes its reparameterisation noise as an input (one (Br*V, 32)
tensor per stack, ``models.pose_vae.draw_vae_noise``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from spherehand_torch.losses.geometric import bone_length_loss, collision_loss
from spherehand_torch.losses.multiview import multiview_consistency_loss, mutual_projection_loss
from spherehand_torch.models.estimator import EstimatorOutput
from spherehand_torch.models.pose_vae import prior_loss
from spherehand_torch.ops.reduce import bmean

# Hardcoded weights (reference create_network_and_criterion.py:171-181).
LOSS_WEIGHTS = {
    "synt_hm": 1e3,
    "synt_pt": 1e-1,
    "mv_consistency": 1e-3,
    "mv_projection": 1.0,
    "temporal_smooth": 1.0,
    "prior": 1e-2,
    "hm_mean": 1e-2,
    "domain": 0.0,
    "collision": 1.0,
    "bone_length": 1.0,
}


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss toggles; defaults mirror run_engine.py's default-on flags."""

    synthesized: bool = True
    mv_projection: bool = True
    mv_consistency: bool = True
    temporal: bool = False
    prior: bool = True
    collision: bool = True
    bone_length: bool = True


def temporal_smoothness(joints: torch.Tensor, prev_skel: torch.Tensor, has_prev: torch.Tensor,
                        group=None):
    """Clamped L2 between consecutive-frame skeletons (util_modules.py:349-381).

    joints (B, V, J, 3); ``prev_skel`` the last skeleton of the previous
    batch, ``has_prev`` a bool tensor. Returns (loss, new_prev_skel,
    new_has_prev). Under a ``group`` (``parallel.mesh.RankGroup``) of
    contiguous row blocks, a rank's first row follows the last row of the
    rank before it, the mean divides by the global count of compared
    elements and the new state is the last rank's last row."""
    mask_total = None
    if group is not None and group.world > 1:
        lasts = group.rank_rows_of_last(joints[-1].detach())
        if group.rank > 0:
            prev_skel = lasts[group.rank - 1]
        mask_total = (joints.shape[0] * group.world - 1 + has_prev.to(joints.dtype))
        new_last = lasts[-1]
        has_prev = has_prev if group.rank == 0 else torch.ones_like(has_prev)
    prev = torch.cat([prev_skel[None], joints[:-1].detach()], dim=0)
    diff = torch.clamp(joints - prev, -2500.0, 2500.0)
    sq = diff * diff
    mask = torch.cat([has_prev.reshape(1).to(sq.dtype),
                      torch.ones(sq.shape[0] - 1, dtype=sq.dtype, device=sq.device)])
    per_elem = sq.reshape(sq.shape[0], -1)
    if mask_total is None:
        mask_total, new_last = mask.sum(), joints[-1].detach()
    loss = (per_elem * mask[:, None]).sum() / (mask_total * per_elem.shape[1])
    return loss, new_last, torch.ones((), dtype=torch.bool, device=joints.device)


def multitask_loss(
    cfg: LossConfig,
    output: EstimatorOutput,
    radii: torch.Tensor,
    vae: torch.nn.Module | None = None,
    synt_target: Any | None = None,
    real_target: dict | None = None,
    vae_noise: tuple | None = None,
    is_mv: bool | torch.Tensor = True,
    prev_skel: torch.Tensor | None = None,
    has_prev: torch.Tensor | None = None,
    real_weights: torch.Tensor | None = None,
    synt_weights: torch.Tensor | None = None,
    real_total=None,
    synt_total=None,
    group=None,
) -> tuple[dict, list, tuple]:
    """Assemble every enabled loss term.

    synt_target: a ``SyntheticBatch``; real_target: dict with ``real_dms``
    (B, V, H, W) in mm (unscaled), ``camera_poses``, ``inv_camera_poses``.
    vae_noise: one (B*V, 32) noise tensor per stack for the prior.
    real_total / synt_total / group: the global row counts and the rank
    group on one rank of several (None on one device).
    Returns (terms, projected_dms per stack, (new_prev_skel, new_has_prev)).
    """
    terms: dict[str, torch.Tensor] = {}
    has_real = real_target is not None and len(output.real_xyz) > 0
    has_synt = synt_target is not None and len(output.synt_xyz) > 0

    if cfg.synthesized and has_synt:
        terms["synt_uv"] = sum(
            LOSS_WEIGHTS["synt_hm"] * bmean((hm - synt_target.uv_hms) ** 2, synt_weights,
                                            synt_total)
            for hm in output.synt_uv_hms
        )
        target_z = synt_target.xyz[..., 2]
        terms["synt_d"] = sum(
            LOSS_WEIGHTS["synt_pt"] * bmean((xyz[..., 2] - target_z) ** 2, synt_weights,
                                            synt_total)
            for xyz in output.synt_xyz
        )

    projected_dms: list = []
    if cfg.mv_projection and has_real:
        total = 0.0
        for xyz in output.real_xyz:
            stack_loss, dms = mutual_projection_loss(
                real_target["camera_poses"], real_target["inv_camera_poses"], xyz,
                real_target["real_dms"], radii, is_mv=is_mv, weights=real_weights,
                total=real_total,
            )
            total = total + LOSS_WEIGHTS["mv_projection"] * stack_loss
            projected_dms.append(dms)
        terms["mv_projection"] = total

    if cfg.mv_consistency and has_real:
        dev = output.real_xyz[0].device
        w = torch.where(torch.as_tensor(is_mv, device=dev),
                        LOSS_WEIGHTS["mv_consistency"], 0.0).to(output.real_xyz[0].dtype)
        terms["mv_consistency"] = sum(
            w * multiview_consistency_loss(real_target["camera_poses"], xyz,
                                           weights=real_weights, total=real_total)
            for xyz in output.real_xyz
        )

    if has_real:
        terms["uv_hm_mean"] = sum(
            LOSS_WEIGHTS["hm_mean"] * bmean(hm * hm, real_weights, real_total)
            for hm in output.real_uv_hms
        )

    if cfg.prior and has_real:
        if vae is None or vae_noise is None or len(vae_noise) != len(output.real_xyz):
            raise ValueError("the prior term needs the VAE and one noise tensor per stack")
        num_views = output.real_xyz[0].shape[1]
        prior_w = None if real_weights is None else real_weights.repeat_interleave(num_views)
        prior_total = None if real_total is None else real_total * num_views
        terms["pose_prior"] = sum(
            LOSS_WEIGHTS["prior"] * prior_loss(vae, xyz / 100.0, noise, weights=prior_w,
                                               total=prior_total)
            for xyz, noise in zip(output.real_xyz, vae_noise)
        )

    new_prev: tuple = (prev_skel, has_prev)
    if cfg.temporal and has_real:
        if real_weights is not None:
            raise ValueError("temporal smoothness is incompatible with padded batches")
        total = 0.0
        for xyz in output.real_xyz:
            t_loss, prev_skel, has_prev = temporal_smoothness(xyz, prev_skel, has_prev, group)
            total = total + LOSS_WEIGHTS["temporal_smooth"] * t_loss
        terms["temporal_smooth"] = total
        new_prev = (prev_skel, has_prev)

    if cfg.collision and has_real:
        # view-0-only quirk: 41-joint pair tables over the flattened (V*J) axis
        terms["collision"] = sum(
            LOSS_WEIGHTS["collision"]
            * collision_loss(xyz.reshape(xyz.shape[0], -1, 3), weights=real_weights)
            for xyz in output.real_xyz
        )

    if cfg.bone_length and has_real:
        terms["bone_length"] = sum(
            LOSS_WEIGHTS["bone_length"]
            * bone_length_loss(xyz.reshape(xyz.shape[0], -1, 3), weights=real_weights,
                               total=real_total)
            for xyz in output.real_xyz
        )

    if output.synt_latent and output.real_latent:
        # latents are NCHW here (NHWC in the JAX package): mean over B, H, W
        terms["domain_loss"] = sum(
            LOSS_WEIGHTS["domain"]
            * ((s.mean(dim=(0, 2, 3)) - r.mean(dim=(0, 2, 3))) ** 2).mean()
            for s, r in zip(output.synt_latent, output.real_latent)
        )

    return terms, projected_dms, new_prev


def combine_loss(terms: dict) -> torch.Tensor:
    """Plain sum of all terms (reference create_network_and_criterion.py:278-282)."""
    total = 0.0
    for value in terms.values():
        total = total + value
    return total
