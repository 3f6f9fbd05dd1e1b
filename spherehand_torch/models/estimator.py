"""Pose estimator forward: hourglass + soft-argmax (eval branch).

Counterpart of ``spherehand_tpu/models/estimator.py`` with ``train=False``:
the synthetic batch and the flattened real multi-view batch share one
hourglass forward. The train-time resize-crop augmentation arrives with the
training slice. Outputs use the (B, J, H, W) heatmap layout of the JAX
package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from spherehand_torch.constants import Constants
from spherehand_torch.models.hourglass import HourglassNet
from spherehand_torch.ops.softargmax import recover_xyz

_C = Constants()


class EstimatorOutput(NamedTuple):
    """Per-stack outputs; synt_* lead the batch, real_* are (B, V, ...)."""

    synt_uv_hms: tuple  # each (Bs, J, H, W)
    synt_d_hms: tuple
    synt_xyz: tuple     # each (Bs, J, 3)
    real_uv_hms: tuple  # each (Br, V, J, H, W)
    real_d_hms: tuple
    real_xyz: tuple     # each (Br, V, J, 3)
    synt_latent: tuple  # each (Bs, C, h, w)
    real_latent: tuple  # each (Br*V, C, h, w)


def make_network(num_stacks: int) -> HourglassNet:
    return HourglassNet(num_stacks=num_stacks, num_outputs=2 * _C.num_joints)


def forward(
    network: HourglassNet,
    synt_dms: torch.Tensor | None = None,
    real_dms: torch.Tensor | None = None,
) -> EstimatorOutput:
    """synt_dms (Bs, 64, 64) and/or real_dms (Br, V, 64, 64), scaled depth."""
    num_synt = 0 if synt_dms is None else synt_dms.shape[0]
    parts = [] if synt_dms is None else [synt_dms]
    num_real = num_view = 0
    if real_dms is not None:
        num_real, num_view = real_dms.shape[:2]
        parts.append(real_dms.reshape(-1, *real_dms.shape[2:]))

    scores, latents = network(torch.cat(parts, dim=0))
    out = {k: [] for k in EstimatorOutput._fields}
    for score in scores:
        uv, d = score[:, : _C.num_joints], score[:, _C.num_joints :]
        if num_synt:
            out["synt_uv_hms"].append(uv[:num_synt])
            out["synt_d_hms"].append(d[:num_synt])
            out["synt_xyz"].append(recover_xyz(uv[:num_synt], d[:num_synt]))
        if num_real:
            r_uv, r_d = uv[num_synt:], d[num_synt:]
            hm = (num_real, num_view) + r_uv.shape[1:]
            out["real_uv_hms"].append(r_uv.reshape(hm))
            out["real_d_hms"].append(r_d.reshape(hm))
            out["real_xyz"].append(
                recover_xyz(r_uv, r_d).reshape(num_real, num_view, _C.num_joints, 3)
            )
    for lat in latents:
        if num_synt:
            out["synt_latent"].append(lat[:num_synt])
        if num_real:
            out["real_latent"].append(lat[num_synt:])
    return EstimatorOutput(**{k: tuple(v) for k, v in out.items()})
