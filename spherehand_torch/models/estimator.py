"""Pose estimator forward: hourglass + soft-argmax.

Counterpart of ``spherehand_tpu/models/estimator.py``: the synthetic batch
and the flattened real multi-view batch share one hourglass forward. Given
resize scales, the real branch sees the train-time resize-crop augmentation
and the recovered x and y are divided back by the scales (reference
create_network_and_criterion.py:42-61,124-126). The scales are an argument
(draw them with ``data.noise.sample_resize_scales``), so a caller can feed
any draws. Outputs use the (B, J, H, W) heatmap layout of the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from spherehand_torch.constants import Constants
from spherehand_torch.data.noise import resize_crop
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
    real_resized_dms: torch.Tensor | None  # (Br*V, H, W) augmented inputs
    synt_latent: tuple  # each (Bs, C, h, w)
    real_latent: tuple  # each (Br*V, C, h, w)


def make_network(num_stacks: int, dtype: torch.dtype = torch.float32) -> HourglassNet:
    """``dtype``: the convolutions' compute dtype (``torch.bfloat16`` for
    ``--bf16``); heads, soft-argmax and the loss stack stay float32."""
    return HourglassNet(num_stacks=num_stacks, num_outputs=2 * _C.num_joints, dtype=dtype)


def forward(
    network: HourglassNet,
    synt_dms: torch.Tensor | None = None,
    real_dms: torch.Tensor | None = None,
    scales: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> EstimatorOutput:
    """synt_dms (Bs, 64, 64) and/or real_dms (Br, V, 64, 64), scaled depth;
    ``scales`` = (u, v), each (Br*V,), turns on the real branch's
    resize-crop."""
    num_synt = 0 if synt_dms is None else synt_dms.shape[0]
    parts = [] if synt_dms is None else [synt_dms]
    num_real = num_view = 0
    resized = None
    if real_dms is not None:
        num_real, num_view = real_dms.shape[:2]
        flat_real = real_dms.reshape(-1, *real_dms.shape[2:])
        if scales is not None:
            flat_real = resized = resize_crop(flat_real, *scales)
        parts.append(flat_real)

    scores, latents = network(torch.cat(parts, dim=0))
    out = {k: [] for k in EstimatorOutput._fields if k != "real_resized_dms"}
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
            xyz = recover_xyz(r_uv, r_d)
            if scales is not None:
                u, v = scales
                xyz = torch.stack(
                    [xyz[..., 0] / u[:, None], xyz[..., 1] / v[:, None], xyz[..., 2]], dim=-1)
            out["real_xyz"].append(xyz.reshape(num_real, num_view, _C.num_joints, 3))
    for lat in latents:
        if num_synt:
            out["synt_latent"].append(lat[:num_synt])
        if num_real:
            out["real_latent"].append(lat[num_synt:])
    return EstimatorOutput(real_resized_dms=resized, **{k: tuple(v) for k, v in out.items()})
