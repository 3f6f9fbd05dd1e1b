"""Inference API: depth crops -> 3D hand joints (the serving surface).

Counterpart of ``spherehand_tpu/infer.py``: hourglass forward on scaled 64x64
depth crops, soft-argmax recovery from the final stack, optional palm
denoising and optional template palm adjustment. Large batches run as a loop
over ``serve_chunk``-sized chunks, the last one padded (pad rows are dropped
before returning). Data-parallel serving (``mesh=``) and ``load_estimator``
(an Orbax checkpoint) are not ported yet.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from spherehand_torch.constants import Constants
from spherehand_torch.convert import load_hourglass
from spherehand_torch.device import resolve_device
from spherehand_torch.evaluation.palm_adjust import adjust_palm_pose
from spherehand_torch.models.estimator import forward, make_network
from spherehand_torch.models.pose_denoiser import load_pose_denoiser

_C = Constants()


@contextlib.contextmanager
def float32_precision(precision: str | None):
    """``"highest"``: switch TF32 off for matmuls and cuDNN convs for the
    duration (the counterpart of the JAX package's ``precision="highest"``);
    ``None`` keeps the backend defaults."""
    if precision is None:
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class PoseEstimator:
    """Predictor around the port's hourglass and denoiser.

    params: flax hourglass params as nested numpy dicts (``load_params_npz``),
        carried across by ``convert.load_hourglass``.
    num_stacks: stack count the params were trained with.
    denoise: apply the frozen palm denoiser MLP to the output.
    serve_chunk: batches above this size run chunk by chunk, the last chunk
        padded with leading rows; per-sample outputs do not depend on it.
    precision: ``None`` = PyTorch defaults (cuDNN convs may use TF32 on the
        GPU); ``"highest"`` = true-f32 convs and matmuls, parity grade.
    device: where the network runs; CUDA by default.
    """

    def __init__(self, params: dict, num_stacks: int = 1, denoise: bool = True,
                 serve_chunk: int = 128, precision: str | None = None,
                 device: torch.device | str | None = None):
        if precision not in (None, "highest"):
            raise ValueError(f"precision must be None or 'highest', got {precision!r}")
        self.device = resolve_device(device)
        self.network = load_hourglass(make_network(num_stacks), params).to(self.device).eval()
        self.denoiser = load_pose_denoiser(device=self.device) if denoise else None
        self.serve_chunk = serve_chunk
        self.precision = precision

    @torch.no_grad()
    def _predict_chunk(self, dms: torch.Tensor):
        out = forward(self.network, real_dms=dms[:, None])
        joints = out.real_xyz[-1][:, 0]
        if self.denoiser is not None:
            joints = self.denoiser(joints)
        return joints, out.real_uv_hms[-1][:, 0]

    def _predict(self, dms: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Scaled crops (B, 64, 64) on the estimator's device -> joints
        (B, 41, 3) and uv heatmaps (B, 41, 16, 16), on the device."""
        b = dms.shape[0]
        with float32_precision(self.precision):
            if b <= self.serve_chunk:
                return self._predict_chunk(dms)
            pad = (-b) % self.serve_chunk
            if pad:
                dms = torch.cat([dms, dms[:pad]], dim=0)
            outs = [self._predict_chunk(c) for c in dms.split(self.serve_chunk)]
        joints = torch.cat([o[0] for o in outs])[:b]
        heatmaps = torch.cat([o[1] for o in outs])[:b]
        return joints, heatmaps

    def _scaled(self, depth_mm) -> torch.Tensor:
        if isinstance(depth_mm, torch.Tensor):
            dms = depth_mm.to(self.device, torch.float32)
        else:
            dms = torch.as_tensor(np.asarray(depth_mm, np.float32), device=self.device)
        return dms * _C.depth_scale

    def predict(self, depth_mm, palm_adjust: bool = False) -> np.ndarray:
        """Depth crops (B, 64, 64) in mm (background 100) -> joints (B, 41, 3).

        Input follows the NYU crop convention (300 mm cube, orthographic).
        """
        joints, _ = self._predict(self._scaled(depth_mm))
        joints = joints.cpu().numpy()
        if palm_adjust:
            joints = np.stack([adjust_palm_pose(j) for j in joints])
        return joints

    def predict_with_heatmaps(self, depth_mm) -> tuple[np.ndarray, np.ndarray]:
        joints, heatmaps = self._predict(self._scaled(depth_mm))
        return joints.cpu().numpy(), heatmaps.cpu().numpy()


def load_params_npz(path: str) -> dict:
    """Load flax params from a flattened 'a/b/c'-keyed .npz archive (e.g.
    ``assets/pretrained/synthetic_params.npz``) into nested numpy dicts."""
    tree: dict = {}
    with np.load(path) as raw:
        for key in raw.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = raw[key]
    return tree
