"""Inference API: depth crops -> 3D hand joints (the serving surface).

Counterpart of ``spherehand_tpu/infer.py``: hourglass forward on scaled 64x64
depth crops, soft-argmax recovery from the final stack, optional palm
denoising and optional template palm adjustment. Large batches run as a loop
over ``serve_chunk``-sized chunks, the last one padded (pad rows are dropped
before returning). :func:`load_estimator` serves a checkpoint of the port's
engine. ``devices=[...]`` serves data-parallel, the counterpart of the JAX
``mesh=``: one replica a device, the batch split into contiguous blocks.
"""
from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch
from torch import nn

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
        carried across by ``convert.load_hourglass``; or a port network
        (``models.estimator.make_network``) holding its weights.
    num_stacks: stack count the params were trained with.
    denoise: apply the frozen palm denoiser MLP to the output.
    serve_chunk: batches above this size run chunk by chunk, the last chunk
        padded with leading rows; per-sample outputs do not depend on it.
    precision: ``None`` = PyTorch defaults (cuDNN convs may use TF32 on the
        GPU); ``"highest"`` = true-f32 convs and matmuls, parity grade.
    device: where the network runs; CUDA by default.
    devices: serve data-parallel over these devices (the JAX ``mesh=``;
        e.g. ``["cuda:0", "cuda:1"]``): one replica of the network and the
        denoiser a device; the host batch is padded to a multiple of the
        device count by repeating its last row, each device takes a
        contiguous block of rows and runs the chunked predictor on it
        (``serve_chunk`` per device), every device's work is launched before
        the first result is read back, and the pad rows are dropped. None
        (the default) serves on ``device`` alone.
    """

    def __init__(self, params: dict, num_stacks: int = 1, denoise: bool = True,
                 serve_chunk: int = 128, precision: str | None = None,
                 device: torch.device | str | None = None, devices: list | None = None):
        if precision not in (None, "highest"):
            raise ValueError(f"precision must be None or 'highest', got {precision!r}")
        if devices is not None and not devices:
            raise ValueError("devices must name at least one device")
        self.device = resolve_device(device if devices is None else devices[0])
        network = params if isinstance(params, nn.Module) else load_hourglass(
            make_network(num_stacks), params)
        self.network = network.to(self.device).eval()
        self.denoiser = load_pose_denoiser(device=self.device) if denoise else None
        self.serve_chunk = serve_chunk
        self.precision = precision
        # (device, network, denoiser) a device; the first is the one above.
        self.replicas = [(self.device, self.network, self.denoiser)]
        for dev in [resolve_device(d) for d in (devices or [])[1:]]:
            self.replicas.append((dev, copy.deepcopy(self.network).to(dev),
                                  None if self.denoiser is None
                                  else copy.deepcopy(self.denoiser).to(dev)))

    @staticmethod
    @torch.no_grad()
    def _predict_chunk(network, denoiser, dms: torch.Tensor):
        out = forward(network, real_dms=dms[:, None])
        joints = out.real_xyz[-1][:, 0]
        if denoiser is not None:
            joints = denoiser(joints)
        return joints, out.real_uv_hms[-1][:, 0]

    def _predict_local(self, replica, dms: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Scaled crops (B, 64, 64) on a replica's device -> joints (B, 41,
        3) and uv heatmaps (B, 41, 16, 16), on the device, chunk by chunk."""
        _, network, denoiser = replica
        b = dms.shape[0]
        if b <= self.serve_chunk:
            return self._predict_chunk(network, denoiser, dms)
        pad = (-b) % self.serve_chunk
        if pad:
            dms = torch.cat([dms, dms[:pad]], dim=0)
        outs = [self._predict_chunk(network, denoiser, c) for c in dms.split(self.serve_chunk)]
        return torch.cat([o[0] for o in outs])[:b], torch.cat([o[1] for o in outs])[:b]

    def _predict(self, depth_mm) -> tuple[torch.Tensor, torch.Tensor]:
        """Crops in mm -> joints and heatmaps on the host: each replica's
        block launched in turn, then all read back."""
        if isinstance(depth_mm, torch.Tensor):
            host = depth_mm.to(dtype=torch.float32)
        else:
            host = torch.as_tensor(np.asarray(depth_mm, np.float32))
        b, n = host.shape[0], len(self.replicas)
        pad = (-b) % n
        if pad:  # the JAX _pad_to_mesh: repeat the last row
            host = torch.cat([host, host[-1:].expand(pad, *host.shape[1:])])
        with float32_precision(self.precision):
            outs = [self._predict_local(rep, block.to(rep[0], non_blocking=True)
                                        * _C.depth_scale)
                    for rep, block in zip(self.replicas, host.chunk(n))]
        joints = torch.cat([o[0].cpu() for o in outs])[:b]
        heatmaps = torch.cat([o[1].cpu() for o in outs])[:b]
        return joints, heatmaps

    def predict(self, depth_mm, palm_adjust: bool = False) -> np.ndarray:
        """Depth crops (B, 64, 64) in mm (background 100) -> joints (B, 41, 3).

        Input follows the NYU crop convention (300 mm cube, orthographic).
        """
        joints, _ = self._predict(depth_mm)
        joints = joints.numpy()
        if palm_adjust:
            joints = np.stack([adjust_palm_pose(j) for j in joints])
        return joints

    def predict_with_heatmaps(self, depth_mm) -> tuple[np.ndarray, np.ndarray]:
        joints, heatmaps = self._predict(depth_mm)
        return joints.numpy(), heatmaps.numpy()


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


def check_stacks(ckpt: dict, num_stacks: int, path: str) -> None:
    """Refuse a checkpoint whose recorded stack count is not ``num_stacks``
    (checkpoints written before the count was recorded are not checked)."""
    held = ckpt.get("num_stacks", num_stacks)
    if held != num_stacks:
        raise ValueError(f"{path} holds a {held}-stack network; asked for {num_stacks} "
                         "(--num_stacks)")


def load_estimator(checkpoint_path: str, num_stacks: int = 1, denoise: bool = True,
                   device: torch.device | str | None = None,
                   precision: str | None = None) -> PoseEstimator:
    """A :class:`PoseEstimator` from a checkpoint of the port's engine
    (``model_{epoch}.pt``, ``train.engine.Engine.save_checkpoint``); CUDA
    by default. The JAX package's Orbax checkpoints are not read:
    ``convert`` carries JAX parameters across as numpy."""
    dev = resolve_device(device)
    ckpt = torch.load(checkpoint_path, map_location=dev, weights_only=True)
    check_stacks(ckpt, num_stacks, checkpoint_path)
    network = make_network(num_stacks)
    network.load_state_dict(ckpt["network"])
    return PoseEstimator(network, num_stacks=num_stacks, denoise=denoise, precision=precision,
                         device=dev)
