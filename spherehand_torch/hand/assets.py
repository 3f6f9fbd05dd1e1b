"""Hand model assets as a frozen dataclass of tensors.

Counterpart of ``spherehand_tpu/hand/assets.py``: the whole model is one
immutable record loaded once from ``assets/hand_model.npz`` and passed
explicitly into the kinematics, rendering and loss functions.

Model facts: 10,144 homogeneous vertices, 3,382 triangles, 17 bones and 41
skinned sphere keypoints with fixed radii (11 palm + 6 per finger).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from spherehand_torch.device import resolve_device

DEFAULT_ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets")


@dataclasses.dataclass(frozen=True)
class HandModel:
    """Static hand-model tensors, all on one device.

    ``skin_matrix[(j*4+n), v] = W[j, v] * rest[v, n]`` fuses skinning weights
    and rest vertices, so full-mesh LBS is one (B*4, 68) @ (68, V) product.
    ``skin_matrix_faces`` holds the same columns in face-vertex order
    (``skin_matrix[:, faces.flat]``), so the face assembly after skinning is
    a free reshape.
    """

    vertices: torch.Tensor         # (V, 4) homogeneous rest vertices
    faces: torch.Tensor            # (F, 3) int64, raster winding
    offset_mats: torch.Tensor      # (17, 4, 4) world -> bone-local at rest
    inv_offset_mats: torch.Tensor  # (17, 4, 4)
    skin_weights: torch.Tensor     # (17, V)
    skin_matrix: torch.Tensor      # (68, V)
    skin_matrix_faces: torch.Tensor  # (68, 3F)
    kp_local: torch.Tensor         # (41, 4) sphere centres at rest
    kp_bone: torch.Tensor          # (41,) int64 owning bone per sphere
    kp_radius: torch.Tensor        # (41,) sphere radii, mm
    right_hand: bool = True
    # Measured per-mesh bound of the TPU rasterizer's record truncation
    # (shipped in the asset npz). The CUDA kernels keep every face and do not
    # read it; it stays part of the asset record.
    raster_valid_frac: float = 1.0

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def num_bones(self) -> int:
        return self.offset_mats.shape[0]

    @property
    def num_keypoints(self) -> int:
        return self.kp_local.shape[0]


def _fuse_skin_matrix(weights: np.ndarray, vertices: np.ndarray) -> np.ndarray:
    num_bones, num_verts = weights.shape
    fused = weights[:, None, :] * vertices.T[None, :, :]  # (17, 4, V)
    return fused.reshape(num_bones * 4, num_verts)


def load_hand_model(
    path: str | None = None,
    right_hand: bool = True,
    device: torch.device | str | None = None,
) -> HandModel:
    """Load ``hand_model.npz`` as float32 tensors onto ``device`` (CUDA by
    default).

    The triangle index columns 0/1 are swapped for the right hand so the
    winding stays front-facing after the LBS x-negation.
    """
    dev = resolve_device(device)
    if path is None:
        path = os.path.join(DEFAULT_ASSET_DIR, "hand_model.npz")
    with np.load(path, allow_pickle=False) as raw:
        vertices = raw["vertices"].astype(np.float32)
        faces = raw["faces"].astype(np.int64)
        offset = raw["offset_mats"].astype(np.float32)
        weights = raw["skin_weights"].astype(np.float32)
        kp_local = raw["kp_local"].astype(np.float32)
        kp_bone = raw["kp_bone"].astype(np.int64)
        kp_radius = raw["kp_radius"].astype(np.float32)
        valid_frac = (
            float(raw["raster_valid_frac"])
            if "raster_valid_frac" in raw.files else 1.0
        )
    if right_hand:
        faces = faces[:, [1, 0, 2]]
    flat = faces.reshape(-1)
    inv_offset = np.linalg.inv(offset.astype(np.float64)).astype(np.float32)

    def t(a: np.ndarray, dt: torch.dtype = torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    return HandModel(
        vertices=t(vertices),
        faces=t(faces, torch.int64),
        offset_mats=t(offset),
        inv_offset_mats=t(inv_offset),
        skin_weights=t(weights),
        skin_matrix=t(_fuse_skin_matrix(weights, vertices)),
        skin_matrix_faces=t(_fuse_skin_matrix(weights[:, flat], vertices[flat])),
        kp_local=t(kp_local),
        kp_bone=t(kp_bone, torch.int64),
        kp_radius=t(kp_radius),
        right_hand=right_hand,
        raster_valid_frac=valid_frac,
    )
