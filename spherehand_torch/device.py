"""Device selection for the port's entry points.

Every entry point runs on the GPU unless the caller names another device.
A machine without CUDA raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spherehand_torch runs on CUDA by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return dev
