"""Deterministic settings for the evidence runs.

A run of an evidence tool (``spherehand_torch/tools/``) is a claim about
what training does, so two runs of one seed must give the same bits, as the
JAX package's runs on a TPU do. :func:`enable` makes PyTorch refuse every op
whose result depends on scheduling, and pins cuBLAS's workspaces and cuDNN's
algorithms; the evidence tools call it first thing. The engine and the steps
keep PyTorch's defaults.

The port's own kernels sit outside PyTorch's check and are order-free by
design: the rasters take a z-min with ``atomicMin`` on order-preserving
keys, the sphere kernels and the upsample use no atomics (CHANGES.md lists
the audit).
"""
from __future__ import annotations

import os

import torch

CUBLAS_WORKSPACE_CONFIG = ":4096:8"


def enable() -> dict:
    """Switch this process to deterministic algorithms:

    - ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which cuBLAS reads when its first
      handle is made: raises if CUDA is already initialised without it;
    - ``torch.use_deterministic_algorithms(True)`` (an op with no
      deterministic implementation raises);
    - ``cudnn.deterministic = True``, ``cudnn.benchmark = False``.

    Returns the settings it replaced, for :func:`restore`.
    """
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != CUBLAS_WORKSPACE_CONFIG:
        if torch.cuda.is_initialized():
            raise RuntimeError(
                "deterministic mode needs CUBLAS_WORKSPACE_CONFIG="
                f"{CUBLAS_WORKSPACE_CONFIG} before CUDA is initialised (cuBLAS may already "
                "hold a handle); call determinism.enable() first or set it in the environment")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE_CONFIG
    saved = {"algorithms": torch.are_deterministic_algorithms_enabled(),
             "cudnn_deterministic": torch.backends.cudnn.deterministic,
             "cudnn_benchmark": torch.backends.cudnn.benchmark}
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return saved


def restore(saved: dict) -> None:
    """Put back the settings :func:`enable` replaced (the environment
    variable stays)."""
    torch.use_deterministic_algorithms(saved["algorithms"])
    torch.backends.cudnn.deterministic = saved["cudnn_deterministic"]
    torch.backends.cudnn.benchmark = saved["cudnn_benchmark"]
