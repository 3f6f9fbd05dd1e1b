"""Carry the JAX package's weights across into the port's modules.

- Hourglass: flax params (nested dict of numpy arrays, e.g. from
  ``infer.load_params_npz``) -> ``HourglassNet`` state_dict. Conv ``kernel``
  HWIO -> ``weight`` OIHW, GroupNorm ``scale``/``bias`` -> ``weight``/``bias``,
  Dense ``kernel`` -> ``weight.T``; the flax path ``a/b/c`` names the module
  attribute ``a.b.c``.
- Denoiser: ``assets/pose_denoiser.npz`` is already in PyTorch layout, keyed
  by the reference ``nn.Sequential`` indices.

Each conversion consumes every source array and sets every module parameter
and buffer, or raises.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

# Reference nn.Sequential index -> PoseDenoiser submodule.
DENOISER_LAYERS = {
    "network/0": "l0.dense", "network/1": "l0.gn",
    "network/3": "l1.dense", "network/4": "l1.gn", "network/6": "out",
}


def flatten_params(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested flax param dict -> {'a/b/c': array}."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            flat.update(flatten_params(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _flax_to_torch(leaf: str, array: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "kernel":
        if array.ndim == 4:
            return "weight", array.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        return "weight", array.T  # Dense (in, out) -> (out, in)
    if leaf == "scale":
        return "weight", array
    return leaf, array


def _load_exact(module: nn.Module, state: dict[str, torch.Tensor]) -> None:
    """Load a state that must name exactly the module's entries."""
    expected = set(module.state_dict())
    missing, unused = expected - set(state), set(state) - expected
    if missing or unused:
        raise ValueError(
            f"weight conversion mismatch: missing {sorted(missing)}, unused {sorted(unused)}"
        )
    module.load_state_dict(state, strict=True)


def hourglass_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """Flax hourglass params -> the port's ``HourglassNet`` state_dict."""
    state = {}
    for path, array in flatten_params(params).items():
        *mods, leaf = path.split("/")
        name, value = _flax_to_torch(leaf, array)
        state[".".join(mods + [name])] = torch.from_numpy(np.ascontiguousarray(value))
    return state


def load_hourglass(module: nn.Module, params: dict) -> nn.Module:
    _load_exact(module, hourglass_state_dict(params))
    return module


def load_denoiser(module: nn.Module, arrays: dict[str, np.ndarray]) -> nn.Module:
    """``pose_denoiser.npz`` arrays (index tables included) -> module."""
    state = {}
    for key, array in arrays.items():
        if key in ("input_indices", "output_indices"):
            state[key] = torch.as_tensor(array, dtype=torch.int64)
            continue
        layer, leaf = key.rsplit("/", 1)
        if layer not in DENOISER_LAYERS:
            raise ValueError(f"unknown denoiser array {key}")
        state[f"{DENOISER_LAYERS[layer]}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(array))
    _load_exact(module, state)
    return module
