"""Carry the JAX package's weights across into the port's modules.

- Hourglass: flax params (nested dict of numpy arrays, e.g. from
  ``infer.load_params_npz``) -> ``HourglassNet`` state_dict. Conv ``kernel``
  HWIO -> ``weight`` OIHW, GroupNorm ``scale``/``bias`` -> ``weight``/``bias``,
  Dense ``kernel`` -> ``weight.T``; the flax path ``a/b/c`` names the module
  attribute ``a.b.c``.
- Denoiser and pose VAE: ``assets/pose_denoiser.npz`` and
  ``assets/pose_vae.npz`` are already in PyTorch layout, keyed by the
  reference ``nn.Sequential`` indices.
- Back to flax: :func:`flax_arrays` maps a ``HourglassNet`` state (weights
  or gradients) onto the flax keys and layouts, so that the port's
  gradients compare with the JAX package's; :func:`flax_params` gives the
  nested flax param tree of a ``PoseVae`` or ``PoseDenoiser`` (their
  submodules carry the flax names), which ``train.priors`` saves, and
  :func:`load_flax_params` reads such a tree back.

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
# Reference nn.Sequential index -> PoseVae submodule.
VAE_LAYERS = {
    "base/0": "enc0.dense", "base/1": "enc0.gn", "base/3": "enc1.dense",
    "base/4": "enc1.gn", "mu": "mu", "logvar": "logvar",
    "decoder/0": "dec0.dense", "decoder/1": "dec0.gn", "decoder/3": "dec1.dense",
    "decoder/4": "dec1.gn", "decoder/6": "dec_out",
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
        state[".".join(mods + [name])] = torch.from_numpy(np.array(value, order="C"))
    return state


def load_hourglass(module: nn.Module, params: dict) -> nn.Module:
    _load_exact(module, hourglass_state_dict(params))
    return module


def flax_arrays(named: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Module entries ({'a.b.weight': tensor}, e.g. parameters or their
    gradients) -> {'a/b/kernel': array} in flax layout: conv weight OIHW ->
    kernel HWIO, Dense weight (out, in) -> kernel (in, out), GroupNorm
    weight -> scale."""
    out = {}
    for name, tensor in named.items():
        *mods, leaf = name.split(".")
        array = tensor.detach().cpu().numpy()
        if leaf == "weight" and array.ndim == 4:
            leaf, array = "kernel", array.transpose(2, 3, 1, 0)
        elif leaf == "weight" and array.ndim == 2:
            leaf, array = "kernel", np.ascontiguousarray(array.T)
        elif leaf == "weight" and array.ndim == 1:
            leaf = "scale"
        elif leaf != "bias":
            raise ValueError(f"no flax counterpart for {name} {array.shape}")
        out["/".join(mods + [leaf])] = array
    return out


def flax_params(module: nn.Module) -> dict:
    """The nested flax param tree ({'enc0': {'dense': {'kernel': ...}}}) of
    a module whose submodules carry the flax names (``PoseVae``,
    ``PoseDenoiser``); buffers (the denoiser's index tables) are not
    parameters and stay out, as in flax."""
    tree: dict = {}
    for path, array in flax_arrays(dict(module.named_parameters())).items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = array
    return tree


def load_flax_params(module: nn.Module, params: dict) -> nn.Module:
    """A flax param tree (as :func:`flax_params` gives) -> ``module``'s
    parameters; its buffers keep their values."""
    state = {**hourglass_state_dict(params), **dict(module.named_buffers())}
    _load_exact(module, state)
    return module


def train_state_from_params(init_state, params: dict):
    """A train state of ``train.steps.build_steps`` whose network holds the
    flax hourglass ``params`` (nested numpy dicts): ``init_state`` builds the
    state, the weights are then copied in place."""
    state = init_state(torch.Generator().manual_seed(0))
    _load_exact(state.network, hourglass_state_dict(params))
    return state


def load_pose_vae(module: nn.Module, arrays: dict[str, np.ndarray]) -> nn.Module:
    """``pose_vae.npz`` arrays -> ``models.pose_vae.PoseVae``."""
    state = {}
    for key, array in arrays.items():
        layer, leaf = key.rsplit("/", 1)
        if layer not in VAE_LAYERS:
            raise ValueError(f"unknown pose VAE array {key}")
        state[f"{VAE_LAYERS[layer]}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(array))
    _load_exact(module, state)
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
