"""Import a reference estimator checkpoint (``.pth``) as flat flax params.

Counterpart of the JAX package's ``tools/import_torch_checkpoint.py``: peel
the usual envelopes (``state_dict``, ``model``, ``net``) and the
``module.`` prefixes of ``DataParallel``, map the reference's layout onto
the port's ``HourglassNet`` (``convert.reference_hourglass_state``, every
entry matched) and write the flat ``a/b/c``-keyed ``.npz`` in flax layout
that ``infer.load_params_npz`` of either package reads.

Usage: python -m spherehand_torch.tools.import_torch_checkpoint ckpt.pth out.npz [--num_stacks 2]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from spherehand_torch.convert import flatten_params, flax_params, reference_hourglass_state
from spherehand_torch.models.estimator import make_network
from spherehand_torch.train.priors import save_flax_params_npz


def unwrap_state_dict(ckpt) -> dict[str, np.ndarray]:
    """Peel common checkpoint envelopes down to a flat ``a/b/c`` -> array
    dict."""
    for key in ("state_dict", "model", "net"):
        if isinstance(ckpt, dict) and key in ckpt and isinstance(ckpt[key], dict):
            ckpt = ckpt[key]
    out = {}
    for k, v in ckpt.items():
        k = k.removeprefix("module.")
        out[k.replace(".", "/")] = np.asarray(
            v.detach().cpu().numpy() if hasattr(v, "detach") else v
        )
    return out


def import_checkpoint(pth_path: str, out_path: str, num_stacks: int) -> dict:
    """``pth_path`` -> ``out_path`` (flat ``.npz``); returns the nested flax
    param tree (numpy)."""
    # A released checkpoint may hold more than tensors (the reference saves
    # optimizer state and epochs beside them), as the JAX tool reads it.
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=False)
    network = make_network(num_stacks)
    network.load_state_dict(reference_hourglass_state(unwrap_state_dict(ckpt), num_stacks))
    params = flax_params(network)
    save_flax_params_npz(out_path, params)
    return params


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pth")
    ap.add_argument("out")
    ap.add_argument("--num_stacks", type=int, default=2)
    args = ap.parse_args(argv)
    params = import_checkpoint(args.pth, args.out, args.num_stacks)
    n = sum(a.size for a in flatten_params(params).values())
    print(f"imported {args.pth} -> {args.out} ({n:,} params, num_stacks={args.num_stacks})")


if __name__ == "__main__":
    main()
