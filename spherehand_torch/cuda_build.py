"""Build the port's CUDA sources into shared libraries with a plain C interface.

Each ``csrc/*.cu`` file is compiled on its own with nvcc into
``spherehand_torch/build/`` at first use, then loaded with ``ctypes``. The
library's file name carries a hash of the source and the flags, so an
unchanged source is built once per checkout. :func:`build_all` starts one
nvcc per source at the same time; :func:`launch` calls a library's C entry
point on PyTorch's current stream.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("raster", "sphere", "upsample")  # csrc/<name>.cu
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # No FMA contraction: span bounds (ceil/trunc), depth bits, sphere
    # argmins and the upsample's sums must round like the plain PyTorch
    # versions, one operation at a time.
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")
    return found


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, for the source as it is now."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as fh:
        src = fh.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libshx_{name}_{digest}.so")


def build_all(names) -> dict[str, tuple[str, str]]:
    """Compile ``csrc/<name>.cu`` for every name not built yet, one nvcc
    process each, all started together. Returns {name: (library path,
    compiler log: ptxas registers, shared memory and spills per kernel)};
    the log is empty for a library that was already built."""
    out, running = {}, {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            out[name] = (path, "")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        running[name] = (proc, tmp, path)
    errors = []
    for name, (proc, tmp, path) in running.items():
        _, log = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = (path, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build(name: str) -> tuple[str, str]:
    """Compile one source (see :func:`build_all`)."""
    return build_all([name])[name]


def launch(fn, device, *args) -> int:
    """Call ``fn(*args, stream)`` on ``device``'s current stream, with that
    device current; returns the entry point's error code."""
    import torch

    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)
