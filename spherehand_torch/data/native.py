"""ctypes binding of the native data-loader library (``native/shx_loader.cc``).

Counterpart of ``spherehand_tpu/data/native.py``: PNG depth decode and
metric-cube cropping over a C++ thread pool, the cost of offline NYU
preprocessing (~220k images). This is host preprocessing, not a kernel.

The library builds at first use with g++ from the committed source into
``spherehand_torch/build/`` (gitignored); nothing is written into
``native/``. Every entry point has a numpy fallback in
:mod:`spherehand_torch.data.nyu`, so the port runs without a compiler too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "shx_loader.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lpng", "-lz", "-lpthread")

_lib = None


def library_path() -> str:
    """Where the source as it is now builds to (a hash of the source and
    the flags in the name, so a changed source builds anew)."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libshx_loader_{digest}.so")


def _build_library(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp, *LIBS], check=True,
                   capture_output=True, timeout=300)
    os.replace(tmp, path)


def load_library(rebuild: bool = False) -> ctypes.CDLL:
    """Load (building if necessary) the native loader library."""
    global _lib
    if _lib is not None and not rebuild:
        return _lib
    path = library_path()
    if rebuild or not os.path.exists(path):
        _build_library(path)
    lib = ctypes.CDLL(path)
    lib.shx_decode_depth_png.restype = ctypes.c_int
    lib.shx_decode_depth_png.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.shx_crop_depth.restype = None
    lib.shx_crop_depth.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.shx_decode_crop_batch.restype = ctypes.c_int
    lib.shx_decode_crop_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    _lib = lib
    return lib


def available() -> bool:
    try:
        load_library()
        return True
    except Exception:
        return False


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_depth_png(path: str, height: int = 480, width: int = 640) -> np.ndarray:
    lib = load_library()
    out = np.empty((height, width), np.float32)
    rc = lib.shx_decode_depth_png(path.encode(), _fptr(out), height, width)
    if rc != 0:
        raise IOError(f"shx_decode_depth_png({path}) failed with code {rc}")
    return out


def crop_depth(
    dm: np.ndarray,
    center: np.ndarray,
    fx: float = 588.235,
    fy: float = 587.084,
    cx: float = 320.0,
    cy: float = 240.0,
    cube: float = 300.0,
    out_size: int = 64,
    background: float = 100.0,
) -> np.ndarray:
    lib = load_library()
    dm = np.ascontiguousarray(dm, np.float32)
    center = np.ascontiguousarray(center, np.float32)
    out = np.empty((out_size, out_size), np.float32)
    lib.shx_crop_depth(
        _fptr(dm), dm.shape[0], dm.shape[1], _fptr(center),
        fx, fy, cx, cy, cube, out_size, background, _fptr(out),
    )
    return out


def decode_crop_batch(
    paths: list[str],
    centers: np.ndarray,
    dm_shape: tuple[int, int] = (480, 640),
    fx: float = 588.235,
    fy: float = 587.084,
    cx: float = 320.0,
    cy: float = 240.0,
    cube: float = 300.0,
    out_size: int = 64,
    background: float = 100.0,
    num_threads: int = 0,
) -> tuple[np.ndarray, int]:
    """Decode + crop a batch of depth PNGs in parallel.

    Returns (crops (N, out_size, out_size), num_failures).
    """
    lib = load_library()
    n = len(paths)
    centers = np.ascontiguousarray(centers, np.float32)
    assert centers.shape == (n, 3)
    out = np.empty((n, out_size, out_size), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.shx_decode_crop_batch(
        c_paths, n, _fptr(centers), dm_shape[0], dm_shape[1],
        fx, fy, cx, cy, cube, out_size, background, num_threads, _fptr(out),
    )
    return out, int(failures)
