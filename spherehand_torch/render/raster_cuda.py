"""The two hand-written CUDA rasterizers, their pre-pass and their plain versions.

Counterpart of ``spherehand_tpu/render/raster_pallas.py``. The kernels
(``spherehand_torch/csrc/raster.cu``) compute what the TPU kernels compute,
not their block layout:

- ``raster_fast_pooled`` replaces ``_raster_kernel_fast_paired``
  (raster_pallas.py:633): half-plane coverage on raw barycentrics
  (``w2 = 1 - w0 - w1``), depth ``1/q`` from the fused affine reciprocal-depth
  row, z-min over faces, and the fused epilogue ``mean_2x2(min(z, clamp))``
  straight into the (B, 64, 64) canvas.
- ``raster_exact`` replaces ``_raster_kernel_exact`` (raster_pallas.py:756):
  the reference CUDA scanline-span coverage on clamped, renormalised
  barycentrics, raw (B, Sy, Sx) buffer with background 1000.

The pre-pass runs in plain PyTorch on the device: sort each face's vertices
by x with the reference tie ladder, cull back-facing and degenerate faces,
and build the records in the JAX field layouts (fast 9 fields, exact 24) plus
a per-face bounding box the kernels use to skip faces tile by tile. No sort
of faces is needed: each kernel block filters the face list itself.

Beside each kernel is its plain PyTorch version: :func:`rasterize_depth`
(``render/raster.py``) for the exact kernel and
:func:`raster_fast_pooled_plain` for the fast one. A wrapper takes the plain
version only for a CPU tensor; for a CUDA tensor it launches the kernel or
raises. ``LAUNCHES`` counts kernel launches per kernel.

Fast-mode coverage is the half-plane test restricted to the face's bounding
box grown by one pixel. The TPU kernel gets the same restriction from its
face bins; it only matters for near-degenerate records whose sanitised
coefficients turn a triangle into a strip.

The library is built with nvcc at first use, from the checkout's sources,
into ``spherehand_torch/build/`` (see :func:`build`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from spherehand_torch.render.raster import (
    BACKGROUND_INIT,
    barycentric_rows,
    face_chunk_size,
    front_facing,
    pool_2x2,
    rasterize_depth,
    sort_order,
)

FREC_FAST = 9    # fields per fast-mode face record
FREC_EXACT = 24  # fields per exact-mode face record (last one is padding)
BOX_MARGIN = 1.0  # px added around a face's box for the fast-mode coverage

LAUNCHES = {"raster_fast_pooled": 0, "raster_exact": 0}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "raster.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # No FMA contraction: span bounds (ceil/trunc) and depth bits must round
    # like the plain PyTorch version, one operation at a time.
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------- pre-pass


def face_columns(face_vertices=None, planes=None):
    """Per-vertex coordinate columns (x, y, z), each a 3-list of (B, F).

    ``planes`` is the gather-free front end: (u, v, z), each (B, 3F) in
    face-vertex order (``skinning.project_faces_planes``)."""
    if planes is not None:
        u, v, z = planes
        batch = u.shape[0]

        def cols(a):
            a3 = a.reshape(batch, -1, 3)
            return [a3[..., 0], a3[..., 1], a3[..., 2]]

        return cols(u), cols(v), cols(z)
    return tuple(
        [face_vertices[..., k, c] for k in range(3)] for c in range(3)
    )


def _setup_cols(xc, yc, zc):
    """Select-based vertex sort + validity: sorted columns px, py, pz,
    the barycentric rows and the front-facing, non-degenerate mask."""
    x0, x1, x2 = xc
    front = front_facing(x0, x1, x2, *yc)
    order = sort_order(x0, x1, x2)

    def pick(idx, c):
        return torch.where(idx == 0, c[0], torch.where(idx == 1, c[1], c[2]))

    px = [pick(i, xc) for i in order]
    py = [pick(i, yc) for i in order]
    pz = [pick(i, zc) for i in order]
    rows, den = barycentric_rows(px, py)
    valid = front & (px[0] != px[2]) & (den != 0.0)
    return px, py, pz, rows, valid


def _box(xmin, xmax, ymin, ymax, valid):
    """(B, F, 4) [xmin, xmax, ymin, ymax]; culled faces get an empty box."""
    inf = torch.full_like(xmin, float("inf"))
    box = torch.stack(
        [
            torch.where(valid, xmin, inf),
            torch.where(valid, xmax, -inf),
            torch.where(valid, ymin, inf),
            torch.where(valid, ymax, -inf),
        ],
        dim=-1,
    )
    return box.contiguous()


def _y_range(py):
    ymin = torch.minimum(torch.minimum(py[0], py[1]), py[2])
    ymax = torch.maximum(torch.maximum(py[0], py[1]), py[2])
    return ymin, ymax


def prepass_fast(face_vertices=None, planes=None):
    """Geometry -> fast records (B, F, 9) and face boxes (B, F, 4).

    Record fields (``_build_records_fast``): barycentric row 0 [a0 b0 c0],
    row 1 [a1 b1 c1] and the fused reciprocal-depth row [qa qb qc] =
    sum_k r_k * row_k with r_k = 1/z_k, all sanitised finite. The box is the
    vertex box grown by ``BOX_MARGIN``."""
    px, py, pz, rows, valid = _setup_cols(*face_columns(face_vertices, planes))
    r = [
        torch.where(z == 0.0, torch.zeros_like(z),
                    1.0 / torch.where(z == 0.0, torch.ones_like(z), z))
        for z in pz
    ]
    qrow = [r[0] * rows[0][c] + r[1] * rows[1][c] + r[2] * rows[2][c] for c in range(3)]
    cols = rows[0] + rows[1] + qrow
    records = torch.stack(
        [torch.where(torch.isfinite(c), c, torch.zeros_like(c)) for c in cols], dim=-1
    ).contiguous()
    ymin, ymax = _y_range(py)
    m = BOX_MARGIN
    box = _box(px[0] - m, px[2] + m, ymin - m, ymax + m, valid)
    return records, box


def prepass_exact(face_vertices=None, planes=None, width: int = 640):
    """Geometry -> exact records (B, F, 24) and face boxes (B, F, 4).

    Record fields (``_build_records_exact``, raster_pallas.py:101-104):
      0 p0x  1 p1x  2 xhi=trunc(min(p2x,W-1))  3 p0y  4 p1y  5 xlo=ceil(p0x)
      6-8 s01 s12 s02 (edge slopes)  9-10 vert01 vert12 (vertical-edge flags)
      11-13 r0 r1 r2 (1/z)  14-22 barycentric inverse (row-major)  23 pad

    The box's x range is the exact column span [xlo, xhi]. Its y range is
    the vertex range grown by one pixel, which holds every span the
    scanline rule paints, except for a face whose ``xhi`` lies right of p2x
    (C truncation toward zero of a negative p2x): its column-0 span is an
    extrapolation, so its y range is unbounded.
    """
    px, py, pz, rows, valid = _setup_cols(*face_columns(face_vertices, planes))
    px0, px1, px2 = px
    py0, py1, py2 = py

    def safe_slope(xa, ya, xb, yb):
        dx = xb - xa
        vertical = dx == 0.0
        slope = (yb - ya) / torch.where(vertical, torch.ones_like(dx), dx)
        return torch.where(vertical, torch.zeros_like(dx), slope)

    xhi = torch.trunc(torch.clamp(px2, max=width - 1.0))
    xlo = torch.ceil(px0)
    cols = [
        px0, px1, xhi, py0, py1, xlo,
        safe_slope(px0, py0, px1, py1),
        safe_slope(px1, py1, px2, py2),
        safe_slope(px0, py0, px2, py2),
        (px1 == px0).to(px0.dtype),
        (px2 == px1).to(px0.dtype),
        1.0 / pz[0], 1.0 / pz[1], 1.0 / pz[2],
    ]
    cols += rows[0] + rows[1] + rows[2]
    cols.append(torch.zeros_like(px0))
    records = torch.stack(cols, dim=-1).contiguous()
    ymin, ymax = _y_range(py)
    extrapolated = xhi > px2
    inf = torch.full_like(ymin, float("inf"))
    box = _box(
        xlo, xhi,
        torch.where(extrapolated, -inf, ymin - 1.0),
        torch.where(extrapolated, inf, ymax + 1.0),
        valid,
    )
    return records, box


# ------------------------------------------------------------ plain version


def raster_fast_pooled_plain(
    records: torch.Tensor,
    box: torch.Tensor,
    sample_x: torch.Tensor,
    sample_y: torch.Tensor,
    pool_clamp: float | None,
) -> torch.Tensor:
    """Plain PyTorch version of the fast kernel: every (face, sample) pair,
    half-plane coverage inside the face box, depth 1/q, z-min, then
    ``pool_2x2(min(z, pool_clamp))``: (B, Sy/2, Sx/2). ``pool_clamp=None``
    returns the raw (B, Sy, Sx) samples instead, for the fast-vs-exact
    contract, which is stated on raw samples."""
    batch, num_faces = records.shape[:2]
    x = sample_x[None, None, None, :]
    y = sample_y[None, None, :, None]
    zbuf = torch.full(
        (batch, sample_y.shape[0], sample_x.shape[0]), BACKGROUND_INIT,
        dtype=records.dtype, device=records.device,
    )
    chunk = face_chunk_size(batch, zbuf[0].numel())
    for s in range(0, num_faces, chunk):
        f = records[:, s : s + chunk, :, None, None]  # (B, C, 9, 1, 1)
        bd = box[:, s : s + chunk, :, None, None]
        inside = (x >= bd[:, :, 0]) & (x <= bd[:, :, 1]) & (y >= bd[:, :, 2]) & (y <= bd[:, :, 3])
        w0 = f[:, :, 0] * x + f[:, :, 1] * y + f[:, :, 2]
        w1 = f[:, :, 3] * x + f[:, :, 4] * y + f[:, :, 5]
        w2 = 1.0 - w0 - w1
        depth = 1.0 / (f[:, :, 6] * x + f[:, :, 7] * y + f[:, :, 8])
        cover = inside & (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0) & ~torch.isnan(depth)
        depth = torch.where(cover, depth, torch.full_like(depth, BACKGROUND_INIT))
        zbuf = torch.minimum(zbuf, depth.amin(dim=1))
    if pool_clamp is None:
        return zbuf
    return pool_2x2(torch.clamp(zbuf, max=pool_clamp))


# ------------------------------------------------------------------- build


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA rasterizers need the CUDA toolkit")
    return found


def build() -> tuple[str, str]:
    """Compile ``csrc/raster.cu`` into a shared library under ``build/``.

    The file name carries a hash of the source and flags, so an unchanged
    source is built once per checkout. Returns (library path, compiler log:
    ptxas registers, shared memory and spills per kernel)."""
    with open(SOURCE, "rb") as fh:
        src = fh.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libshx_raster_{digest}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path, proc.stderr


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name in ("shx_raster_fast_pooled", "shx_raster_exact"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 5 + [i32] * 4 + [f32, ptr]
            fn.restype = i32
        lib.shx_error_string.argtypes = [i32]
        lib.shx_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ----------------------------------------------------------------- wrappers


def _check(t: torch.Tensor, name: str, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def _launch(name: str, records, box, sample_x, sample_y, out, ints, scalar) -> torch.Tensor:
    if box.data_ptr() % 16:
        raise ValueError("box: the kernels read it as float4 and need 16-byte alignment")
    lib = _library()
    stream = torch.cuda.current_stream(records.device).cuda_stream
    with torch.cuda.device(records.device):
        rc = getattr(lib, f"shx_{name}")(
            records.data_ptr(), box.data_ptr(), sample_x.data_ptr(),
            sample_y.data_ptr(), out.data_ptr(), *ints, scalar, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.shx_error_string(rc).decode()}")
    LAUNCHES[name] += 1
    return out


def launch_raster_fast_pooled(records, box, sample_x, sample_y, pool_clamp: float):
    """Run the fast kernel: (B, F, 9) records + (B, F, 4) boxes at the
    paired sample grid (2W,) x (2H,) -> pooled (B, H, W)."""
    batch, num_faces = records.shape[:2]
    out_w, out_h = sample_x.shape[0] // 2, sample_y.shape[0] // 2
    _check(records, "records", (batch, num_faces, FREC_FAST))
    _check(box, "box", (batch, num_faces, 4))
    _check(sample_x, "sample_x", (2 * out_w,))
    _check(sample_y, "sample_y", (2 * out_h,))
    out = torch.empty((batch, out_h, out_w), dtype=torch.float32, device=records.device)
    return _launch(
        "raster_fast_pooled", records, box, sample_x, sample_y, out,
        (batch, num_faces, out_w, out_h), float(pool_clamp),
    )


def launch_raster_exact(records, box, sample_x, sample_y, height: int):
    """Run the exact kernel: (B, F, 24) records + (B, F, 4) boxes at the
    sample grid (Sx,) x (Sy,) -> raw (B, Sy, Sx), background 1000."""
    batch, num_faces = records.shape[:2]
    sx_n, sy_n = sample_x.shape[0], sample_y.shape[0]
    _check(records, "records", (batch, num_faces, FREC_EXACT))
    _check(box, "box", (batch, num_faces, 4))
    _check(sample_x, "sample_x", (sx_n,))
    _check(sample_y, "sample_y", (sy_n,))
    out = torch.empty((batch, sy_n, sx_n), dtype=torch.float32, device=records.device)
    return _launch(
        "raster_exact", records, box, sample_x, sample_y, out,
        (batch, num_faces, sx_n, sy_n), float(height),
    )


def _device(face_vertices, planes) -> torch.device:
    return (planes[0] if planes is not None else face_vertices).device


def rasterize_fast_pooled(
    sample_x: torch.Tensor,
    sample_y: torch.Tensor,
    face_vertices: torch.Tensor | None = None,
    planes: tuple | None = None,
    pool_clamp: float = 100.0,
) -> torch.Tensor:
    """Fast-mode z-buffer at the paired sample grid, clamped and 2x2-pooled:
    (B, Sy/2, Sx/2). Geometry as (B, F, 3, 3) face vertices or (u, v, z)
    planes. CPU tensors take the plain version; CUDA tensors the kernel."""
    records, box = prepass_fast(face_vertices, planes)
    if _device(face_vertices, planes).type == "cpu":
        return raster_fast_pooled_plain(records, box, sample_x, sample_y, pool_clamp)
    return launch_raster_fast_pooled(records, box, sample_x, sample_y, pool_clamp)


def rasterize_exact(
    sample_x: torch.Tensor,
    sample_y: torch.Tensor,
    face_vertices: torch.Tensor | None = None,
    planes: tuple | None = None,
    width: int = 640,
    height: int = 640,
) -> torch.Tensor:
    """Exact-mode z-buffer: raw (B, Sy, Sx), background 1000. CPU tensors
    take the plain :func:`rasterize_depth`; CUDA tensors the kernel."""
    if _device(face_vertices, planes).type == "cpu":
        if face_vertices is None:
            u, v, z = planes
            face_vertices = torch.stack([u, v, z], dim=-1).reshape(u.shape[0], -1, 3, 3)
        return rasterize_depth(face_vertices, sample_x, sample_y, width, height)
    records, box = prepass_exact(face_vertices, planes, width)
    return launch_raster_exact(records, box, sample_x, sample_y, height)
