"""Triangle depth rasterization: the plain exact z-buffer and the render front end.

Counterpart of ``spherehand_tpu/render/raster.py``. :func:`rasterize_depth`
tests every (sample, face) pair with elementwise math and takes the z-buffer
as a ``min`` over faces. Its coverage rules replicate the reference CUDA
kernel (mesh/cuda_kernel/depth_rasterization_cuda_kernel.cu:18-113):

- back-face cull on the unsorted winding,
- vertices sorted left-to-right by x with the kernel's tie rules,
- per column x the covered rows span the two polyline edges, with C
  truncation of the integer bounds,
- depth ``1/z = sum(w_k / z_k)`` from barycentric weights clamped to [0, 1]
  and renormalised; a NaN depth counts as uncovered,
- background 1000; callers clamp to 100.

Faces whose sorted projection is exactly collinear are skipped outright.

It is the plain version of the CUDA exact kernel (``raster_cuda``) and the
path :func:`render_depth_64` takes for a CPU tensor. Its arithmetic is
written one rounded operation at a time, in the order of the JAX oracle, so
that it, the JAX package and the kernel (built with ``-fmad=false``) agree.

The reference renders 640x640 and bilinear-resizes to 64x64; with
align_corners=False and scale 10 output pixel (i, j) reads only input
pixels {10i+4, 10i+5} x {10j+4, 10j+5} with weights 1/4, so the render
evaluates the rasterizer at those 128x128 samples and averages 2x2.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from spherehand_torch.constants import Constants
from spherehand_torch.hand.assets import HandModel
from spherehand_torch.hand.skinning import (
    lbs_faces,
    orthographic_project_xyz,
    project_faces_planes,
)

_C = Constants()

BACKGROUND_INIT = 1000.0


def sort_order(x0, x1, x2):
    """Indices (pi0, pi1, pi2) that sort a face's vertices by x with the
    reference kernel's comparison ladder (.cu:38-45)."""
    c01 = x0 < x1
    two = torch.full_like(x0, 2, dtype=torch.int64)
    pi0 = torch.where(
        c01, torch.where(x2 < x0, two, 0), torch.where(x2 < x1, two, 1)
    )
    pi2 = torch.where(
        c01, torch.where(x1 < x2, two, 1), torch.where(x0 < x2, two, 0)
    )
    return pi0, 3 - pi0 - pi2, pi2


def front_facing(x0, x1, x2, y0, y1, y2) -> torch.Tensor:
    """Back-face cull on the original winding (.cu:33 rejects strictly less)."""
    return (y2 - y0) * (x1 - x0) >= (y1 - y0) * (x2 - x0)


def barycentric_rows(px, py):
    """Rows of the barycentric inverse (each [x-coef, y-coef, const]) from
    the sorted vertex columns, divided by the safe determinant, and the raw
    determinant."""
    px0, px1, px2 = px
    py0, py1, py2 = py
    den = px2 * (py0 - py1) + px0 * (py1 - py2) + px1 * (py2 - py0)
    safe_den = torch.where(den == 0.0, torch.ones_like(den), den)
    rows = [
        [py1 - py2, px2 - px1, px1 * py2 - px2 * py1],
        [py2 - py0, px0 - px2, px2 * py0 - px0 * py2],
        [py0 - py1, px1 - px0, px0 * py1 - px1 * py0],
    ]
    return [[c / safe_den for c in row] for row in rows], den


def face_setup(face_vertices: torch.Tensor):
    """Per-face precomputation shared by all samples.

    face_vertices: (..., F, 3, 3), per face 3 vertices of (x, y, z) with x/y
    in pixel units and z in mm. Returns (p, face_inv, valid): the vertices
    sorted by x (..., F, 3, 3), the barycentric matrix rows (..., F, 3, 3)
    and the front-facing, non-degenerate mask (..., F).
    """
    x = face_vertices[..., 0]
    y = face_vertices[..., 1]
    front = front_facing(x[..., 0], x[..., 1], x[..., 2],
                         y[..., 0], y[..., 1], y[..., 2])
    order = torch.stack(sort_order(x[..., 0], x[..., 1], x[..., 2]), dim=-1)
    p = torch.take_along_dim(face_vertices, order[..., None], dim=-2)
    px = [p[..., k, 0] for k in range(3)]
    py = [p[..., k, 1] for k in range(3)]
    rows, den = barycentric_rows(px, py)
    face_inv = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    nondegenerate = (px[0] != px[2]) & (den != 0.0)
    return p, face_inv, front & nondegenerate


def _face_chunk_depth(p, face_inv, valid, sample_x, sample_y, width, height):
    """Min depth over a face chunk at every sample. p: (B, C, 3, 3) sorted.
    Returns (B, Sy, Sx)."""
    px = [p[..., k, 0, None, None] for k in range(3)]  # (B, C, 1, 1)
    py = [p[..., k, 1, None, None] for k in range(3)]
    sx = sample_x[None, None, None, :]  # (1, 1, 1, Sx)
    sy = sample_y[None, None, :, None]  # (1, 1, Sy, 1)

    def edge_y(a: int, b: int) -> torch.Tensor:
        dx = px[b] - px[a]
        vertical = dx == 0.0
        slope = (py[b] - py[a]) / torch.where(vertical, torch.ones_like(dx), dx)
        yi = slope * (sx - px[a]) + py[a]
        return torch.where(vertical, py[1], yi)  # (B, C, 1, Sx)

    # Column span: ceil(p0.x) <= x <= trunc(min(p2.x, width-1)).
    x_hi = torch.trunc(torch.clamp(px[2], max=width - 1.0))
    x_ok = (sx >= torch.ceil(px[0])) & (sx <= x_hi)
    # Row span at this column: between the two polyline edges.
    yi1 = torch.where(sx <= px[1], edge_y(0, 1), edge_y(1, 2))
    yi2 = edge_y(0, 2)
    y_lo = torch.ceil(torch.minimum(yi1, yi2))
    y_hi = torch.trunc(torch.clamp(torch.maximum(yi1, yi2), max=height - 1.0))

    # Clamped, renormalised barycentrics; w = (a x + c) + b y.
    w = []
    for k in range(3):
        a = face_inv[..., k, 0, None, None]
        b = face_inv[..., k, 1, None, None]
        c = face_inv[..., k, 2, None, None]
        w.append(torch.clamp((a * sx + c) + b * sy, 0.0, 1.0))
    r = [1.0 / p[..., k, 2, None, None] for k in range(3)]
    w_sum = w[0] + w[1] + w[2]
    inv_z = (w[0] * r[0] + w[1] * r[1] + w[2] * r[2]) / w_sum
    depth = 1.0 / inv_z

    cover = (
        valid[..., None, None]
        & x_ok
        & (sy >= y_lo)
        & (sy <= y_hi)
        & (w_sum > 0.0)
        & ~torch.isnan(depth)
    )
    depth = torch.where(cover, depth, torch.full_like(depth, BACKGROUND_INIT))
    return depth.amin(dim=1)


def face_chunk_size(batch: int, num_samples: int) -> int:
    """Faces per step of a brute-force loop: each (B, C, Sy, Sx) temporary
    stays near 2^27 elements (512 MB), at most 128 faces."""
    return max(1, min(128, (1 << 27) // max(1, batch * num_samples)))


def rasterize_depth(
    face_vertices: torch.Tensor,
    sample_x: torch.Tensor,
    sample_y: torch.Tensor,
    width: int = 640,
    height: int = 640,
) -> torch.Tensor:
    """Z-buffer depth at integer-valued sample positions (plain exact).

    face_vertices: (B, F, 3, 3); sample_x (Sx,), sample_y (Sy,) float.
    Returns (B, Sy, Sx) with background 1000. A loop over face chunks, each a
    broadcast over (face, sample) pairs and a min over faces.
    """
    batch, num_faces = face_vertices.shape[:2]
    p, face_inv, valid = face_setup(face_vertices)
    zbuf = torch.full(
        (batch, sample_y.shape[0], sample_x.shape[0]), BACKGROUND_INIT,
        dtype=face_vertices.dtype, device=face_vertices.device,
    )
    chunk = face_chunk_size(batch, zbuf[0].numel())
    for s in range(0, num_faces, chunk):
        e = min(s + chunk, num_faces)
        depth = _face_chunk_depth(
            p[:, s:e], face_inv[:, s:e], valid[:, s:e], sample_x, sample_y,
            width, height,
        )
        zbuf = torch.minimum(zbuf, depth)
    return zbuf


def bilinear_sample_positions(out_size: int, scale: int) -> np.ndarray:
    """The input pixels a bilinear ``align_corners=False`` downsample reads:
    pairs {scale*i + scale//2 - 1, scale*i + scale//2} for even ``scale``."""
    base = scale * np.arange(out_size) + scale // 2 - 1
    return np.stack([base, base + 1], axis=1).reshape(-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def sample_grid(out_size: int, scale: int, device: torch.device) -> torch.Tensor:
    """:func:`bilinear_sample_positions` as a tensor on ``device``, built
    once per (out_size, scale, device): a render copies nothing from the
    host, so it never waits on the device's queue. Callers must not write
    to it."""
    return torch.as_tensor(bilinear_sample_positions(out_size, scale), device=device)


def pool_2x2(depth: torch.Tensor) -> torch.Tensor:
    """(B, 2H, 2W) -> (B, H, W): ((t0 + t1) + (t2 + t3)) * 0.25 over each
    2x2 block, the order of the fused kernel epilogue."""
    t = [depth[:, py::2, px::2] for py in (0, 1) for px in (0, 1)]
    return ((t[0] + t[1]) + (t[2] + t[3])) * 0.25


def _assemble_face_verts(
    model: HandModel, transforms: torch.Tensor, rand_f: torch.Tensor | None
) -> torch.Tensor:
    """LBS + project + face assembly -> (B, F, 3, 3) [u, v, z] per vertex."""
    verts = lbs_faces(model, transforms)  # (B, 3F, 4)
    face_verts = orthographic_project_xyz(verts, float(_C.raster_size), rand_f)
    return face_verts.reshape(transforms.shape[0], model.num_faces, 3, 3)


def render_depth_64(
    model: HandModel,
    transforms: torch.Tensor,
    rand_f: torch.Tensor | None = None,
    out_size: int = 64,
    exact: bool = False,
) -> torch.Tensor:
    """Bone transforms -> (B, 64, 64) depth maps in mm (background 100).

    LBS the full mesh, project into the 640 canvas, rasterize at the 128x128
    sparse sample grid, clamp to 100 and average 2x2.

    On a CPU tensor this is the plain exact path, whatever ``exact`` says
    (as the JAX package's ``xla`` backend). On a CUDA tensor the geometry
    enters through :func:`project_faces_planes` and the hand-written kernels
    render its planes with no pre-pass: the fast half-plane kernel with the
    fused clamp + pool by default, the exact scanline kernel when
    ``exact=True``.
    """
    samples = sample_grid(out_size, _C.raster_size // out_size, transforms.device)
    clamp = float(_C.background_depth)
    if transforms.device.type == "cpu":
        face_verts = _assemble_face_verts(model, transforms, rand_f)
        zbuf = rasterize_depth(
            face_verts, samples, samples, width=_C.raster_size, height=_C.raster_size
        )
        return pool_2x2(torch.clamp(zbuf, max=clamp))

    from spherehand_torch.render import raster_cuda

    planes = project_faces_planes(model, transforms, float(_C.raster_size), rand_f)
    if exact:
        zbuf = raster_cuda.rasterize_exact(
            samples, samples, planes=planes,
            width=_C.raster_size, height=_C.raster_size,
        )
        return pool_2x2(torch.clamp(zbuf, max=clamp))
    return raster_cuda.rasterize_fast_pooled(
        samples, samples, planes=planes, pool_clamp=clamp
    )
