"""The hand-written CUDA rasterizers, their pre-pass and their plain versions.

Counterpart of ``spherehand_tpu/render/raster_pallas.py``. The kernels
(``spherehand_torch/csrc/raster.cu``) compute what the TPU kernels compute,
not their block layout:

- ``raster_fast_pooled`` replaces ``_raster_kernel_fast_paired``
  (raster_pallas.py:633): half-plane coverage on raw barycentrics
  (``w2 = 1 - w0 - w1``), depth ``1/q`` from the fused affine reciprocal-depth
  row, z-min over faces, and the fused epilogue ``mean_2x2(min(z, clamp))``
  straight into the (B, 64, 64) canvas.
- ``raster_fast`` replaces ``_raster_kernel_fast`` (raster_pallas.py:524):
  the same coverage and depth at any ascending sample grid, raw (B, Sy, Sx)
  buffer with background 1000, no pooling. It is the JAX
  ``rasterize_depth_binned(..., exact=False)`` without ``bilinear_grid``.
- ``raster_exact`` replaces ``_raster_kernel_exact`` (raster_pallas.py:756):
  the reference CUDA scanline-span coverage on clamped, renormalised
  barycentrics, raw (B, Sy, Sx) buffer with background 1000.

All three read the projected planes (u, v, z), each (B, 3F) in face-vertex
order (``skinning.project_faces_planes``), and set every face up inside the
kernel: no PyTorch op runs before them. Each block owns a 64 x 64 z-tile of
samples in shared memory; the faces that reach it go to its threads, which
fold covered depths into the tile with an atomic min on an order-preserving
integer key (:func:`depth_key` is its plain mirror), so the result does not
depend on face order or scheduling. The sample grids must be sorted
ascending. ``raster_fast_pooled`` and ``raster_exact`` find a tile's faces
by scanning all faces of the image; ``raster_fast`` (up to
``BIN_MAX_TILES`` tiles an image) runs a binning pass first that puts each
face into the lists of the tiles its box reaches (:func:`tile_bins` is its
plain mirror), and each tile drains only its list.

The plain pre-pass (:func:`prepass_fast`, :func:`prepass_exact`) sorts each
face's vertices by x with the reference tie ladder, culls back-facing and
degenerate faces, and builds the records in the JAX field layouts (fast 9
fields, exact 24) plus a per-face bounding box. It is the front end of the
plain fast version; no kernel reads it.

Beside each kernel is its plain PyTorch version: :func:`rasterize_depth`
(``render/raster.py``) for the exact kernel and :func:`raster_fast_plain`
on :func:`prepass_fast`'s records for both fast ones (raw, or pooled given
``pool_clamp``). A wrapper takes the plain
version only for a CPU tensor; for a CUDA tensor it launches the kernel or
raises. ``LAUNCHES`` counts kernel launches per kernel.

Fast-mode coverage is the half-plane test restricted to the face's bounding
box grown by one pixel. The TPU kernel gets the same restriction from its
face bins; it only matters for near-degenerate records whose sanitised
coefficients turn a triangle into a strip.

The library is built with nvcc at first use, from the checkout's sources,
into ``spherehand_torch/build/`` (see :mod:`spherehand_torch.cuda_build`).
"""
from __future__ import annotations

import ctypes

import torch

from spherehand_torch import cuda_build
from spherehand_torch.render.raster import (
    BACKGROUND_INIT,
    barycentric_rows,
    face_chunk_size,
    front_facing,
    pool_2x2,
    rasterize_depth,
    sort_order,
)

# px added around a face's box for the fast-mode coverage (kBoxMargin in
# csrc/raster.cu)
BOX_MARGIN = 1.0
# Samples a side of a kernel's z-tile (kZTile in csrc/raster.cu).
ZTILE = 64
# z-tiles an image from which raster_fast bins its faces before the raster
# instead of scanning all faces in every tile (binned measured faster at 4
# and at 100 tiles, raster_ab), and up to which it may: the binning pass
# keeps two counters a tile in shared memory, and its scratch is F + 1
# int32 a tile.
BIN_MIN_TILES = 1
BIN_MAX_TILES = 2048

LAUNCHES = {"raster_fast_pooled": 0, "raster_fast": 0, "raster_exact": 0}

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


def raster_fast_plain(
    records: torch.Tensor,
    box: torch.Tensor,
    sample_x: torch.Tensor,
    sample_y: torch.Tensor,
    pool_clamp: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of both fast kernels: every (face, sample)
    pair, half-plane coverage inside the face box, depth 1/q, z-min. Raw
    (B, Sy, Sx), background 1000 (``raster_fast``); given ``pool_clamp``,
    ``pool_2x2(min(z, pool_clamp))``: (B, Sy/2, Sx/2) (``raster_fast_pooled``)."""
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


# ------------------------------------------------------------ tile bins


def ztiles(sx_n: int, sy_n: int) -> tuple[int, int]:
    """(columns, rows) of z-tiles over a (Sx,) x (Sy,) sample grid."""
    return -(-sx_n // ZTILE), -(-sy_n // ZTILE)


def tile_bins(planes, sample_x: torch.Tensor, sample_y: torch.Tensor) -> torch.Tensor:
    """Plain mirror of ``raster_fast``'s binning pass: (B, tiles_y,
    tiles_x, F) bool, True where face f is in the list of that z-tile.

    A front-facing, non-degenerate face (:func:`prepass_fast`'s box, empty
    for the others) goes into every tile of ``ZTILE`` samples a side whose
    sample range, first to last sample in x and in y, its box meets (the
    scanning kernels' test). A face that covers a sample of a tile is in
    its list; a listed face may cover none (its box reaches the range, or
    falls between two of its samples)."""
    _, box = prepass_fast(planes=planes)

    def meets(lo, hi, s):
        """(B, F, tiles): the box [lo, hi] meets a tile's first-to-last samples."""
        starts = torch.arange(0, s.shape[0], ZTILE, device=s.device)
        first, last = s[starts], s[torch.clamp(starts + ZTILE - 1, max=s.shape[0] - 1)]
        return (hi[..., None] >= first) & (lo[..., None] <= last)

    in_x = meets(box[..., 0], box[..., 1], sample_x)  # (B, F, tiles_x)
    in_y = meets(box[..., 2], box[..., 3], sample_y)  # (B, F, tiles_y)
    return (in_y[..., :, None] & in_x[..., None, :]).permute(0, 2, 3, 1)


# ------------------------------------------------------------- depth key


def depth_key(depth: torch.Tensor) -> torch.Tensor:
    """Plain mirror of the kernels' order-preserving depth key: float32 ->
    the unsigned 32-bit key, held in int64. For every value but NaN, a < b
    iff key(a) < key(b), so the kernels take a z-min as an integer atomic
    min on keys. Sign bit set -> ``~bits``, else ``bits | 0x80000000``;
    -0 keys below +0."""
    bits = depth.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)


def key_depth(key: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`depth_key`: int64 keys -> float32 depths."""
    bits = torch.where(key >= 0x80000000, key & 0x7FFFFFFF, key ^ 0xFFFFFFFF)
    bits = torch.where(bits >= 0x80000000, bits - (1 << 32), bits)  # as int32
    return bits.to(torch.int32).view(torch.float32)


# ------------------------------------------------------------------- build


def build() -> tuple[str, str]:
    """Compile ``csrc/raster.cu`` under ``build/`` (``cuda_build.build``).
    Returns (library path, compiler log)."""
    return cuda_build.build("raster")


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name, pointers, scalars in (
            ("shx_raster_fast_pooled", 6, [f32]),
            ("shx_raster_fast", 8, []),
            ("shx_raster_exact", 6, [f32, f32]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * pointers + [i32] * 4 + scalars + [ptr]
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


def _launch(name: str, tensors, out: torch.Tensor, args, scratch=()) -> torch.Tensor:
    """Launch ``shx_<name>`` with the pointers of ``tensors``, ``out`` and
    ``scratch`` (None passes NULL), then ``args`` (the sizes and scalars of
    its C signature) and the current stream."""
    lib = _library()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        rc = getattr(lib, f"shx_{name}")(
            *(t.data_ptr() for t in tensors), out.data_ptr(),
            *(None if t is None else t.data_ptr() for t in scratch), *args, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.shx_error_string(rc).decode()}")
    LAUNCHES[name] += 1
    return out


def _check_planes(planes) -> tuple[int, int]:
    """Check (u, v, z) planes, each (B, 3F); returns (B, F)."""
    batch, width = planes[0].shape
    if width % 3:
        raise ValueError(f"planes: expected (B, 3F), got {tuple(planes[0].shape)}")
    for name, t in zip("uvz", planes):
        _check(t, name, (batch, width))
    return batch, width // 3


def planes_of(face_vertices: torch.Tensor) -> tuple:
    """(B, F, 3, 3) face vertices -> contiguous (u, v, z) planes, each
    (B, 3F) in face-vertex order."""
    batch = face_vertices.shape[0]
    return tuple(face_vertices[..., c].reshape(batch, -1).contiguous() for c in range(3))


def launch_raster_fast_pooled(planes, sample_x, sample_y, pool_clamp: float):
    """Run the fast kernel: (u, v, z) planes, each (B, 3F), at the paired
    sample grid (2W,) x (2H,), sorted ascending -> pooled (B, H, W)."""
    batch, num_faces = _check_planes(planes)
    out_w, out_h = sample_x.shape[0] // 2, sample_y.shape[0] // 2
    _check(sample_x, "sample_x", (2 * out_w,))
    _check(sample_y, "sample_y", (2 * out_h,))
    out = torch.empty((batch, out_h, out_w), dtype=torch.float32, device=planes[0].device)
    return _launch("raster_fast_pooled", (*planes, sample_x, sample_y), out,
                   (batch, num_faces, out_w, out_h, float(pool_clamp)))


def launch_raster_fast(planes, sample_x, sample_y):
    """Run the raw fast kernel: (u, v, z) planes, each (B, 3F), at the
    sample grid (Sx,) x (Sy,) -> raw (B, Sy, Sx), background 1000.

    The grid may be any ascending (Sx,) x (Sy,), with no multiple of 8 or
    uniform spacing asked: the JAX kernel bins faces by searchsorted over
    its grid, so this is no narrower than its contract. With
    ``BIN_MIN_TILES`` to ``BIN_MAX_TILES`` z-tiles an image, the faces are
    binned first."""
    return _raster_fast(planes, sample_x, sample_y,
                        bins_faces(sample_x.shape[0], sample_y.shape[0]))


def bins_faces(sx_n: int, sy_n: int) -> bool:
    """Whether ``raster_fast`` bins the faces first on a (Sx,) x (Sy,) grid:
    from ``BIN_MIN_TILES`` to ``BIN_MAX_TILES`` z-tiles an image."""
    tiles_x, tiles_y = ztiles(sx_n, sy_n)
    return BIN_MIN_TILES <= tiles_x * tiles_y <= BIN_MAX_TILES


def _raster_fast(planes, sample_x, sample_y, binned: bool):
    """:func:`launch_raster_fast` with the face lists chosen by the caller
    (a lever for measurement, ``raster_ab``): ``binned`` takes them from the
    binning pass, with int32 scratch of a count and F entries a z-tile;
    else every z-tile scans all faces of its image."""
    batch, num_faces = _check_planes(planes)
    sx_n, sy_n = sample_x.shape[0], sample_y.shape[0]
    _check(sample_x, "sample_x", (sx_n,))
    _check(sample_y, "sample_y", (sy_n,))
    dev = planes[0].device
    out = torch.empty((batch, sy_n, sx_n), dtype=torch.float32, device=dev)
    counts = lists = None
    if binned:
        tiles_x, tiles_y = ztiles(sx_n, sy_n)
        slots = batch * tiles_x * tiles_y
        scratch = torch.empty((slots * (num_faces + 1),), dtype=torch.int32, device=dev)
        counts, lists = scratch[:slots], scratch[slots:]
    return _launch("raster_fast", (*planes, sample_x, sample_y), out,
                   (batch, num_faces, sx_n, sy_n), scratch=(counts, lists))


def launch_raster_exact(planes, sample_x, sample_y, width: int, height: int):
    """Run the exact kernel: (u, v, z) planes, each (B, 3F), at the sample
    grid (Sx,) x (Sy,), sorted ascending, on a width x height canvas -> raw
    (B, Sy, Sx), background 1000."""
    batch, num_faces = _check_planes(planes)
    sx_n, sy_n = sample_x.shape[0], sample_y.shape[0]
    _check(sample_x, "sample_x", (sx_n,))
    _check(sample_y, "sample_y", (sy_n,))
    out = torch.empty((batch, sy_n, sx_n), dtype=torch.float32, device=planes[0].device)
    return _launch("raster_exact", (*planes, sample_x, sample_y), out,
                   (batch, num_faces, sx_n, sy_n, float(width), float(height)))


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
    planes. CPU tensors take the plain version; CUDA tensors the kernel,
    which reads the planes directly."""
    if _device(face_vertices, planes).type == "cpu":
        records, box = prepass_fast(face_vertices, planes)
        return raster_fast_plain(records, box, sample_x, sample_y, pool_clamp)
    if planes is None:
        planes = planes_of(face_vertices)
    return launch_raster_fast_pooled(planes, sample_x, sample_y, pool_clamp)


def rasterize_fast(
    sample_x: torch.Tensor,
    sample_y: torch.Tensor,
    face_vertices: torch.Tensor | None = None,
    planes: tuple | None = None,
) -> torch.Tensor:
    """Fast-mode z-buffer at any ascending sample grid: raw (B, Sy, Sx),
    background 1000 (JAX ``rasterize_depth_binned(..., exact=False)`` without
    ``bilinear_grid``). CPU tensors take the plain version; CUDA tensors the
    kernel, which reads the planes directly."""
    if _device(face_vertices, planes).type == "cpu":
        records, box = prepass_fast(face_vertices, planes)
        return raster_fast_plain(records, box, sample_x, sample_y)
    if planes is None:
        planes = planes_of(face_vertices)
    return launch_raster_fast(planes, sample_x, sample_y)


def rasterize_exact(
    sample_x: torch.Tensor,
    sample_y: torch.Tensor,
    face_vertices: torch.Tensor | None = None,
    planes: tuple | None = None,
    width: int = 640,
    height: int = 640,
) -> torch.Tensor:
    """Exact-mode z-buffer: raw (B, Sy, Sx), background 1000. CPU tensors
    take the plain :func:`rasterize_depth`; CUDA tensors the kernel, which
    reads the planes directly."""
    if _device(face_vertices, planes).type == "cpu":
        if face_vertices is None:
            u, v, z = planes
            face_vertices = torch.stack([u, v, z], dim=-1).reshape(u.shape[0], -1, 3, 3)
        return rasterize_depth(face_vertices, sample_x, sample_y, width, height)
    if planes is None:
        planes = planes_of(face_vertices)
    return launch_raster_exact(planes, sample_x, sample_y, width, height)
