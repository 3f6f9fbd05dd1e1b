"""The sphere-field ops of the mutual-projection loss, their CUDA kernels and
their plain versions.

Counterpart of ``spherehand_tpu/render/sphere_pallas.py``. For N images of J
spheres the kernels compute, in one loop over the spheres, one or both of two
(N, S, S) fields:

- the min orthographic sphere depth (``render_spheres`` min-reduced,
  background 100): :func:`sphere_min_depth`;
- the distance from each observed depth point to the nearest sphere surface
  (0 where the observation is background, z > 99): :func:`d2m_nearest`;
- both at once, with one summed centre gradient:
  :func:`sphere_min_depth_and_d2m`.

Each op is an autograd Function. Under autograd the forward kernel also
writes, for each field, the argmin plane and the winning sphere's
gradient-weight plane, and the backward kernel turns them into masked
per-sphere sums that give the (N, J, 3) centre gradient; without autograd
the primal kernel writes the fields alone. The kernels
(``spherehand_torch/csrc/sphere.cu``, one template over the field set) and
the TPU kernels they replace (``sphere_pallas.py``):

=================== ====================== ==================== ====================
field set           primal                 forward + residuals  backward
=================== ====================== ==================== ====================
both (``BOTH``)     ``_fused_primal`` :227  ``_fused_fwd`` :253   ``_fused_bwd`` :308
depth (``DEPTH``)   ``_min_depth_primal``   ``_min_depth_fwd``    ``_min_depth_bwd``
                    :99                    :70                  :118
distance (``DIST``) ``_d2m_primal`` :179    ``_d2m_fwd`` :143     ``_d2m_bwd`` :200
=================== ====================== ==================== ====================

Their launch counters in ``LAUNCHES`` are ``sphere_fused_*``,
``min_depth_*`` and ``d2m_*``. The distance weight plane is zeroed on
background in the forward (the TPU's standalone distance kernel zeroes the
cotangent there instead; the gradient is the same), so a one-field plane is
bit-identical to the same plane of the two-field kernel.

The observed depth is ``target`` (M, S, S) with ``views`` = V: image n =
(b, i, j) of a (B, V, V) pair grid reads plane b * V + j (``views=1``: plane
n). The kernels index it in place; the plain versions gather it.

Beside each kernel is its plain PyTorch version with the same expression
order (``fused_{primal,fwd,bwd}_plain``, ``min_depth_{primal,fwd,bwd}_plain``,
``d2m_{primal,fwd,bwd}_plain``). An op takes the plain version only for a CPU
tensor; for a CUDA tensor it launches the kernel or raises. Target depth and
radii get no gradient, as in the JAX ops. :func:`tile_covered` is the plain
mirror of the forward kernel's disc-against-tile test.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from spherehand_torch import cuda_build
from spherehand_torch.constants import Constants
from spherehand_torch.render.sphere import _mm_grid, ieee_sqrt

_C = Constants()

# Field masks of csrc/sphere.cu.
DEPTH, DIST = 1, 2
BOTH = DEPTH | DIST
LAUNCH_PREFIX = {BOTH: "sphere_fused", DEPTH: "min_depth", DIST: "d2m"}

LAUNCHES = {f"{LAUNCH_PREFIX[f]}_{kind}": 0 for f in (BOTH, DEPTH, DIST)
            for kind in ("primal", "fwd", "bwd")}
MAX_SPHERES = 64      # csrc/sphere.cu kMaxJ
MAX_PIXELS = 4096     # csrc/sphere.cu kPixelsPerThread * kBwdThreads
TILE = 8              # csrc/sphere.cu kTile: the forward's depth tiles, TILE x TILE pixels
CULL_MARGIN_MM = _C.cube_mm / 64.0  # csrc/sphere.cu kCullMarginMm
# The plain versions broadcast over (images, J, S, S) a chunk of images at a
# time, at most about this many elements per temporary.
PLAIN_CHUNK_ELEMENTS = 1 << 22

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def num_fields(fields: int) -> int:
    return 2 if fields == BOTH else 1


def build() -> tuple[str, str]:
    """Compile ``csrc/sphere.cu`` under ``build/`` (``cuda_build.build``).
    Returns (library path, compiler log)."""
    return cuda_build.build("sphere")


def bind(path: str):
    """Load a build of ``csrc/sphere.cu`` and declare its C interface."""
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.shx_sphere_fields.argtypes = [ptr] * 3 + [i32] * 4 + [ptr] * 6 + [i32, i32, ptr]
    lib.shx_sphere_fields.restype = i32
    lib.shx_sphere_fields_bwd.argtypes = [ptr] * 8 + [i32] * 5 + [ptr, ptr]
    lib.shx_sphere_fields_bwd.restype = i32
    lib.shx_sphere_error_string.argtypes = [i32]
    lib.shx_sphere_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = bind(build()[0])
    return _lib


@contextlib.contextmanager
def use_library(lib):
    """Launch every sphere kernel from ``lib`` (a :func:`bind` result) inside
    the block, then from the build it replaced."""
    global _lib
    old, _lib = _library(), lib
    try:
        yield
    finally:
        _lib = old


# ----------------------------------------------------------- plain versions


def _target_index(n: int, views: int, device) -> torch.Tensor:
    idx = torch.arange(n, device=device)
    return (idx // (views * views)) * views + idx % views


def gathered_target(target: torch.Tensor, n: int, views: int) -> torch.Tensor:
    return target[_target_index(n, views, target.device)]


def _chunked(fn, centers, size, *per_image):
    """Run ``fn(centers chunk, *(x chunk for x in per_image))`` over chunks
    of images and concatenate each of its outputs."""
    n, num_j = centers.shape[:2]
    step = max(1, PLAIN_CHUNK_ELEMENTS // (num_j * size * size))
    outs = [fn(centers[a:a + step], *(x[a:a + step] for x in per_image))
            for a in range(0, n, step)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _depth_fields(centers, radii, size):
    """(n, J, S, S) per-sphere depth d and its sq, in the kernels'
    expression order."""
    xg, yg = _mm_grid(size, size, centers.dtype, centers.device)
    cx = centers[..., 0, None, None]
    cy = centers[..., 1, None, None]
    cz = centers[..., 2, None, None]
    r = radii[None, :, None, None]
    sq = r * r - (xg - cx) ** 2 - (yg - cy) ** 2
    depth = cz - ieee_sqrt(torch.clamp(sq, min=1e-2))
    return torch.where(sq > 1e-2, depth, torch.full_like(depth, _C.background_depth)), sq


def _dist_fields(centers, z, radii, size):
    """(n, J, S, S) per-sphere distance m and its raw, in the kernels'
    expression order, for images with observed depth z (n, S, S); plus the
    background mask of z."""
    xg, yg = _mm_grid(size, size, centers.dtype, centers.device)
    cx = centers[..., 0, None, None]
    cy = centers[..., 1, None, None]
    cz = centers[..., 2, None, None]
    r = radii[None, :, None, None]
    p_sq = xg * xg + yg * yg + z * z
    c_sq = cx * cx + cy * cy + cz * cz
    p_dot_c = xg * cx + yg * cy + z[:, None] * cz
    raw = p_sq[:, None] - 2.0 * p_dot_c + c_sq
    background = z > 99.0
    m = torch.abs(ieee_sqrt(torch.clamp(raw, min=1e-6)) - r)
    return torch.where(background[:, None], torch.zeros_like(m), m), raw, background


def _first_min(field: torch.Tensor):
    """Min over the sphere axis 1 and its lowest index on a tie."""
    idx = field.argmin(dim=1, keepdim=True)
    return field.gather(1, idx)[:, 0], idx


def _depth_residuals(d, sq):
    """(depth, argmin int32, weight 1/sqrt(sq) inside the silhouette)."""
    depth, idx = _first_min(d)
    best_sq = sq.gather(1, idx)[:, 0]
    w = torch.where(best_sq > 1e-2, 1.0 / ieee_sqrt(torch.clamp(best_sq, min=1e-2)),
                    torch.zeros_like(depth))
    return depth, idx[:, 0].to(torch.int32), w


def _dist_residuals(m, raw, background, radii):
    """(distance, argmin int32, weight sign(root - r)/root, 0 on background
    and where raw < 1e-6)."""
    dist, idx = _first_min(m)
    best_raw = raw.gather(1, idx)[:, 0]
    best_r = radii[idx[:, 0]]
    root = ieee_sqrt(torch.clamp(best_raw, min=1e-6))
    w = torch.where(background | (best_raw < 1e-6), torch.zeros_like(dist),
                    torch.sign(root - best_r) / root)
    return dist, idx[:, 0].to(torch.int32), w


def min_depth_primal_plain(centers, radii, size: int):
    """Plain version of ``min_depth_primal``: depth (N, S, S)."""
    return _chunked(lambda c: _first_min(_depth_fields(c, radii, size)[0])[:1],
                    centers, size)[0]


def min_depth_fwd_plain(centers, radii, size: int):
    """Plain version of ``min_depth_fwd``: (depth, amind int32, wd)."""
    return _chunked(lambda c: _depth_residuals(*_depth_fields(c, radii, size)), centers, size)


def d2m_primal_plain(depth_maps, centers, radii, size: int):
    """Plain version of ``d2m_primal``: distance (N, S, S) of the observed
    depth_maps (N, S, S)."""
    return _chunked(lambda c, z: _first_min(_dist_fields(c, z, radii, size)[0])[:1],
                    centers, size, depth_maps)[0]


def d2m_fwd_plain(depth_maps, centers, radii, size: int):
    """Plain version of ``d2m_fwd``: (dist, aminm int32, wm)."""
    return _chunked(lambda c, z: _dist_residuals(*_dist_fields(c, z, radii, size), radii),
                    centers, size, depth_maps)


def fused_primal_plain(centers, target, radii, size: int, views: int = 1):
    """Plain version of ``sphere_fused_primal``: (depth, dist), each (N, S, S)."""

    def chunk(c, z):
        return (_first_min(_depth_fields(c, radii, size)[0])[0],
                _first_min(_dist_fields(c, z, radii, size)[0])[0])

    return _chunked(chunk, centers, size, gathered_target(target, centers.shape[0], views))


def fused_fwd_plain(centers, target, radii, size: int, views: int = 1):
    """Plain version of ``sphere_fused_fwd``: (depth, dist, amind, wd,
    aminm, wm), each (N, S, S); the argmin planes are int32."""

    def chunk(c, z):
        depth, amind, wd = _depth_residuals(*_depth_fields(c, radii, size))
        dist, aminm, wm = _dist_residuals(*_dist_fields(c, z, radii, size), radii)
        return depth, dist, amind, wd, aminm, wm

    return _chunked(chunk, centers, size, gathered_target(target, centers.shape[0], views))


def _masked_sum(amin, num_j, terms):
    """For each term (n, S, S): its sum over the pixels whose argmin is j,
    (n, J)."""
    js = torch.arange(num_j, device=amin.device)[None, :, None, None]
    sel = amin[:, None].long() == js
    zero = torch.zeros((), dtype=terms[0].dtype, device=terms[0].device)
    return [torch.where(sel, a[:, None], zero).sum(dim=(2, 3)) for a in terms]


def _depth_terms(g, w, size):
    """A = g w, A x, A y and [w > 0] g of the depth field."""
    xg, yg = _mm_grid(size, size, g.dtype, g.device)
    a = g * w
    return [a, a * xg, a * yg, torch.where(w > 0.0, g, torch.zeros_like(g))]


def _dist_terms(g, w, z, size):
    """A = g w, A x, A y and A z of the distance field."""
    xg, yg = _mm_grid(size, size, g.dtype, g.device)
    a = g * w
    return [a, a * xg, a * yg, a * z]


def min_depth_bwd_plain(centers, g_depth, amind, wd):
    """Plain version of ``min_depth_bwd``: the (N, J, 3) centre gradient."""

    def chunk(c, g, amin, w):
        s_a, s_ax, s_ay, s_c = _masked_sum(amin, c.shape[1], _depth_terms(g, w, g.shape[-1]))
        return (torch.stack([c[..., 0] * s_a - s_ax, c[..., 1] * s_a - s_ay, s_c], dim=-1),)

    return _chunked(chunk, centers, g_depth.shape[-1], g_depth, amind, wd)[0]


def d2m_bwd_plain(centers, depth_maps, g_dist, aminm, wm):
    """Plain version of ``d2m_bwd``: the (N, J, 3) centre gradient."""

    def chunk(c, z, g, amin, w):
        s_a, s_ax, s_ay, s_az = _masked_sum(amin, c.shape[1], _dist_terms(g, w, z, g.shape[-1]))
        return (torch.stack([c[..., 0] * s_a - s_ax, c[..., 1] * s_a - s_ay,
                             c[..., 2] * s_a - s_az], dim=-1),)

    return _chunked(chunk, centers, g_dist.shape[-1], depth_maps, g_dist, aminm, wm)[0]


def fused_bwd_plain(centers, target, views, g_depth, g_dist, amind, wd, aminm, wm):
    """Plain version of ``sphere_fused_bwd``: the summed (N, J, 3) centre
    gradient as masked per-sphere sums over the stored planes."""

    def chunk(c, z, gd, gm, amd, w_d, amm, w_m):
        size, num_j = gd.shape[-1], c.shape[1]
        s_ad, s_adx, s_ady, s_cd = _masked_sum(amd, num_j, _depth_terms(gd, w_d, size))
        s_am, s_amx, s_amy, s_amz = _masked_sum(amm, num_j, _dist_terms(gm, w_m, z, size))
        gx = c[..., 0] * (s_ad + s_am) - s_adx - s_amx
        gy = c[..., 1] * (s_ad + s_am) - s_ady - s_amy
        gz = s_cd + c[..., 2] * s_am - s_amz
        return (torch.stack([gx, gy, gz], dim=-1),)

    z = gathered_target(target, centers.shape[0], views)
    return _chunked(chunk, centers, g_depth.shape[-1], z, g_depth, g_dist, amind, wd, aminm,
                    wm)[0]


def fields_plain(fields: int, centers, target, radii, size: int, views: int = 1,
                 residuals: bool = False):
    """The plain version of the forward kernel for ``fields``: the field
    planes (depth before distance), then with ``residuals`` each field's
    (argmin, weight) planes. ``target`` is unused for ``DEPTH``."""
    if fields == DEPTH:
        return (min_depth_fwd_plain(centers, radii, size) if residuals
                else (min_depth_primal_plain(centers, radii, size),))
    if fields == DIST:
        z = gathered_target(target, centers.shape[0], views)
        return (d2m_fwd_plain(z, centers, radii, size) if residuals
                else (d2m_primal_plain(z, centers, radii, size),))
    if residuals:
        return fused_fwd_plain(centers, target, radii, size, views)
    return fused_primal_plain(centers, target, radii, size, views)


def fields_bwd_plain(fields: int, centers, target, views: int, grads, res):
    """The plain version of the backward kernel for ``fields``: ``grads`` the
    field cotangents and ``res`` the residual planes, in the order
    :func:`fields_plain` gives them."""
    if fields == DEPTH:
        return min_depth_bwd_plain(centers, grads[0], *res)
    if fields == DIST:
        return d2m_bwd_plain(centers, gathered_target(target, centers.shape[0], views),
                             grads[0], *res)
    return fused_bwd_plain(centers, target, views, *grads, *res)


def tile_covered(centers, radii, size: int, tile: int = TILE) -> torch.Tensor:
    """The forward kernel's disc-against-tile test (``disc_meets_box``):
    (N, rows of tiles, columns of tiles, J) bool, False only where sphere
    j's centre lies more than r + ``CULL_MARGIN_MM`` from the pixel centres
    of the tile, in the kernel's float32 operations (``fmax`` drops a NaN as
    ``fmaxf`` does; a NaN radius keeps the sphere)."""
    grid = _mm_grid(1, size, centers.dtype, centers.device)[0][0]
    starts = torch.arange(0, size, tile, device=centers.device)
    lo, hi = grid[starts], grid[torch.clamp(starts + tile, max=size) - 1]
    zero = torch.zeros((), dtype=centers.dtype, device=centers.device)
    cx = centers[:, None, None, :, 0]
    cy = centers[:, None, None, :, 1]
    ex = torch.fmax(torch.fmax(lo[None, None, :, None] - cx, cx - hi[None, None, :, None]), zero)
    ey = torch.fmax(torch.fmax(lo[None, :, None, None] - cy, cy - hi[None, :, None, None]), zero)
    lim = radii + CULL_MARGIN_MM
    return ~((ex > lim) | (ey > lim) | (ex * ex + ey * ey > lim * lim))


# ------------------------------------------------------------------ kernels


def _check(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def _check_inputs(fields, centers, target, radii, size, views):
    n, num_j = centers.shape[:2]
    if not 1 <= num_j <= MAX_SPHERES or size * size > MAX_PIXELS or n % (views * views):
        raise ValueError(f"sphere kernels take 1 <= J <= {MAX_SPHERES}, S*S <= {MAX_PIXELS} "
                         f"and N divisible by views**2; got N={n} J={num_j} S={size} V={views}")
    _check(centers, "centers", (n, num_j, 3))
    if radii is not None:
        _check(radii, "radii", (num_j,))
    if fields & DIST:
        _check(target, "target", (n // views, size, size))


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(fn, device, *args) -> int:
    """Call ``fn(*args, stream)`` on ``device``'s current stream, with that
    device current."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def _raise_on(rc: int, name: str, lib) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.shx_sphere_error_string(rc).decode()}")


def _fields_kernel(fields, centers, target, radii, size, views, residuals):
    """The forward kernel on inputs already checked. Its planes are views of
    one buffer: the fields, then each field's (argmin int32, weight)."""
    n, num_j = centers.shape[:2]
    k = num_fields(fields)
    buf = torch.empty((3 * k if residuals else k, n, size, size), dtype=torch.float32,
                      device=centers.device)
    planes = buf.unbind(0)
    if residuals:
        planes = planes[:k] + tuple(p.view(torch.int32) if i % 2 == 0 else p
                                    for i, p in enumerate(planes[k:]))
    base, step = buf.data_ptr(), 4 * n * size * size
    at = [base + i * step for i in range(len(planes))]
    depth = at[0] if fields & DEPTH else None
    dist = at[k - 1] if fields & DIST else None
    res_d = (at[k], at[k + 1]) if residuals and fields & DEPTH else (None, None)
    res_m = (at[3 * k - 2], at[3 * k - 1]) if residuals and fields & DIST else (None, None)
    lib = _library()
    rc = _launch(lib.shx_sphere_fields, centers.device, centers.data_ptr(), radii.data_ptr(),
                 _ptr(target if fields & DIST else None), n, num_j, size, views, depth, dist,
                 *res_d, *res_m, fields, int(residuals))
    name = f"{LAUNCH_PREFIX[fields]}_{'fwd' if residuals else 'primal'}"
    _raise_on(rc, name, lib)
    LAUNCHES[name] += 1
    return planes


def _fields_bwd_kernel(fields, centers, target, views, grads, res):
    """The backward kernel on inputs already checked."""
    n, num_j = centers.shape[:2]
    size = grads[0].shape[-1]
    g_depth = grads[0] if fields & DEPTH else None
    g_dist = grads[-1] if fields & DIST else None
    res_d = tuple(res[:2]) if fields & DEPTH else (None, None)
    res_m = tuple(res[-2:]) if fields & DIST else (None, None)
    out = torch.empty((n, num_j, 3), dtype=torch.float32, device=centers.device)
    lib = _library()
    rc = _launch(lib.shx_sphere_fields_bwd, centers.device, centers.data_ptr(),
                 _ptr(target if fields & DIST else None), _ptr(g_depth), _ptr(g_dist),
                 *map(_ptr, res_d + res_m), n, num_j, size, views, fields, out.data_ptr())
    name = f"{LAUNCH_PREFIX[fields]}_bwd"
    _raise_on(rc, name, lib)
    LAUNCHES[name] += 1
    return out


def launch_fields(fields: int, centers, target, radii, size: int, views: int = 1,
                  residuals: bool = False):
    """Run the forward kernel for ``fields``: the field planes (depth before
    distance), then with ``residuals`` each field's (argmin int32, weight)
    planes, each (N, S, S). ``target`` may be None for ``DEPTH``."""
    _check_inputs(fields, centers, target, radii, size, views)
    return _fields_kernel(fields, centers, target, radii, size, views, residuals)


def launch_fields_bwd(fields: int, centers, target, views: int, grads, res):
    """Run the backward kernel for ``fields`` -> (N, J, 3). ``grads`` are
    the field cotangents and ``res`` the residual planes, in the order
    :func:`launch_fields` gives them."""
    n = centers.shape[0]
    size = grads[0].shape[-1]
    _check_inputs(fields, centers, target, None, size, views)
    named = []
    if fields & DEPTH:
        named += [(grads[0], "g_depth", torch.float32), (res[0], "amind", torch.int32),
                  (res[1], "wd", torch.float32)]
    if fields & DIST:
        named += [(grads[-1], "g_dist", torch.float32), (res[-2], "aminm", torch.int32),
                  (res[-1], "wm", torch.float32)]
    for t, name, dtype in named:
        _check(t, name, (n, size, size), dtype)
    return _fields_bwd_kernel(fields, centers, target, views, grads, res)


# --------------------------------------------------------------------- ops


class _SphereFields(torch.autograd.Function):
    """Forward with residual planes; backward = the backward kernel (the
    plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, fields, centers, target, radii, size, views):
        args = (fields, centers, target, radii, size, views, True)
        planes = fields_plain(*args) if centers.device.type == "cpu" else _fields_kernel(*args)
        k = num_fields(fields)
        ctx.save_for_backward(centers, target, *planes[k:])
        ctx.fields, ctx.views = fields, views
        return planes[:k]

    @staticmethod
    def backward(ctx, *grads):
        centers, target, *res = ctx.saved_tensors
        args = (ctx.fields, centers, target, ctx.views, [g.contiguous() for g in grads], res)
        out = fields_bwd_plain(*args) if centers.device.type == "cpu" else _fields_bwd_kernel(*args)
        # the target is observed data and the radii are constants
        return None, out, None, None, None, None


def _apply(fields, centers, target, radii, size: int, views: int):
    """Route one op: CPU tensors to the plain versions; CUDA tensors, checked
    here once, to the kernels (the autograd path checks nothing again)."""
    centers = centers.contiguous()
    if target is not None:
        target = target.to(centers.dtype).contiguous()
    radii = radii.to(centers.dtype).contiguous()
    cpu = centers.device.type == "cpu"
    if not cpu:
        _check_inputs(fields, centers, target, radii, size, views)
    if torch.is_grad_enabled() and centers.requires_grad:
        return _SphereFields.apply(fields, centers, target, radii, size, views)
    args = (fields, centers, target, radii, size, views)
    return fields_plain(*args) if cpu else _fields_kernel(*args, False)


def sphere_min_depth(centers, radii, size: int):
    """Min over J of the orthographic sphere depth: centers (N, J, 3) mm,
    radii (J,) -> (N, S, S), background 100. Gradient to ``centers`` only."""
    return _apply(DEPTH, centers, None, radii, size, 1)[0]


def d2m_nearest(depth_maps, centers, radii, size: int):
    """Per-pixel distance of the observed depth_maps (N, S, S) mm to the
    nearest of the spheres centers (N, J, 3), radii (J,) -> (N, S, S), 0 on
    background (z > 99). Gradient to ``centers`` only: the depth is data."""
    return _apply(DIST, centers, depth_maps, radii, size, 1)[0]


def sphere_min_depth_and_d2m(centers, target_dms, radii, size: int, views: int = 1):
    """Both mutual-projection fields of one sphere set.

    centers (N, J, 3) mm, target_dms (N / views, S, S) mm observed depth,
    radii (J,) -> (depth (N, S, S), dist (N, S, S)), each bit-identical to
    :func:`sphere_min_depth` / :func:`d2m_nearest`, with one summed centre
    gradient."""
    return tuple(_apply(BOTH, centers, target_dms, radii, size, views))
