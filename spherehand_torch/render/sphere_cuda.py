"""The fused sphere-field op of the mutual-projection loss, its CUDA kernels
and their plain versions.

Counterpart of ``sphere_min_depth_and_d2m`` in
``spherehand_tpu/render/sphere_pallas.py``. For N images of J spheres it
computes two (N, S, S) fields in one loop over the spheres:

- the min orthographic sphere depth (``render_spheres`` min-reduced,
  background 100), and
- the distance from each observed depth point to the nearest sphere surface
  (0 where the observation is background, z > 99),

and, under autograd, their summed centre gradient from one backward pass.
The kernels (``spherehand_torch/csrc/sphere.cu``):

- ``sphere_fused_primal`` replaces ``_fused_primal_kernel``
  (sphere_pallas.py:227): the two fields only, when no gradient is wanted;
- ``sphere_fused_fwd`` replaces ``_fused_fwd_kernel`` (:253): the two
  fields plus, for each, the argmin plane and the winning sphere's
  gradient-weight plane;
- ``sphere_fused_bwd`` replaces ``_fused_bwd_kernel`` (:308): masked
  per-sphere sums over the stored planes give the (N, J, 3) gradient.

The observed depth is ``target`` (M, S, S) with ``views`` = V: image n =
(b, i, j) of a (B, V, V) pair grid reads plane b * V + j (``views=1``: plane
n). The kernels index it in place; the plain versions gather it.

Beside each kernel is its plain PyTorch version (``fused_primal_plain``,
``fused_fwd_plain``, ``fused_bwd_plain``) with the same expression order.
A wrapper takes the plain version only for a CPU tensor; for a CUDA tensor
it launches the kernel or raises. ``LAUNCHES`` counts kernel launches.
Target depth and radii get no gradient, as in the JAX op.
"""
from __future__ import annotations

import ctypes

import torch

from spherehand_torch import cuda_build
from spherehand_torch.constants import Constants
from spherehand_torch.render.sphere import _mm_grid, ieee_sqrt

_C = Constants()

LAUNCHES = {"sphere_fused_primal": 0, "sphere_fused_fwd": 0, "sphere_fused_bwd": 0}
MAX_SPHERES = 64      # csrc/sphere.cu kMaxJ
MAX_PIXELS = 4096     # csrc/sphere.cu kPixelsPerThread * kBwdThreads
# The plain versions broadcast over (images, J, S, S) a chunk of images at a
# time, at most about this many elements per temporary.
PLAIN_CHUNK_ELEMENTS = 1 << 22

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> tuple[str, str]:
    """Compile ``csrc/sphere.cu`` under ``build/`` (``cuda_build.build``).
    Returns (library path, compiler log)."""
    return cuda_build.build("sphere")


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.shx_sphere_fused.argtypes = [ptr] * 3 + [i32] * 4 + [ptr] * 6 + [i32, ptr]
        lib.shx_sphere_fused.restype = i32
        lib.shx_sphere_fused_bwd.argtypes = [ptr] * 8 + [i32] * 4 + [ptr, ptr]
        lib.shx_sphere_fused_bwd.restype = i32
        lib.shx_sphere_error_string.argtypes = [i32]
        lib.shx_sphere_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ----------------------------------------------------------- plain versions


def _target_index(n: int, views: int, device) -> torch.Tensor:
    idx = torch.arange(n, device=device)
    return (idx // (views * views)) * views + idx % views


def _gathered_target(target: torch.Tensor, n: int, views: int) -> torch.Tensor:
    return target[_target_index(n, views, target.device)]


def _chunks(n: int, per_image: int):
    step = max(1, PLAIN_CHUNK_ELEMENTS // per_image)
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def _per_sphere_fields(centers, z, radii, size):
    """(n, J, S, S) per-sphere depth d, its sq, distance m and its raw, in
    the kernels' expression order, for images with observed depth z
    (n, S, S); plus the background mask of z."""
    xg, yg = _mm_grid(size, size, centers.dtype, centers.device)
    cx = centers[..., 0, None, None]
    cy = centers[..., 1, None, None]
    cz = centers[..., 2, None, None]
    r = radii[None, :, None, None]
    sq = r * r - (xg - cx) ** 2 - (yg - cy) ** 2
    depth = cz - ieee_sqrt(torch.clamp(sq, min=1e-2))
    d = torch.where(sq > 1e-2, depth, torch.full_like(depth, _C.background_depth))
    p_sq = xg * xg + yg * yg + z * z
    c_sq = cx * cx + cy * cy + cz * cz
    p_dot_c = xg * cx + yg * cy + z[:, None] * cz
    raw = p_sq[:, None] - 2.0 * p_dot_c + c_sq
    background = z > 99.0
    m = torch.abs(ieee_sqrt(torch.clamp(raw, min=1e-6)) - r)
    m = torch.where(background[:, None], torch.zeros_like(m), m)
    return d, sq, m, raw, background


def _first_min(field: torch.Tensor):
    """Min over the sphere axis 1 and its lowest index on a tie."""
    idx = field.argmin(dim=1, keepdim=True)
    return field.gather(1, idx)[:, 0], idx


def _chunked(fn, centers, target, views, *args):
    """Run ``fn(centers chunk, z chunk, *args)`` over chunks of images and
    concatenate each of its outputs."""
    n, num_j = centers.shape[:2]
    z = _gathered_target(target, n, views)
    size = z.shape[-1]
    outs = [fn(centers[a:b], z[a:b], *(x[a:b] for x in args))
            for a, b in _chunks(n, num_j * size * size)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def fused_primal_plain(centers, target, radii, size: int, views: int = 1):
    """Plain version of ``sphere_fused_primal``: (depth, dist), each (N, S, S)."""

    def chunk(c, z):
        d, _, m, _, _ = _per_sphere_fields(c, z, radii, size)
        return _first_min(d)[0], _first_min(m)[0]

    return _chunked(chunk, centers, target, views)


def fused_fwd_plain(centers, target, radii, size: int, views: int = 1):
    """Plain version of ``sphere_fused_fwd``: (depth, dist, amind, wd,
    aminm, wm), each (N, S, S); the argmin planes are int32."""
    return _chunked(lambda c, z: _fwd_chunk(c, z, radii, size), centers, target, views)


def _fwd_chunk(centers, z, radii, size):
    d, sq, m, raw, background = _per_sphere_fields(centers, z, radii, size)
    depth, idx_d = _first_min(d)
    dist, idx_m = _first_min(m)
    best_sq = sq.gather(1, idx_d)[:, 0]
    best_raw = raw.gather(1, idx_m)[:, 0]
    best_r = radii[idx_m[:, 0]]
    zero = torch.zeros_like(depth)
    wd = torch.where(best_sq > 1e-2, 1.0 / ieee_sqrt(torch.clamp(best_sq, min=1e-2)), zero)
    root = ieee_sqrt(torch.clamp(best_raw, min=1e-6))
    wm = torch.where(background | (best_raw < 1e-6), zero, torch.sign(root - best_r) / root)
    return (depth, dist, idx_d[:, 0].to(torch.int32), wd,
            idx_m[:, 0].to(torch.int32), wm)


def fused_bwd_plain(centers, target, views, g_depth, g_dist, amind, wd, aminm, wm):
    """Plain version of ``sphere_fused_bwd``: the summed (N, J, 3) centre
    gradient as masked per-sphere sums over the stored planes."""
    return _chunked(_bwd_chunk, centers, target, views, g_depth, g_dist, amind, wd, aminm, wm)[0]


def _bwd_chunk(centers, z, g_depth, g_dist, amind, wd, aminm, wm):
    num_j = centers.shape[1]
    size = g_depth.shape[-1]
    xg, yg = _mm_grid(size, size, g_depth.dtype, g_depth.device)
    ad = g_depth * wd
    cd = torch.where(wd > 0.0, g_depth, torch.zeros_like(g_depth))
    am = g_dist * wm
    js = torch.arange(num_j, device=centers.device)[None, :, None, None]
    sel_d = amind[:, None].long() == js
    sel_m = aminm[:, None].long() == js

    def msum(sel, a):
        return torch.where(sel, a[:, None], torch.zeros((), dtype=a.dtype, device=a.device)).sum(
            dim=(2, 3))

    s_ad, s_am = msum(sel_d, ad), msum(sel_m, am)
    gx = centers[..., 0] * (s_ad + s_am) - msum(sel_d, ad * xg) - msum(sel_m, am * xg)
    gy = centers[..., 1] * (s_ad + s_am) - msum(sel_d, ad * yg) - msum(sel_m, am * yg)
    gz = msum(sel_d, cd) + centers[..., 2] * s_am - msum(sel_m, am * z)
    return (torch.stack([gx, gy, gz], dim=-1),)


# ------------------------------------------------------------------ kernels


def _check(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def _check_inputs(centers, target, size, views):
    n, num_j = centers.shape[:2]
    if num_j > MAX_SPHERES or size * size > MAX_PIXELS or n % (views * views):
        raise ValueError(f"sphere kernels take J <= {MAX_SPHERES}, S*S <= {MAX_PIXELS} "
                         f"and N divisible by views**2; got N={n} J={num_j} S={size} V={views}")
    _check(centers, "centers", (n, num_j, 3))
    _check(target, "target", (n // views, size, size))


def _raise_on(rc: int, name: str, lib) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.shx_sphere_error_string(rc).decode()}")


def launch_fused(centers, target, radii, size: int, views: int, residuals: bool):
    """Run the forward kernel: (depth, dist) or, with ``residuals``, the six
    planes (depth, dist, amind, wd, aminm, wm)."""
    _check_inputs(centers, target, size, views)
    n, num_j = centers.shape[:2]
    _check(radii, "radii", (num_j,))
    plane = lambda dtype: torch.empty((n, size, size), dtype=dtype, device=centers.device)  # noqa: E731
    depth, dist = plane(torch.float32), plane(torch.float32)
    if residuals:
        res = (plane(torch.int32), plane(torch.float32), plane(torch.int32), plane(torch.float32))
        res_ptrs = [t.data_ptr() for t in res]
    else:
        res, res_ptrs = (), [None] * 4
    lib = _library()
    stream = torch.cuda.current_stream(centers.device).cuda_stream
    with torch.cuda.device(centers.device):
        rc = lib.shx_sphere_fused(
            centers.data_ptr(), radii.data_ptr(), target.data_ptr(), n, num_j, size, views,
            depth.data_ptr(), dist.data_ptr(), *res_ptrs, int(residuals), stream,
        )
    name = "sphere_fused_fwd" if residuals else "sphere_fused_primal"
    _raise_on(rc, name, lib)
    LAUNCHES[name] += 1
    return (depth, dist, *res)


def launch_fused_bwd(centers, target, views, g_depth, g_dist, amind, wd, aminm, wm):
    """Run the backward kernel -> (N, J, 3)."""
    n, num_j = centers.shape[:2]
    size = g_depth.shape[-1]
    _check_inputs(centers, target, size, views)
    for t, name, dtype in ((g_depth, "g_depth", torch.float32), (g_dist, "g_dist", torch.float32),
                           (amind, "amind", torch.int32), (wd, "wd", torch.float32),
                           (aminm, "aminm", torch.int32), (wm, "wm", torch.float32)):
        _check(t, name, (n, size, size), dtype)
    out = torch.empty((n, num_j, 3), dtype=torch.float32, device=centers.device)
    lib = _library()
    stream = torch.cuda.current_stream(centers.device).cuda_stream
    with torch.cuda.device(centers.device):
        rc = lib.shx_sphere_fused_bwd(
            centers.data_ptr(), target.data_ptr(), g_depth.data_ptr(), g_dist.data_ptr(),
            amind.data_ptr(), wd.data_ptr(), aminm.data_ptr(), wm.data_ptr(),
            n, num_j, size, views, out.data_ptr(), stream,
        )
    _raise_on(rc, "sphere_fused_bwd", lib)
    LAUNCHES["sphere_fused_bwd"] += 1
    return out


# --------------------------------------------------------------------- op


class SphereMinDepthAndD2m(torch.autograd.Function):
    """Forward with residual planes; backward = the backward kernel."""

    @staticmethod
    def forward(ctx, centers, target, radii, size, views):
        if centers.device.type == "cpu":
            planes = fused_fwd_plain(centers, target, radii, size, views)
        else:
            planes = launch_fused(centers, target, radii, size, views, residuals=True)
        depth, dist, amind, wd, aminm, wm = planes
        ctx.save_for_backward(centers, target, amind, wd, aminm, wm)
        ctx.views = views
        return depth, dist

    @staticmethod
    def backward(ctx, g_depth, g_dist):
        centers, target, amind, wd, aminm, wm = ctx.saved_tensors
        args = (centers, target, ctx.views, g_depth.contiguous(), g_dist.contiguous(),
                amind, wd, aminm, wm)
        grads = fused_bwd_plain(*args) if centers.device.type == "cpu" else launch_fused_bwd(*args)
        # the target is observed data and the radii are constants
        return grads, None, None, None, None


def sphere_min_depth_and_d2m(centers, target_dms, radii, size: int, views: int = 1):
    """Both mutual-projection fields of one sphere set.

    centers (N, J, 3) mm, target_dms (N / views, S, S) mm observed depth,
    radii (J,) -> (depth (N, S, S), dist (N, S, S)). Under autograd (grad
    enabled and ``centers`` requiring grad) the forward stores the residual
    planes and the backward launches the backward kernel; otherwise the
    primal kernel runs."""
    centers = centers.contiguous()
    target_dms = target_dms.to(centers.dtype).contiguous()
    radii = radii.to(centers.dtype).contiguous()
    if torch.is_grad_enabled() and centers.requires_grad:
        return SphereMinDepthAndD2m.apply(centers, target_dms, radii, size, views)
    if centers.device.type == "cpu":
        return fused_primal_plain(centers, target_dms, radii, size, views)
    return launch_fused(centers, target_dms, radii, size, views, residuals=False)
