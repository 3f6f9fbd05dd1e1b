"""The hourglass's 2x bilinear upsample (half-pixel centres): its CUDA kernels
and their plain versions.

Counterpart of ``spherehand_tpu/models/hourglass.py:86-89``
(``jax.image.resize(..., "bilinear")`` at scale 2), which XLA lowers with no
Pallas kernel. The port's kernels (``spherehand_torch/csrc/upsample.cu``)
take the place of PyTorch's ``upsample_bilinear2d``, whose backward adds
with atomics: a kernel here writes every element from one thread in a fixed
order, so a step's gradients do not change from run to run.

Output row 2k takes 0.25 of input row k-1 and 0.75 of row k, row 2k+1 0.75
of row k and 0.25 of row k+1, an index past the edge reading the border
(``jax.image.resize`` renormalises the weights inside the image to the
same rule); the rows first, then the columns. The backward gathers output
rows 2k-1 .. 2k+2 of each input row (weights 0.25, 0.75, 0.75, 0.25; 1.0
for the border's own rows), each row's columns first. Arithmetic is float32
in that order, one rounding to the input's dtype (float32 or bfloat16).

- :func:`upsample2x_plain`: slices, border rows and weighted adds in the
  kernel's order, differentiable by autograd;
- :func:`upsample2x_bwd_plain`: the backward's gather in the kernel's order;
- :func:`upsample2x`: the op. A CPU tensor takes the plain versions; a CUDA
  tensor launches the kernels (``launch_fwd``, ``launch_bwd``) or raises.
  ``LAUNCHES`` counts the launches of each kernel.
"""
from __future__ import annotations

import ctypes

import torch

from spherehand_torch import cuda_build

LAUNCHES = {"upsample2x_fwd": 0, "upsample2x_bwd": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/upsample.cu kFloat32, kBFloat16

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> tuple[str, str]:
    """Compile ``csrc/upsample.cu`` under ``build/`` (``cuda_build.build``).
    Returns (library path, compiler log)."""
    return cuda_build.build("upsample")


def bind(path: str):
    """Load a build of ``csrc/upsample.cu`` and declare its C interface."""
    lib = ctypes.CDLL(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for fn in (lib.shx_upsample2x_fwd, lib.shx_upsample2x_bwd):
        fn.argtypes = [ptr, ptr, i64, i32, i32, i32, ptr]
        fn.restype = i32
    lib.shx_upsample_error_string.argtypes = [i32]
    lib.shx_upsample_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = bind(build()[0])
    return _lib


# ----------------------------------------------------------- plain versions


def _up_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """2x along ``dim``: even outputs 0.25 prev + 0.75 own, odd 0.75 own +
    0.25 next, the border repeated."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even = prev * 0.25 + x * 0.75
    odd = x * 0.75 + nxt * 0.25
    out = torch.stack([even, odd], dim + 1)
    return out.reshape(*x.shape[:dim], 2 * n, *x.shape[dim + 1:])


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W), in float32, rounded once to x's dtype."""
    return _up_axis(_up_axis(x.float(), 2), 3).to(x.dtype)


def _gather_axis(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The backward along ``dim`` (2n outputs -> n inputs):
    ((0.25 g[2k-1] + w1 g[2k]) + w2 g[2k+1]) + 0.25 g[2k+2], a missing
    output 0, w1 = 1 at the first input and w2 = 1 at the last (else
    0.75)."""
    n = g.shape[dim] // 2
    even = g.narrow(dim, 0, 2 * n).unflatten(dim, (n, 2)).select(dim + 1, 0)
    odd = g.narrow(dim, 0, 2 * n).unflatten(dim, (n, 2)).select(dim + 1, 1)
    zero = torch.zeros_like(even.narrow(dim, 0, 1))
    odd_prev = torch.cat([zero, odd.narrow(dim, 0, n - 1)], dim)
    even_next = torch.cat([even.narrow(dim, 1, n - 1), zero], dim)
    shape = [1] * g.dim()
    shape[dim] = n
    w1 = torch.full((n,), 0.75, dtype=g.dtype, device=g.device)
    w2 = w1.clone()
    w1[0] = 1.0
    w2[-1] = 1.0
    return ((odd_prev * 0.25 + even * w1.view(shape)) + odd * w2.view(shape)) + even_next * 0.25


def upsample2x_bwd_plain(g: torch.Tensor) -> torch.Tensor:
    """Cotangent (N, C, 2H, 2W) -> gradient (N, C, H, W), in float32 in the
    backward kernel's order, rounded once to g's dtype."""
    return _gather_axis(_gather_axis(g.float(), 3), 2).to(g.dtype)


# ------------------------------------------------------------------ kernels


MAX_PLANE = 2**31 - 1  # csrc/upsample.cu: 32-bit offsets inside the larger (2H, 2W) plane


def _check(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in DTYPES or not t.is_contiguous() or t.dim() != 4:
        raise ValueError(f"{name}: expected a contiguous 4-D float32 or bfloat16 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.shape[-2] * t.shape[-1] * (4 if name == "x" else 1) > MAX_PLANE:
        raise ValueError(f"{name}: a plane of {tuple(t.shape[-2:])} is past the kernels' "
                         f"{MAX_PLANE} elements")


def _run(name: str, src: torch.Tensor, out_shape: tuple, h: int, w: int) -> torch.Tensor:
    """Launch ``name`` on ``src`` into a new tensor of ``out_shape``; (h, w)
    are the input planes' (the smaller) sizes."""
    lib = _library()
    out = torch.empty(out_shape, dtype=src.dtype, device=src.device)
    rc = cuda_build.launch(getattr(lib, f"shx_{name}"), src.device, src.data_ptr(), out.data_ptr(),
                 out_shape[0] * out_shape[1], h, w, DTYPES[src.dtype])
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.shx_upsample_error_string(rc).decode()}")
    LAUNCHES[name] += 1
    return out


def launch_fwd(x: torch.Tensor) -> torch.Tensor:
    """The forward kernel: (N, C, H, W) -> (N, C, 2H, 2W)."""
    _check(x, "x")
    n, c, h, w = x.shape
    return _run("upsample2x_fwd", x, (n, c, 2 * h, 2 * w), h, w)


def launch_bwd(g: torch.Tensor) -> torch.Tensor:
    """The backward kernel: (N, C, 2H, 2W) -> (N, C, H, W)."""
    _check(g, "g")
    n, c, oh, ow = g.shape
    if oh % 2 or ow % 2:
        raise ValueError(f"g: expected even spatial sizes, got {tuple(g.shape)}")
    return _run("upsample2x_bwd", g, (n, c, oh // 2, ow // 2), oh // 2, ow // 2)


# ---------------------------------------------------------------------- op


class _Upsample2x(torch.autograd.Function):
    """Forward and backward: the kernels for CUDA tensors, the plain
    versions for CPU tensors."""

    @staticmethod
    def forward(ctx, x):
        return upsample2x_plain(x) if x.device.type == "cpu" else launch_fwd(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return upsample2x_bwd_plain(g) if g.device.type == "cpu" else launch_bwd(g)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 with half-pixel centres, (N, C, H, W) -> (N, C, 2H, 2W)
    (== ``jax.image.resize(..., "bilinear")``)."""
    x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return _Upsample2x.apply(x)
    return upsample2x_plain(x) if x.device.type == "cpu" else launch_fwd(x)
