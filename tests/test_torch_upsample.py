"""The port's 2x bilinear upsample against ``jax.image.resize`` (CPU).

Inputs are unit-scale normal draws from numpy. Measured gaps on these
inputs (this file's CPU run): forward 2.4e-7 of ``jax.image.resize``
(which contracts with weight matrices, in another order), the plain
backward 4.8e-7 of ``jax.vjp``'s; the limit is atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_torch.ops import upsample as up  # noqa: E402

# (N, C, H, W): the hourglass's two calls at a small batch, and small planes
# that are all border
SHAPES = [(2, 8, 4, 4), (2, 8, 8, 8), (1, 3, 1, 1), (1, 3, 1, 3), (1, 3, 5, 2)]
ATOL = 1e-6


def _jax_resize(x_nchw):
    n, c, h, w = x_nchw.shape
    return jax.image.resize(x_nchw.transpose(0, 2, 3, 1), (n, 2 * h, 2 * w, c), "bilinear")


def _draws(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape[:2] + (2 * shape[2], 2 * shape[3])).astype(np.float32)
    return x, g


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_jax_resize(shape):
    x, _ = _draws(shape, 0)
    ours = up.upsample2x_plain(torch.from_numpy(x)).numpy()
    ref = np.asarray(_jax_resize(jnp.asarray(x))).transpose(0, 3, 1, 2)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_jax_vjp_and_autograd(shape):
    """The explicit gather (the kernel's order) against jax.vjp of the
    resize and against autograd through the plain forward."""
    x, g = _draws(shape, 1)
    _, vjp = jax.vjp(_jax_resize, jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g).transpose(0, 2, 3, 1))[0])
    gathered = up.upsample2x_bwd_plain(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(gathered, ref, atol=ATOL, rtol=0)
    leaf = torch.from_numpy(x).requires_grad_(True)
    up.upsample2x_plain(leaf).backward(torch.from_numpy(g))
    np.testing.assert_allclose(gathered, leaf.grad.numpy(), atol=ATOL, rtol=0)
    # the op's own autograd path on the CPU is the gather
    leaf2 = torch.from_numpy(x).requires_grad_(True)
    up.upsample2x(leaf2).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(leaf2.grad.numpy(), gathered)


def test_bf16_is_float32_arithmetic_rounded_once():
    """bfloat16 in, bfloat16 out: the float32 result rounded once, forward
    and backward."""
    x, g = _draws((2, 8, 4, 4), 2)
    xb, gb = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    fwd = up.upsample2x_plain(xb)
    assert fwd.dtype == torch.bfloat16
    assert torch.equal(fwd, up.upsample2x_plain(xb.float()).bfloat16())
    bwd = up.upsample2x_bwd_plain(gb)
    assert bwd.dtype == torch.bfloat16
    assert torch.equal(bwd, up.upsample2x_bwd_plain(gb.float()).bfloat16())
    leaf = xb.clone().requires_grad_(True)
    up.upsample2x(leaf).backward(gb)
    assert leaf.grad.dtype == torch.bfloat16 and torch.equal(leaf.grad, bwd)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    up.reset_launch_counts()
    x, _ = _draws((1, 2, 4, 4), 3)
    leaf = torch.from_numpy(x).requires_grad_(True)
    y = up.upsample2x(leaf)
    y.sum().backward()
    with torch.no_grad():
        assert torch.equal(up.upsample2x(leaf), y)
    assert up.LAUNCHES == {"upsample2x_fwd": 0, "upsample2x_bwd": 0}
    with pytest.raises(ValueError, match="CUDA"):
        up.launch_fwd(torch.from_numpy(x))
    with pytest.raises(ValueError, match="CUDA"):
        up.launch_bwd(torch.zeros(1, 2, 8, 8))


class _FailingLibrary:
    """A build whose launches fail with the code of a bad configuration."""

    def __init__(self):
        self.calls = []

    def shx_upsample2x_fwd(self, *args):
        self.calls.append("fwd")
        return 9  # cudaErrorInvalidConfiguration

    shx_upsample2x_bwd = shx_upsample2x_fwd

    @staticmethod
    def shx_upsample_error_string(code):
        return b"invalid configuration argument"


def _no_fallback(monkeypatch):
    """A meta tensor stands in for a CUDA tensor (this host has none): the
    device check passes it, and the plain versions and F.interpolate may
    not be reached."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("fell back")

    monkeypatch.setattr(up, "_check", lambda t, name: None)
    monkeypatch.setattr(up.cuda_build, "launch", lambda fn, device, *args: fn(*args, None))
    monkeypatch.setattr(up, "upsample2x_plain", refuse)
    monkeypatch.setattr(up, "upsample2x_bwd_plain", refuse)
    monkeypatch.setattr(torch.nn.functional, "interpolate", refuse)
    return torch.zeros(2, 4, 4, 4, device="meta")


def test_a_failing_launch_raises_and_never_falls_back(monkeypatch):
    x = _no_fallback(monkeypatch)
    lib = _FailingLibrary()
    monkeypatch.setattr(up, "_library", lambda: lib)
    up.reset_launch_counts()
    with pytest.raises(RuntimeError, match="upsample2x_fwd launch failed: invalid configuration"):
        up.upsample2x(x)
    with pytest.raises(RuntimeError, match="upsample2x_bwd launch failed"):
        up.launch_bwd(torch.zeros(2, 4, 8, 8, device="meta"))
    assert lib.calls == ["fwd", "fwd"] and up.LAUNCHES["upsample2x_fwd"] == 0


def test_a_failing_build_raises_and_never_falls_back(monkeypatch):
    x = _no_fallback(monkeypatch)

    def no_nvcc():
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")

    monkeypatch.setattr(up, "_lib", None)
    monkeypatch.setattr(up, "build", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        up.upsample2x(x)


# ------------------------------------------- the kernels' work items, mirrored
# csrc/upsample.cu cannot run here; its decomposition can. These mirrors do
# the kernels' arithmetic by their work items (forward: output rows 2k, 2k+1
# at columns 4q .. 4q+3; backward: input row k at columns 4p .. 4p+3), with
# their clamps, tap positions and cut edges, and the grid's walk over planes.

EDGE_PLANES = [(1, 1), (1, 2), (2, 1), (1, 3), (3, 1), (2, 2), (4, 4), (8, 8), (5, 7), (3, 6),
               (6, 9), (2, 12), (7, 13), (9, 4), (40, 300)]


def _fwd_by_items(x: torch.Tensor) -> torch.Tensor:
    """(P, h, w) float32 -> (P, 2h, 2w) as ``upsample2x_fwd``'s work items."""
    p, h, w = x.shape
    qw = (w + 1) // 2
    k, q = torch.arange(h)[:, None], torch.arange(qw)[None, :]
    rows = [(k - 1).clamp(min=0), k, (k + 1).clamp(max=h - 1)]
    cols = [(2 * q - 1 + t).clamp(0, w - 1) for t in range(4)]
    a = [[x[:, r.expand(h, qw), c.expand(h, qw)] for c in cols] for r in rows]
    even = [0.25 * a[0][t] + 0.75 * a[1][t] for t in range(4)]
    odd = [0.75 * a[1][t] + 0.25 * a[2][t] for t in range(4)]
    y = torch.empty(p, 2 * h, 4 * qw)
    for parity, v in ((0, even), (1, odd)):
        outs = [0.25 * v[0] + 0.75 * v[1], 0.75 * v[1] + 0.25 * v[2],
                0.25 * v[1] + 0.75 * v[2], 0.75 * v[2] + 0.25 * v[3]]
        for s in range(4):
            y[:, parity::2, s::4] = outs[s]
    return y[:, :, :2 * w]  # a run past 2w is cut (w odd)


def _gather4(m, n, v0, v1, v2, v3):
    w1 = torch.where(m == 0, 1.0, 0.75)
    w2 = torch.where(m == n - 1, 1.0, 0.75)
    return ((0.25 * v0 + w1 * v1) + w2 * v2) + 0.25 * v3


def _bwd_by_items(g: torch.Tensor) -> torch.Tensor:
    """(P, 2h, 2w) float32 -> (P, h, w) as ``upsample2x_bwd``'s work items."""
    p, oh, ow = g.shape
    h, w = oh // 2, ow // 2
    pw = (w + 3) // 4
    k, q = torch.arange(h)[:, None].expand(h, pw), torch.arange(pw)[None, :].expand(h, pw)
    padded = torch.zeros(p, oh + 2, ow + 10)  # row r at r + 1, column c at c + 1
    padded[:, 1:oh + 1, 1:ow + 1] = g
    rows = []
    for t in range(4):
        r = 2 * k - 1 + t
        v = [padded[:, r + 1, 8 * q + l] for l in range(10)]  # columns 8p-1 .. 8p+8
        sums = [_gather4(4 * q + s, w, v[2 * s], v[2 * s + 1], v[2 * s + 2], v[2 * s + 3])
                for s in range(4)]
        inside = (r >= 0) & (r < oh)
        rows.append([torch.where(inside, x, 0.0) for x in sums])
    gx = torch.empty(p, h, 4 * pw)
    for s in range(4):
        gx[:, :, s::4] = _gather4(k, h, *(rows[t][s] for t in range(4)))
    return gx[:, :, :w]


@pytest.mark.parametrize("hw", EDGE_PLANES)
def test_kernel_work_items_equal_the_plain_versions(hw):
    """The kernels' decomposition, mirrored, gives the plain versions' bits
    at odd, non-square, one-pixel and wide planes."""
    h, w = hw
    rng = np.random.RandomState(h * 1000 + w)
    x = torch.from_numpy(rng.standard_normal((3, h, w)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 2 * h, 2 * w)).astype(np.float32))
    assert torch.equal(_fwd_by_items(x), up.upsample2x_plain(x[None])[0])
    assert torch.equal(_bwd_by_items(g), up.upsample2x_bwd_plain(g[None])[0])


def _walk(planes: int, items: int, threads: int = 256):
    """``walk_for`` and ``locate``: every (plane, item) a unit's threads own."""
    owned = []
    if items <= threads:
        per_block = threads // items
        units = -(-planes // per_block)
        tid = np.arange(per_block * items)
        for unit in range(units):
            plane = unit * per_block + tid // items
            keep = plane < planes
            owned.append(np.stack([plane[keep], (tid % items)[keep]], 1))
    else:
        per_plane = -(-items // threads)
        for unit in range(planes * per_plane):
            item = (unit % per_plane) * threads + np.arange(threads)
            item = item[item < items]
            owned.append(np.stack([np.full(item.shape, unit // per_plane), item], 1))
    return np.concatenate(owned)


@pytest.mark.parametrize("planes,items", [(1, 1), (300, 1), (7, 8), (33, 32), (5, 3), (4, 256),
                                          (3, 257), (2, 6000)])
def test_kernel_walk_owns_each_item_once(planes, items):
    owned = _walk(planes, items)
    assert len(owned) == planes * items
    assert len(np.unique(owned[:, 0] * items + owned[:, 1])) == planes * items
