"""The shortcuts of the sphere kernels (csrc/sphere.cu), emulated on the CPU.

The forward kernel skips the distance loop at background pixels and runs
the depth field only over the spheres whose disc may reach a pixel tile
(``render/sphere_cuda.tile_covered`` mirrors its test); the backward leaves
out pixels whose terms are all +-0. These tests show that each shortcut
gives the plain versions' bits:

- the tile test never culls a (tile, sphere) pair with a covered pixel, on
  pseudo-real hands and on every adversarial set;
- a plain emulation of the forward kernel (the lowest culled sphere as the
  seed, the covered spheres after it, background skip, the NaN order of
  torch.argmin) equals ``fused_fwd_plain``,
  ``fused_primal_plain`` and the one-field plain versions bit for bit;
- the backward without all-zero pixels equals ``fused_bwd_plain`` bit for
  bit, a NaN cotangent at a zero-weight pixel included.

tests/test_torch_sphere_ops.py holds the plain fields on the edge inputs
against op-by-op JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spherehand_torch.render import sphere_cuda as sc  # noqa: E402
from spherehand_torch.render.contracts import same_bits  # noqa: E402
from spherehand_torch.render.adversarial import (  # noqa: E402
    sphere_adversarial_case,
    sphere_edge_case,
)
from spherehand_torch.render.sphere import ieee_sqrt  # noqa: E402

S = 64


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _random_case(seed=7, n=6, num_j=41):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-80, 80, (n, num_j, 3)).astype(np.float32)
    radii = rng.uniform(4, 12, (num_j,)).astype(np.float32)
    z = np.full((n, S, S), 100.0, np.float32)
    z[:, 16:48, 16:48] = rng.uniform(-60, 60, (n, 32, 32))
    return centers, z, radii, 1


@pytest.fixture(scope="module")
def hands():
    """The projected sphere centres of a pseudo-real batch of 2 hands x 3
    views against its depth maps, as the combined step builds them."""
    from spherehand_torch.data.pseudo_real import render_multiview_batch, sphere_inputs
    from spherehand_torch.hand.assets import load_hand_model

    model = load_hand_model(device="cpu")
    return sphere_inputs(model, render_multiview_batch(model, torch.Generator().manual_seed(4), 2))


def _case(name, hands):
    if name == "hands":
        return hands
    if name == "random":
        centers, target, radii, views = _random_case()
    else:
        make = sphere_adversarial_case if name == "adversarial" else sphere_edge_case
        (centers, target, radii), views = make(), 3
    return (*_t(centers, target, radii), views)


CASES = ["hands", "random", "adversarial", "edge"]


def _per_pixel(covered, size):
    """(n, T, T, J) tile flags -> (n, J, S, S) per pixel."""
    tile = sc.TILE
    per = covered.repeat_interleave(tile, 1).repeat_interleave(tile, 2)[:, :size, :size]
    return per.permute(0, 3, 1, 2)


@pytest.mark.parametrize("case", CASES)
def test_tile_test_never_culls_a_covered_pair(case, hands):
    """Every (tile, sphere) pair with a pixel inside the disc (sq > 1e-2, the
    depth field's own test) is kept; on hands the test culls most pairs."""
    centers, _, radii, _ = _case(case, hands)
    _, sq = sc._depth_fields(centers, radii, S)
    kept = _per_pixel(sc.tile_covered(centers, radii, S), S)
    assert not ((sq > 1e-2) & ~kept).any()
    if case == "hands":
        share = float(sc.tile_covered(centers, radii, S).float().mean())
        assert share < 0.2, share


def test_edge_case_probes_the_margin():
    """The edge spheres put pairs on both sides of the cull margin: kept
    pairs with no covered pixel, and culled pairs whose disc edge lies
    within two pixels of the tile."""
    centers, _, radii, _ = _case("edge", None)
    _, sq = sc._depth_fields(centers, radii, S)
    tile = sc.TILE
    t = S // tile
    inside = (sq > 1e-2).reshape(sq.shape[0], sq.shape[1], t, tile, t, tile).any(dim=(3, 5))
    kept = sc.tile_covered(centers, radii, S).permute(0, 3, 1, 2)
    assert (kept & ~inside).any() and (~kept).any()
    grid = ((torch.arange(S, dtype=torch.float32) - S / 2) * 300.0) / S
    gap = (centers[..., 0, None] + radii[:, None] - grid[::tile]).abs()  # disc edge to tile start
    assert ((gap > sc.CULL_MARGIN_MM) & (gap < 2 * sc.CULL_MARGIN_MM)).any()


def _takes(a, b):
    """csrc/sphere.cu ``takes``: a < b, or a NaN against a number."""
    return (a < b) | (torch.isnan(a) & ~torch.isnan(b))


def emulated_fields(centers, target, radii, size, views):
    """The forward kernel, vectorised over pixels: depth seeded with (100, the
    lowest sphere culled from the pixel's tile), then the covered spheres in
    ascending j, a candidate of equal depth winning only with a lower j;
    distance over every sphere at foreground pixels only (background writes
    0, 0, 0). Returns (depth, dist, amind, wd, aminm, wm) as
    ``fused_fwd_plain``."""
    n, num_j = centers.shape[:2]
    d_all, sq_all = sc._depth_fields(centers, radii, size)
    z = sc.gathered_target(target, n, views)
    m_all, raw_all, background = sc._dist_fields(centers, z, radii, size)
    covered = _per_pixel(sc.tile_covered(centers, radii, size), size)
    shape = (n, size, size)
    any_culled = ~covered.all(dim=1)
    lowest_culled = (~covered).int().argmax(dim=1).to(torch.int32)
    best_d = torch.where(any_culled, torch.full(shape, 100.0), torch.full(shape, float("inf")))
    best_jd = torch.where(any_culled, lowest_culled, torch.zeros(shape, dtype=torch.int32))
    best_sq = torch.zeros(shape)
    for j in range(num_j):
        d = d_all[:, j]
        upd = covered[:, j] & (_takes(d, best_d) | ((d == best_d) & (j < best_jd)))
        best_d = torch.where(upd, d, best_d)
        best_jd = torch.where(upd, torch.full_like(best_jd, j), best_jd)
        best_sq = torch.where(upd, sq_all[:, j], best_sq)
    wd = torch.where(best_sq > 1e-2, 1.0 / ieee_sqrt(torch.clamp(best_sq, min=1e-2)),
                     torch.zeros_like(best_sq))
    best_m = torch.full(shape, float("inf"))
    best_jm = torch.zeros(shape, dtype=torch.int32)
    best_raw = torch.zeros(shape)
    best_r = torch.zeros(shape)
    for j in range(num_j):
        upd = ~background & _takes(m_all[:, j], best_m)
        best_m = torch.where(upd, m_all[:, j], best_m)
        best_jm = torch.where(upd, torch.full_like(best_jm, j), best_jm)
        best_raw = torch.where(upd, raw_all[:, j], best_raw)
        best_r = torch.where(upd, radii[j].expand(shape), best_r)
    zero = torch.zeros(shape)
    dist = torch.where(background, zero, best_m)
    aminm = torch.where(background, torch.zeros_like(best_jm), best_jm)
    root = ieee_sqrt(torch.clamp(best_raw, min=1e-6))
    diff = root - best_r
    sign = (diff > 0).float() - (diff < 0).float()
    wm = torch.where(background | (best_raw < 1e-6), zero, sign / root)
    return best_d, dist, best_jd, wd, aminm, wm


@pytest.mark.parametrize("case", CASES)
def test_emulated_forward_equals_plain_bit_for_bit(case, hands):
    centers, target, radii, views = _case(case, hands)
    ours = emulated_fields(centers, target, radii, S, views)
    fwd = sc.fused_fwd_plain(centers, target, radii, S, views)
    for name, a, b in zip(("depth", "dist", "amind", "wd", "aminm", "wm"), ours, fwd):
        assert same_bits(a, b), name
    primal = sc.fused_primal_plain(centers, target, radii, S, views)
    assert same_bits(ours[0], primal[0]) and same_bits(ours[1], primal[1])
    z = sc.gathered_target(target, centers.shape[0], views)
    for a, b in zip((ours[0], ours[2], ours[3]), sc.min_depth_fwd_plain(centers, radii, S)):
        assert same_bits(a, b)
    for a, b in zip((ours[1], ours[4], ours[5]), sc.d2m_fwd_plain(z, centers, radii, S)):
        assert same_bits(a, b)
    if case == "edge":
        nan = torch.isnan(z)
        assert nan.any() and torch.isnan(ours[1][nan]).all() and (ours[4][nan] == 0).all()
        assert (ours[1][z == 99.0] > 0).all()   # 99.0 is foreground
        # sphere 0 wins pixel (59, 59) with depth 100 and a weight; sphere 30's
        # depth >= 100 loses to the uncovered sphere 0 at pixel (4, 4)
        every_third = torch.arange(0, centers.shape[0], 3)
        assert (ours[0][every_third, 59, 59] == 100.0).all()
        assert (ours[2][every_third, 59, 59] == 0).all() and (ours[3][every_third, 59, 59] > 0).all()
        assert (ours[0][:, 4, 4] == 100.0).all() and (ours[2][:, 4, 4] == 0).all()
        assert (ours[3][:, 4, 4] == 0).all()


def emulated_bwd(centers, target, views, g_depth, g_dist, amind, wd, aminm, wm):
    """``fused_bwd_plain`` without the pixels whose terms are all +-0, the
    backward kernel's skip (a NaN term is not 0)."""
    size, num_j = g_depth.shape[-1], centers.shape[1]
    z = sc.gathered_target(target, centers.shape[0], views)
    sums = []
    for amin, terms in ((amind, sc._depth_terms(g_depth, wd, size)),
                        (aminm, sc._dist_terms(g_dist, wm, z, size))):
        live = torch.stack([t != 0 for t in terms]).any(dim=0)
        sums += sc._masked_sum(torch.where(live, amin, torch.full_like(amin, -1)), num_j, terms)
    s_ad, s_adx, s_ady, s_cd, s_am, s_amx, s_amy, s_amz = sums
    gx = centers[..., 0] * (s_ad + s_am) - s_adx - s_amx
    gy = centers[..., 1] * (s_ad + s_am) - s_ady - s_amy
    gz = s_cd + centers[..., 2] * s_am - s_amz
    return torch.stack([gx, gy, gz], dim=-1)


@pytest.mark.parametrize("case", CASES)
def test_backward_without_zero_pixels_equals_plain_bit_for_bit(case, hands):
    centers, target, radii, views = _case(case, hands)
    _, _, amind, wd, aminm, wm = sc.fused_fwd_plain(centers, target, radii, S, views)
    rng = np.random.RandomState(11)
    g_depth, g_dist = _t(*rng.uniform(-1, 1, (2,) + amind.shape).astype(np.float32))
    # a NaN cotangent at a pixel of zero weight in each field
    i_d = torch.nonzero(wd == 0)[0].tolist()
    i_m = torch.nonzero(wm == 0)[-1].tolist()
    g_depth[tuple(i_d)] = float("nan")
    g_dist[tuple(i_m)] = float("nan")
    planes = (amind, wd, aminm, wm)
    ours = emulated_bwd(centers, target, views, g_depth, g_dist, *planes)
    ref = sc.fused_bwd_plain(centers, target, views, g_depth, g_dist, *planes)
    assert same_bits(ours, ref)
    # the depth cotangent reaches x and y through A_d = g w (z takes [w > 0] g)
    assert torch.isnan(ours[i_d[0], amind[tuple(i_d)], :2]).all()
    assert torch.isnan(ours[i_m[0], aminm[tuple(i_m)]]).all()
    live = torch.isfinite(ours).all(dim=-1)
    assert live.sum() > 0 and (ours[live] != 0).any()
