"""The binning pass of the ``raster_fast`` kernel (csrc/raster.cu), emulated on the CPU.

Up to ``BIN_MAX_TILES`` z-tiles an image the kernel first puts each face
into the list of every 64 x 64 z-tile whose sample range its box meets
(``raster_cuda.tile_bins`` mirrors that pass), and each tile then drains
only its own list. These tests show that the shortcut gives the plain
version's bits:

- every face that covers a sample of a tile under ``raster_fast_plain`` is
  in that tile's list, on hands, on the adversarial face sets and on a
  non-uniform grid of 3 x 3 tiles;
- a plain emulation of the drain (each tile rasterizes only its list, in a
  shuffled order) equals ``raster_fast_plain`` bit for bit, and holds the
  raw fast contract against JAX ``rasterize_depth_binned(..., exact=False)``
  without ``bilinear_grid`` (Pallas ``_raster_kernel_fast`` in interpret
  mode), as tests/test_torch_raster.py holds the plain version;
- the wrapper bins from one to ``BIN_MAX_TILES`` tiles an image.

Inputs: sampler-range poses drawn with numpy, through the port's geometry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spherehand_tpu.render import raster_pallas  # noqa: E402
from spherehand_torch.hand.assets import load_hand_model  # noqa: E402
from spherehand_torch.hand.kinematics import forward_kinematics  # noqa: E402
from spherehand_torch.hand.skinning import project_faces_planes  # noqa: E402
from spherehand_torch.render import contracts, raster_cuda  # noqa: E402
from spherehand_torch.render.adversarial import adversarial_cases  # noqa: E402
from spherehand_torch.render.raster import bilinear_sample_positions  # noqa: E402

SAMPLES = torch.from_numpy(bilinear_sample_positions(64, 10))
CASES = adversarial_cases()
Z = raster_cuda.ZTILE


def _non_uniform_grid():
    """150 x 131 samples, unevenly spaced over the canvas: 3 x 3 z-tiles."""
    rng = np.random.RandomState(6)
    sx = np.sort(rng.uniform(0.0, 640.0, 150)).astype(np.float32)
    sy = (np.linspace(0.0, 1.0, 131) ** 2 * 639.0).astype(np.float32)
    return torch.from_numpy(sx), torch.from_numpy(sy)


GRIDS = {"bilinear_128": (SAMPLES, SAMPLES), "non_uniform_150x131": _non_uniform_grid()}


@pytest.fixture(scope="module")
def hand_planes():
    """Two posed hands' (u, v, z) planes, poses drawn with numpy."""
    model = load_hand_model(device="cpu")
    poses = np.random.RandomState(12).uniform(-0.4, 0.4, (2, 26)).astype(np.float32)
    return project_faces_planes(model, forward_kinematics(model, torch.from_numpy(poses)), 640.0)


def _geometry(name, hand_planes):
    """(planes, sample_x, sample_y) of a hand grid or an adversarial set."""
    if name in GRIDS:
        return (hand_planes, *GRIDS[name])
    _, faces, size = next(c for c in CASES if c[0] == name)
    s = SAMPLES if size == 640 else torch.arange(size, dtype=torch.float32)
    return raster_cuda.planes_of(torch.from_numpy(faces)), s, s


def _covered_tiles(planes, sx, sy):
    """(B, tiles_y, tiles_x, F): whether face f covers a sample of the tile
    under ``raster_fast_plain``'s rule (inside the box, three raw
    barycentrics >= 0, a depth that is not NaN)."""
    records, box = raster_cuda.prepass_fast(planes=planes)
    batch, num_faces = records.shape[:2]
    tiles_x, tiles_y = raster_cuda.ztiles(sx.shape[0], sy.shape[0])
    x, y = sx[None, None, None, :], sy[None, None, :, None]
    out = []
    for s in range(0, num_faces, 128):
        f = records[:, s:s + 128, :, None, None]
        bd = box[:, s:s + 128, :, None, None]
        w0 = f[:, :, 0] * x + f[:, :, 1] * y + f[:, :, 2]
        w1 = f[:, :, 3] * x + f[:, :, 4] * y + f[:, :, 5]
        depth = 1.0 / (f[:, :, 6] * x + f[:, :, 7] * y + f[:, :, 8])
        cover = ((x >= bd[:, :, 0]) & (x <= bd[:, :, 1]) & (y >= bd[:, :, 2]) & (y <= bd[:, :, 3])
                 & (w0 >= 0.0) & (w1 >= 0.0) & (1.0 - w0 - w1 >= 0.0) & ~torch.isnan(depth))
        pad = torch.nn.functional.pad(cover, (0, tiles_x * Z - sx.shape[0], 0, tiles_y * Z - sy.shape[0]))
        out.append(pad.reshape(*pad.shape[:2], tiles_y, Z, tiles_x, Z).any(dim=5).any(dim=3))
    return torch.cat(out, dim=1).permute(0, 2, 3, 1)


def _drain_lists(planes, sx, sy, bins, seed=0):
    """Each tile rasterized from its own list alone, in a shuffled order
    (the kernel's lists hold faces in scheduling order)."""
    records, box = raster_cuda.prepass_fast(planes=planes)
    rng = np.random.RandomState(seed)
    out = torch.full((records.shape[0], sy.shape[0], sx.shape[0]), 1000.0)
    for b, ty, tx in np.ndindex(*bins.shape[:3]):
        faces = bins[b, ty, tx].nonzero()[:, 0]
        faces = faces[torch.from_numpy(rng.permutation(faces.numel()))]
        j0, i0 = ty * Z, tx * Z
        out[b, j0:j0 + Z, i0:i0 + Z] = raster_cuda.raster_fast_plain(
            records[b:b + 1, faces], box[b:b + 1, faces], sx[i0:i0 + Z], sy[j0:j0 + Z])[0]
    return out


CASE_NAMES = [*GRIDS, *(c[0] for c in CASES)]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_every_covering_face_is_in_its_tiles_list(hand_planes, name):
    planes, sx, sy = _geometry(name, hand_planes)
    bins = raster_cuda.tile_bins(planes, sx, sy)
    covered = _covered_tiles(planes, sx, sy)
    assert bins.shape == covered.shape
    assert not (covered & ~bins).any()
    if name in GRIDS:  # the lists hold the hand, each tile a part of it
        assert covered.any() and (bins.sum(dim=-1) < bins.shape[-1]).all()


@pytest.mark.parametrize("name", CASE_NAMES)
def test_draining_only_the_lists_equals_the_plain_version(hand_planes, name):
    planes, sx, sy = _geometry(name, hand_planes)
    bins = raster_cuda.tile_bins(planes, sx, sy)
    plain = raster_cuda.raster_fast_plain(*raster_cuda.prepass_fast(planes=planes), sx, sy)
    drained = _drain_lists(planes, sx, sy, bins)
    assert contracts.same_bits(drained, plain)
    assert contracts.same_bits(_drain_lists(planes, sx, sy, bins, seed=1), plain)


def test_binned_drain_matches_jax_fast_without_grid(hand_planes):
    """The emulated drain of one hand against JAX's raw fast kernel without
    ``bilinear_grid`` (interpret mode), by the raw fast contract of
    tests/test_torch_raster.py: IoU > 0.999, p99 < 0.5 mm on jointly covered
    samples."""
    planes = tuple(p[:1] for p in hand_planes)
    drained = _drain_lists(planes, SAMPLES, SAMPLES, raster_cuda.tile_bins(planes, SAMPLES, SAMPLES))
    u, v, z = planes
    fv = torch.stack([u, v, z], dim=-1).reshape(1, -1, 3, 3).numpy()
    ref = np.asarray(raster_pallas.rasterize_depth_binned(
        jnp.asarray(fv), jnp.asarray(SAMPLES.numpy()), jnp.asarray(SAMPLES.numpy()),
        interpret=True, exact=False))
    assert drained.shape == ref.shape == (1, 128, 128)
    assert (ref < 999).mean() > 0.05
    stats = contracts.fast_stats(np.zeros(1), np.zeros(1), drained.numpy(), ref)
    assert stats["raw_iou"] > 0.999 and stats["raw_p99"] < 0.5, stats


@pytest.mark.parametrize("sx_n, sy_n, binned", [
    (128, 128, True),           # render_depth_64's grid: 4 z-tiles
    (640, 640, True),           # the whole canvas: 100
    (1, 1, True),
    (64 * 2048, 1, True),       # BIN_MAX_TILES
    (64 * 2048 + 1, 1, False),  # one more: the binning pass's counters no longer fit
    (64 * 64, 64 * 33, False),
])
def test_raster_fast_bins_from_one_to_bin_max_tiles(sx_n, sy_n, binned):
    tiles_x, tiles_y = raster_cuda.ztiles(sx_n, sy_n)
    assert tiles_x == -(-sx_n // Z) and tiles_y == -(-sy_n // Z)
    assert raster_cuda.bins_faces(sx_n, sy_n) == binned
