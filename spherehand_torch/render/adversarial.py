"""Hostile triangle sets that pin the reference rasterizer's quirks.

The same geometry as ``tests/test_raster_pallas.py`` (off-screen, tiny and
giant faces) and ``tests/test_raster_adversarial.py`` (C-truncation quirks,
ties, slivers, tall faces, random fuzz), so the plain versions and the CUDA
kernels can be held against each other and against the JAX package on it.
"""
from __future__ import annotations

import numpy as np


def _both_windings(tri) -> list[np.ndarray]:
    """The face and its 0/1-swapped copy: exactly one is front-facing."""
    tri = np.asarray(tri, np.float32)
    return [tri, tri[[1, 0, 2]]]


def _pairs(tris) -> np.ndarray:
    return np.asarray([w for t in tris for w in _both_windings(t)], np.float32)


def adversarial_cases() -> list[tuple[str, np.ndarray, int]]:
    """[(name, faces (1, F, 3, 3) float32, canvas size)]. Canvas 128 cases
    are meant for the dense integer grid, the 640 case for the bilinear
    sample grid of ``render_depth_64``."""
    cases = [
        ("offscreen_tiny_giant", np.asarray([
            [[-900, -900, 50], [-800, -900, 50], [-850, -800, 50]],
            [[103, 103, 40], [116, 103, 40], [103, 116, 40]],
            [[4, 4, 70], [600, 4, 70], [4, 600, 70]],
        ], np.float32), 640),
        # p2x in (-1, 0): C truncation paints column 0 with extrapolated rows
        ("column0_quirk", _pairs([[[-6.0, 25.0, 50.0], [-0.6, 20.0, 50.0],
                                   [-0.4, 30.0, 50.0]]]), 128),
        ("column0_vertical_edge12", _pairs([[[-7.0, 90.0, 40.0], [-0.5, 60.0, 40.0],
                                             [-0.5, 95.0, 40.0]]]), 128),
        # ymax in (-1, 0): the row-bound cast fills row 0
        ("negative_y_row0", _pairs([[[20.0, -6.0, 50.0], [32.0, -6.0, 50.0],
                                     [26.0, -0.4, 50.0]]]), 128),
        ("shared_edge", _pairs([
            [[10.0, 10.0, 50.0], [90.0, 12.0, 60.0], [12.0, 88.0, 70.0]],
            [[90.0, 12.0, 60.0], [92.0, 90.0, 80.0], [12.0, 88.0, 70.0]],
        ]), 128),
        ("integer_x_and_ties", _pairs([
            [[10.0, 20.0, 50.0], [10.0, 60.0, 50.0], [40.0, 40.0, 50.0]],
            [[50.0, 20.0, 45.0], [80.0, 20.0, 45.0], [80.0, 50.0, 45.0]],
            [[20.0, 70.0, 42.0], [56.0, 70.0, 42.0], [38.0, 110.0, 42.0]],
            [[100.0, 100.0, 30.0], [100.0, 100.0, 30.0], [110.0, 105.0, 30.0]],
        ]), 128),
        ("slivers", _pairs([
            [[30.0, 5.0, 50.0], [30.3, 5.0, 50.0], [30.15, 120.0, 50.0]],
            [[5.0, 64.2, 60.0], [120.0, 64.5, 60.0], [5.0, 64.4, 60.0]],
            [[60.0, 7.9, 70.0], [60.2, 8.1, 70.0], [60.1, 72.2, 70.0]],
        ]), 128),
        ("tall_faces", _pairs([
            [[8.0, 8.0, 50.0], [24.0, 8.0, 50.0], [16.0, 120.0, 50.0]],
            [[40.0, 30.0, 45.0], [70.0, 30.0, 45.0], [55.0, 90.0, 45.0]],
            [[100.0, 100.0, 40.0], [112.0, 100.0, 40.0], [106.0, 126.0, 40.0]],
        ]), 128),
    ]
    rng = np.random.RandomState(3)
    verts = rng.uniform(-12, 128 + 12, (200, 3, 2)).astype(np.float32)
    z = rng.uniform(20, 90, (200, 3, 1)).astype(np.float32)
    cases.append(("random_fuzz", np.concatenate([verts, z], axis=-1), 128))
    return [(name, faces[None], size) for name, faces, size in cases]


def sphere_adversarial_case(views: int = 3, batch: int = 2, num_j: int = 41, size: int = 64,
                            seed: int = 5):
    """Hostile inputs for the fused sphere kernels, as numpy float32:
    (centers (B*V*V, J, 3) mm, target (B*V, S, S) mm, radii (J,)).

    - spheres 1 and 3 duplicate spheres 0 and 2 (radius included): exact
      ties in both fields, which the lowest-j rule gives to 0 and 2;
    - sphere 4 is centred on a pixel centre at the observed depth there, so
      its squared point distance is 0 and its distance weight is clipped;
    - the targets of batch row 0 are all background (every distance 0).
    """
    rng = np.random.RandomState(seed)
    n = batch * views * views
    centers = rng.uniform(-60, 60, (n, num_j, 3)).astype(np.float32)
    radii = rng.uniform(4, 12, (num_j,)).astype(np.float32)
    target = np.full((batch * views, size, size), 100.0, np.float32)
    target[views:, 12:52, 12:52] = rng.uniform(-60, 60, (target.shape[0] - views, 40, 40))
    centers[:, 1], radii[1] = centers[:, 0], radii[0]
    centers[:, 3], radii[3] = centers[:, 2], radii[2]
    u, v = 30, 33
    grid = lambda i: np.float32((np.float32(i) - np.float32(size / 2)) * np.float32(300.0)  # noqa: E731
                                / np.float32(size))
    for img in range(n):
        plane = (img // (views * views)) * views + img % views
        centers[img, 4] = (grid(u), grid(v), target[plane, v, u])
    return centers, target, radii


# Distances (mm) by which a disc misses (> 0) or overlaps (< 0) a tile's
# first or last pixel centre, around the forward kernel's one-pixel cull
# margin (300 / 64 = 4.6875 mm).
EDGE_OFFSETS_MM = (-4.6875, -1.0, -0.01, -1e-4, 0.0, 1e-4, 0.01, 1.0,
                   4.0, 4.6, 4.6875, 4.7, 5.0, 9.0, 9.375, 14.0)
CORNER_OFFSETS_MM = (-1.0, 0.0, 0.5, 4.0, 4.6875, 5.0, 6.0, 9.0)


def sphere_edge_case(views: int = 3, batch: int = 2, num_j: int = 41, size: int = 64,
                     seed: int = 6, tile: int = 8):
    """Inputs at the edges of the sphere kernels' shortcuts, as numpy
    float32: (centers (B*V*V, J, 3) mm, target (B*V, S, S) mm, radii (J,)).

    - spheres 5-20 and 31-38: discs whose edge lies within a few pixels of a
      ``tile`` x ``tile`` tile's edge, inside or outside (``EDGE_OFFSETS_MM``
      from a tile's first or last pixel centre, in x and then in y), and
      spheres 21-28 the same at a tile's corner (``CORNER_OFFSETS_MM``);
    - sphere 30 (r = 6) sits on pixel (4, 4) at cz = 106, where no other
      sphere reaches: its covered depth is >= 100 (100 at that pixel), so the
      uncovered sphere 0 (j lower) keeps the 100 there;
    - in every third image, sphere 0 (r = 6) sits on pixel (59, 59) at
      cz = 106: a covered depth of exactly 100 with the lowest j, ahead of
      every uncovered sphere;
    - target plane 0 is foreground at every pixel; planes 1 and 4 hold
      observations of exactly 99.0 (not background) and of 99.00001
      (background), and NaN (not background) at a few pixels.
    """
    rng = np.random.RandomState(seed)
    n = batch * views * views
    f32 = np.float32
    grid = lambda i: f32((f32(i) - f32(size / 2)) * f32(300.0) / f32(size))  # noqa: E731
    centers = rng.uniform(-60, 60, (n, num_j, 3)).astype(f32)
    radii = rng.uniform(4, 12, (num_j,)).astype(f32)
    radii[0] = radii[30] = 6.0
    for img in range(n):
        for k, delta in enumerate(EDGE_OFFSETS_MM):
            for j, axis in ((5 + k, 0), (31 + k // 2, 1)):
                if axis == 1 and k % 2:
                    continue
                edge = tile * (3 + (img + j) % 3)
                r = radii[j]
                # left of the tile starting at `edge`, or right of the one
                # ending at `edge - 1`
                centers[img, j, axis] = (grid(edge) - r - f32(delta) if (img + k) % 2 == 0
                                         else grid(edge - 1) + r + f32(delta))
        for k, delta in enumerate(CORNER_OFFSETS_MM):
            j = 21 + k
            reach = (radii[j] + f32(delta)) / f32(np.sqrt(2.0))
            edge = tile * (3 + (img + k) % 3)
            centers[img, j, 0] = grid(edge) - reach
            centers[img, j, 1] = grid(edge) - reach
        centers[img, 30] = (grid(4), grid(4), 106.0)
        if img % 3 == 0:
            centers[img, 0] = (grid(59), grid(59), 106.0)
    target = np.full((batch * views, size, size), 100.0, f32)
    target[:, 12:52, 12:52] = rng.uniform(-60, 60, (target.shape[0], 40, 40))
    target[0] = rng.uniform(-60, 60, (size, size))
    for plane in (1, 4):
        target[plane, 20, 12:52] = 99.0
        target[plane, 5, 5:60] = 99.0
        target[plane, 6, 5:60] = 99.00001
        target[plane, 30, 30] = target[plane, 31, 45] = target[plane, 2, 2] = np.nan
    return centers, target, radii
