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
