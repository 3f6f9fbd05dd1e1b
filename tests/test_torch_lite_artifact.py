"""The port's lite-against-full record on the H100
(``spherehand_torch.tools.lite_mesh_e2e`` at 75,000 steps, the arms in
processes of their own sharing the card, joined with ``--merge``), held to
the JAX test's own bars (``tests/test_lite_mesh.py:89-101``), written down
before the run: an estimator trained on lite renders lands within 0.5 mm of
one trained on full renders, both evaluated on full-mesh held-out renders,
and full reproduces the baseline (under 8.0 mm)."""
import json
import os

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "torch_lite_mesh_e2e.json")


def _load():
    with open(GOLDEN) as f:
        return json.load(f)


def test_captured_on_the_card_at_length():
    art = _load()
    assert art["steps"] >= 50_000
    assert "H100" in art["backend"] and art["seed"] == 0
    assert art["launches"]["raster_fast_pooled"] > 0


def test_lite_matches_full_training():
    art = _load()
    gap = art["lite"]["heldout_mm"] - art["full"]["heldout_mm"]
    assert gap < 0.5, art


def test_full_reproduces_the_baseline():
    art = _load()
    assert art["full"]["heldout_mm"] < 8.0, art
