"""A second reading of the two term ablations of the divergence study whose
seed-0 record leaves the JAX bars undecided (ROADMAP Queue 3 item 5):
``no_mv_projection`` and ``no_mv_consistency`` of
``spherehand_torch.tools.divergence_study --seed 1`` on the H100, on seed
1's own 72,192 + 2,048 hands x 3 views and its own draws, evals in float32
with TF32 off, under the tools' deterministic settings
(``card_records.sh divergence 1 no_mv_projection,no_mv_consistency``).

Held to the JAX test's bars on these two probes
(``tests/test_divergence_artifact.py:70-82``), written before the run:

  - ``no_mv_projection`` absorbs the shock: it ends under its start + 15
    mm, at its post-shock minimum;
  - ``no_mv_consistency`` collapses: it ends over its start + 30 mm and
    over ``no_mv_projection``'s final + 20 mm.

The seed-0 record and its test (``test_torch_divergence_artifact.py``)
stay as they are.
"""
import json
import os

import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "torch_divergence_seed1.json")
PROBES = ("no_mv_consistency", "no_mv_projection")
SEED0_BEFORE_MM = 49.4868  # torch_divergence_study.json: the seed-0 split's start


@pytest.fixture(scope="module")
def record():
    with open(GOLDEN) as f:
        return json.load(f)


def test_captured_on_seed_1_at_reference_scale_on_the_card(record):
    assert record["seed"] == 1
    assert record["data"]["samples"] >= 72_000 and record["data"]["test"] == 2048
    assert "H100" in record["backend"]
    assert record["stock_lr"] == 1e-3
    assert sorted(record["collapse"]) == sorted(PROBES)
    befores = {c["before_mm"] for c in record["collapse"].values()}
    assert len(befores) == 1 and befores != {SEED0_BEFORE_MM}  # seed 1's own test hands
    for name in PROBES:
        assert len(record["collapse"][name]["trajectory_mm"]) == 4, name  # before + 3 epochs
    # both probes trained through the port's kernels: raster_fast_pooled once
    # a combined step of each; the fused sphere forward and backward once a
    # step of the probe that keeps the mutual projection (no_mv_consistency)
    launches = record["launches"]
    assert launches["sphere_fused_fwd"] == launches["sphere_fused_bwd"] > 0
    assert launches["raster_fast_pooled"] == 2 * launches["sphere_fused_fwd"]
    assert launches["upsample2x_fwd"] > 0 and launches["upsample2x_bwd"] > 0


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP Queue 3 item 5 (open, narrowed): on seed 1 no_mv_projection climbs through all "
    "three epochs, 49.9471 -> 62.8417, 64.5754, 65.2150 mm, ending 15.27 mm above its start "
    "(bar: under 15) at its highest eval, not its lowest; on seed 0 it bent back (64.26, "
    "68.29, 60.58). no_mv_consistency collapses on seed 1 (96.3186 mm) as the JAX bars ask"))
def test_no_mv_projection_absorbs_the_shock(record):
    c = record["collapse"]["no_mv_projection"]
    t = c["trajectory_mm"]
    assert t[-1] < c["before_mm"] + 15.0, t
    assert t[-1] == min(t[1:]), t


def test_no_mv_consistency_collapses(record):
    c = record["collapse"]
    before = c["no_mv_consistency"]["before_mm"]
    final = c["no_mv_consistency"]["final_mm"]
    assert c["no_mv_consistency"]["collapsed"]
    assert final > before + 30.0, (final, before)
    assert final > c["no_mv_projection"]["final_mm"] + 20.0, (
        final, c["no_mv_projection"]["final_mm"])
