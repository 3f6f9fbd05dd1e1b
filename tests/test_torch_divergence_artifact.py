"""The port's record of what drives the stock recipe's divergence
(``spherehand_torch.tools.divergence_study`` on the H100: the recipe's
72,192 x 3 pseudo-NYU split, the reference batch geometry, evals in float32
with TF32 off, the tools' deterministic settings, seed 0), held to every
bar of the JAX test (``tests/test_divergence_artifact.py:39-100``), written
down before the run, with "TPU" read as the card's name:

  - the mutual-projection term dominates the update direction (the
    largest per-term gradient norm, a cosine with the total over 0.6 and
    0.3 above every other term's) and its value runs 30x above the rest;
  - removing it is the only single-term ablation that bends the
    trajectory back down; every other ablation and the stock run collapse
    by more than 30 mm;
  - both lr probes between 3e-5 and 1e-3 still degrade, monotonically
    within 1 mm;
  - pinning the is_mv window on or off still collapses.
"""
import json
import os

import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "torch_divergence_study.json")


def _load():
    with open(GOLDEN) as f:
        return json.load(f)


def test_captured_at_reference_scale_on_the_card():
    art = _load()
    assert art["data"]["samples"] >= 72_000
    assert "H100" in art["backend"]
    assert art["stock_lr"] == 1e-3
    # every arm starts from the same synthetic-pretrained eval point
    befores = {c["before_mm"] for c in art["collapse"].values()}
    assert len(befores) == 1


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP Queue 3 item 4 (closed as the data): on the H100 the collision term leads the "
    "stock run's update direction (cosine median 0.760, gradient-norm median 3,940 against "
    "mutual projection's 0.558 and 3,188); the TPU v5e record ranked mutual projection first "
    "(0.760). On 25 hands of the port's pseudo-NYU writer at the shipped weights, JAX's own "
    "combined_term_diag ranks collision first too (cosine 0.991 against 0.207, the port 0.994 "
    "against 0.208; tests/torch_diag_first_record.py)"))
def test_mv_projection_dominates_the_update_direction():
    d = _load()["diag_summary"]
    terms = [t for t in d if t != "total_grad_norm"]
    mv = d["mv_projection"]
    for t in terms:
        if t == "mv_projection":
            continue
        assert mv["grad_norm_median"] >= d[t]["grad_norm_median"], t
        assert mv["cos_total_median"] >= d[t]["cos_total_median"] + 0.3, t
    assert mv["cos_total_median"] > 0.6
    others = max(d[t]["value_median"] for t in terms if t != "mv_projection")
    assert mv["value_median"] > 30 * others


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP Queue 3 item 5 (open): no_mv_consistency ends at 78.067 mm, 28.58 mm above the "
    "start, short of the bar's 30 (and 17.48 above no_mv_projection's 60.584, short of 20); "
    "no_mv_projection alone bends back, as on the TPU v5e"))
def test_only_the_mv_projection_ablation_recovers():
    c = _load()["collapse"]
    before = c["no_mv_projection"]["before_mm"]
    t = c["no_mv_projection"]["trajectory_mm"]
    assert t[-1] < before + 15.0
    assert t[-1] == min(t[1:])
    for name in ("no_mv_consistency", "no_prior", "no_collision",
                 "no_bone_length", "stock_instrumented"):
        assert c[name]["collapsed"], name
        assert c[name]["final_mm"] > before + 30.0, name
        assert c[name]["final_mm"] > t[-1] + 20.0, name


def test_lr_stability_boundary_below_1e4():
    c = _load()["collapse"]
    for name in ("lr_3e-4", "lr_1e-4"):
        t = c[name]["trajectory_mm"]
        assert c[name]["collapsed"], name
        assert all(b >= a - 1.0 for a, b in zip(t, t[1:])), (name, t)


def test_curriculum_is_not_the_cause():
    c = _load()["collapse"]
    for name in ("mv_always", "mv_never"):
        assert c[name]["collapsed"], name
