"""The companion arms on the H100: where the port's companion recipe
(``tests/goldens/torch_recipe_at_scale.json``) leaves the JAX record
(``tests/goldens/recipe_at_scale.json``, a TPU v5e: 49.8575 -> 39.0056 mm
after epoch 0). ``tests/torch_companion_witness.py`` ran the arms, one
process each sharing the card (``card_records.sh companion``), and its
``--report --artifact`` wrote the record. Each arm is the record's companion
with one change: the split or the draws, bf16 convolutions, the batch, evals
inside the epochs, and at a cut size the card writer's hands.

The record's conclusion is held to the decision rule written before the
arms ran (PERF.md's Findings, the companion arms), restated here on the
record's numbers.
"""
import json
import math
import os

import pytest

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
CARD_ARMS = ("card_recipe_steps", "card_recipe_bf16", "card_recipe_seed1",
             "card_recipe_drawseed1", "card_recipe_cutbatch", "card_cut_cardhands")
SEED0_ARMS = ("card_recipe_steps", "card_recipe_bf16", "card_recipe_drawseed1",
              "card_recipe_cutbatch")
# The steps each arm runs: epochs of 2,887 steps, 8,160 at the cut batch,
# 8 epochs of 102 at the cut size.
STEPS = {"card_recipe_steps": 2 * 2887, "card_recipe_bf16": 3 * 2887,
         "card_recipe_seed1": 3 * 2887, "card_recipe_drawseed1": 3 * 2887,
         "card_recipe_cutbatch": 8160, "card_cut_cardhands": 8 * 102}
PATH_KERNELS = ("raster_fast_pooled", "sphere_fused_fwd", "sphere_fused_bwd",
                "sphere_fused_primal", "upsample2x_fwd", "upsample2x_bwd")


def _load(name="torch_companion_arms.json"):
    with open(os.path.join(GOLDENS, name)) as f:
        return json.load(f)


def _mm(rec):
    return [e["mm"] for e in rec["evals"]]


@pytest.mark.parametrize("arm", CARD_ARMS)
def test_arm_ran_on_an_h100_with_its_power_limit(arm):
    rec = _load()["arms"][arm]
    assert "NVIDIA H100" in rec["backend"] and rec["backend"].endswith(" W"), rec["backend"]
    assert rec["launches"]["sphere_fused_bwd"] == rec["steps"]  # one combined step each
    assert all(rec["launches"].get(k, 0) > 0 for k in PATH_KERNELS), rec["launches"]


@pytest.mark.parametrize("arm", CARD_ARMS)
def test_arm_evals_are_finite_over_all_its_steps(arm):
    rec = _load()["arms"][arm]
    assert all(math.isfinite(m) and math.isfinite(e["raw_mm"])
               for m, e in zip(_mm(rec), rec["evals"]))
    assert rec["evals"][0]["step"] == 0
    assert rec["evals"][-1]["step"] == rec["steps"] == STEPS[arm]


def test_steps_arm_reproduces_the_record():
    """Evals inside the epochs leave the run as it was: the start and the
    eval after epoch 0 are the companion record's, bit for bit."""
    rec = _load()["arms"]["card_recipe_steps"]
    record = _load("torch_recipe_at_scale.json")["companion"]["trajectory"]
    assert rec["evals"][0]["mm"] == record[0]["mm"] == 49.4868
    at_2887 = [e for e in rec["evals"] if e["step"] == 2887]
    assert [e["mm"] for e in at_2887] == [record[1]["mm"]] == [44.9737]
    assert at_2887[0]["raw_mm"] == record[1]["raw_mm"]


@pytest.mark.parametrize("arm", SEED0_ARMS)
def test_seed0_arms_read_the_record_split(arm):
    record = _load("torch_recipe_at_scale.json")["companion"]
    assert _load()["arms"][arm]["data_sha256"] == record["data_sha256"]


def test_seed1_arm_reads_its_own_split():
    art = _load()
    record = _load("torch_recipe_at_scale.json")["companion"]
    rec = art["arms"]["card_recipe_seed1"]
    assert rec["split_seed"] == 1 and rec["config"]["seed"] == 1
    assert rec["data_sha256"] != record["data_sha256"]
    assert art["arms"]["card_recipe_drawseed1"]["config"]["seed"] == 1


def _rule(arms, rule):
    """The decision rule in PERF.md's Findings, stated anew."""
    def gain(rec, step=None):  # before less the eval at ``step`` (the last)
        mm = {e["step"]: e["mm"] for e in rec["evals"]}
        return rec["evals"][0]["mm"] - mm[rec["evals"][-1]["step"] if step is None else step]

    def epoch0(rec):
        return [e["mm"] for e in rec["evals"] if e["epoch"] == 0 and e["end"]][0]

    near = 39.0056 + rule["near_mm"]
    spread = [a for a in ("card_recipe_seed1", "card_recipe_drawseed1")
              if epoch0(arms[a]) <= near
              or min(_mm(arms[a])[1:]) < _mm(arms[a])[0] - rule["gap_bar_mm"]]
    steps = arms["card_recipe_steps"]
    shown = {"spread": bool(spread),
             "numerics": not spread and epoch0(arms["card_recipe_bf16"]) <= near,
             "batch": (gain(arms["card_recipe_cutbatch"], 816) >= rule["cut_gain_mm"]
                       and _mm(steps)[0] - min(_mm(steps)[1:]) < rule["cut_gain_mm"])}
    low = rule["card_port_gain_mm"] - rule["miss_mm"]
    if "jax_cardhands" in arms:
        jax, port = gain(arms["jax_cardhands"]), gain(arms["port_cardhands"])
        shown["code"] = jax >= port + rule["code_gap_mm"]
        shown["data"] = max(jax, port) < low and abs(jax - port) < rule["code_gap_mm"]
    outcome = next((k for k in ("code", "spread", "numerics", "batch", "data")
                    if shown.get(k)), "none")
    return outcome, spread, gain(arms["card_cut_cardhands"]) < low


def test_conclusion_follows_the_rule():
    art = _load()
    assert art["rule"] == {"near_mm": 2.0, "gap_bar_mm": 10.0, "cut_gain_mm": 7.0,
                           "card_port_gain_mm": 8.24, "miss_mm": 3.0, "code_gap_mm": 3.0,
                           "turn_mm": 44.0}
    assert art["jax_record"]["epoch0"] == 39.0056
    assert _load("recipe_at_scale.json")["companion"]["trajectory"][1]["mm"] == 39.0056
    outcome, spread, miss = _rule(art["arms"], art["rule"])
    conclusion = art["conclusion"]
    assert conclusion["outcome"] == outcome
    assert conclusion["spread_arms"] == spread
    assert conclusion["cardhands_miss"] == miss
    # the CPU arms run when, and only when, the card's hands miss
    assert ("jax_cardhands" in art["arms"]) == miss
    closed = outcome in ("code", "spread", "numerics", "data")
    assert conclusion["item6"] == ("closed" if closed else "narrowed")
    inside = [e for e in art["arms"]["card_recipe_steps"]["evals"]
              if e["epoch"] == 0 and not e["end"]]
    assert conclusion["shape"]["epoch0_low_mm"] == min(e["mm"] for e in inside)


def _seed1():
    return _load()["seed1_companion"]


def test_seed1_companion_ran_to_its_end_on_the_card():
    """The companion on the seed-1 split and draws, carried over calls of
    the card to its 24th epoch, repeats the seed-1 arm's evals bit for bit."""
    run, arm = _seed1(), _load()["arms"]["card_recipe_seed1"]
    assert run["finished"] and run["steps"] == 24 * 2887
    config = run["config"]
    assert (config["seed"], config["lr"], config["epoch"]) == (1, 3e-5, 24)
    assert config["eval_precision"] == "highest"
    assert run["backend"].endswith(" W")
    assert all("NVIDIA H100" in call["backend"] for call in run["calls"])
    assert run["data_sha256"] == arm["data_sha256"]
    assert run["launches"]["sphere_fused_bwd"] == run["steps"]
    assert all(run["launches"].get(k, 0) > 0 for k in PATH_KERNELS), run["launches"]
    assert [e["mm"] for e in run["trajectory"][:4]] == _mm(arm)
    assert all(math.isfinite(e["mm"]) for e in run["trajectory"])


def test_seed1_companion_closes_domain_gap_at_reference_scale():
    """The JAX test's gain bars (``tests/test_recipe_artifact.py``) on the
    seed-1 draw."""
    traj = _seed1()["trajectory"]
    before = traj[0]["mm"]
    best = min(e["mm"] for e in traj[1:])
    final = traj[-1]["mm"]
    assert best < before - 10.0, (before, best)
    assert final < before - 7.0, (before, final)


def test_seed1_companion_finishes_stable_at_reference_scale():
    traj = _seed1()["trajectory"]
    assert max(e["mm"] for e in traj[1:]) < traj[0]["mm"] + 5.0
