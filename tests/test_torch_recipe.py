"""The recipe trio of the port (``spherehand_torch.tools.reference_recipe``,
``recipe_artifact``, ``divergence_study``) on the CPU: their pure pieces
against the JAX tools' own on the same records, each tool's ``run()`` at a
tiny size (finite trajectories with the JAX keys; the recipe resumed equal
to an uninterrupted run; the study resumed and merged), and no tool writes
a JAX record."""
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from spherehand_torch.tools import (  # noqa: E402
    divergence_study,
    recipe_artifact,
    reference_recipe,
)
from spherehand_torch.train import engine as engine_mod  # noqa: E402
from spherehand_torch.utils import determinism  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GOLDENS = os.path.join(ROOT, "tests", "goldens")
TINY = dict(real_batch=1, synt_batch=1, eval_batch=2)
SAMPLES, TEST = 3, 2  # 3 combined steps an epoch


def _jax_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module; the JAX settings
    its import changes (a compilation cache) are put back."""
    saved = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                  "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for key, value in saved.items():
            jax.config.update(key, value)
    return module


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def recipe_runs(tmp_path_factory):
    """A 2-epoch recipe run, the same run stopped after its first epoch
    (its state file then), and that run resumed to the end."""
    root = tmp_path_factory.mktemp("recipe")
    small = dict(samples=SAMPLES, test=TEST, epochs=2, device="cpu", engine_overrides=TINY)
    whole = reference_recipe.run(out=str(root / "whole"), **small)
    os.makedirs(root / "resumed")
    os.symlink(root / "whole" / "data", root / "resumed" / "data")
    real_epoch = engine_mod.Engine._epoch_combined

    def stop_at_1(self, epoch):
        if epoch == 1:
            raise _Stop
        return real_epoch(self, epoch)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(engine_mod.Engine, "_epoch_combined", stop_at_1)
        with pytest.raises(_Stop):
            reference_recipe.run(out=str(root / "resumed"), **small)
    unfinished = {"port": recipe_artifact._load_run(str(root / "resumed")),
                  "jax": _jax_tool("recipe_artifact")._load_run(str(root / "resumed"))}
    resumed = reference_recipe.run(out=str(root / "resumed"), **small)
    return {"root": root, "whole": whole, "resumed": resumed, "unfinished": unfinished}


@pytest.fixture(scope="module")
def study(recipe_runs, tmp_path_factory):
    """Two divergence probes of one epoch over the recipe's data: the
    instrumented stock run (a diag every other step, an eval inside the epoch)
    in one process's directory, mv_never in another's, then merged."""
    root = tmp_path_factory.mktemp("study")
    common = dict(data=str(recipe_runs["root"] / "whole" / "data"), samples=SAMPLES, test=TEST,
                  epochs=1, stock_epochs=1, diag_every=2, eval_every_steps=2, lrs="",
                  device="cpu", engine_overrides=TINY)
    names = divergence_study.probe_names(lrs="")

    def skip_all_but(keep):
        return ",".join(n for n in names if n != keep)

    a = divergence_study.run(out=str(root / "a"), skip=skip_all_but("stock_instrumented"),
                             **common)
    divergence_study.run(out=str(root / "b"), skip=skip_all_but("mv_never"), **common)
    merged = divergence_study.run(out=str(root / "all"), skip=",".join(names),
                                  merge=[str(root / "a"), str(root / "b")],
                                  artifact=str(root / "torch_divergence_study.json"), **common)
    with open(root / "torch_divergence_study.json") as f:
        artifact = json.load(f)
    return {"a": a, "merged": merged, "artifact": artifact, "root": root, "common": common,
            "only_stock": skip_all_but("stock_instrumented")}


def test_recipe_run_has_the_jax_keys_and_finite_evals(recipe_runs):
    """The run's trajectory.json: the JAX tool's keys (plus the parameter
    hash and launches), an eval before and after each epoch, finite."""
    whole = recipe_runs["whole"]
    assert set(whole) == {"config", "samples", "test", "sensor_shift", "steps", "train_secs",
                          "trajectory", "backend", "params_sha256", "launches"}
    assert whole["steps"] == 2 * SAMPLES // TINY["real_batch"] and whole["backend"] == "cpu"
    assert [p["epoch"] for p in whole["trajectory"]] == [-1, 0, 1]
    assert [p["label"] for p in whole["trajectory"]] == ["before", "train", "train"]
    assert [p["lr"] for p in whole["trajectory"]] == [1e-3, 1e-3, 1e-4]  # StepLR, 2 epochs
    for p in whole["trajectory"]:
        assert set(p) == {"epoch", "label", "lr", "step", "avg_joint_error",
                          "avg_joint_error_raw"}
        assert np.isfinite([p["avg_joint_error"], p["avg_joint_error_raw"]]).all()
    assert whole["config"]["eval_precision"] == "highest" and whole["config"]["lr"] == 1e-3


def test_recipe_resume_equals_the_uninterrupted_run(recipe_runs):
    """Stopped after epoch 0 and run again with the same --out: it resumes
    at epoch 1 from the rolling checkpoint and ends bit for bit where the
    uninterrupted run ends (trajectory and parameter hash)."""
    whole, resumed = recipe_runs["whole"], recipe_runs["resumed"]
    assert resumed["trajectory"] == whole["trajectory"]
    assert resumed["params_sha256"] == whole["params_sha256"]
    assert resumed["steps"] == whole["steps"]


def test_load_run_equals_the_jax_tools(recipe_runs):
    """``_load_run`` of a finished and of an unfinished run, the port's
    against the JAX tool's on the same files."""
    jax_tool = _jax_tool("recipe_artifact")
    finished = str(recipe_runs["root"] / "whole")
    assert recipe_artifact._load_run(finished) == jax_tool._load_run(finished)
    unfinished = recipe_runs["unfinished"]
    assert unfinished["port"] == unfinished["jax"]
    assert unfinished["port"]["finished"] is False and len(unfinished["port"]["trajectory"]) == 2


def test_recipe_artifact_keys(recipe_runs, tmp_path, monkeypatch):
    """The record: the JAX record's keys, with ``eval_precision`` in place
    of its wobble note; each run's keys as the JAX record's."""
    monkeypatch.setattr(determinism, "enable", dict)  # the process's settings stay
    out = tmp_path / "torch_recipe_at_scale.json"
    recipe_artifact.main(["--stock", str(recipe_runs["root"] / "whole"),
                          "--companion", str(recipe_runs["root"] / "resumed"), "--out", str(out)])
    with open(out) as f:
        art = json.load(f)
    with open(os.path.join(GOLDENS, "recipe_at_scale.json")) as f:
        jax_art = json.load(f)
    assert set(art) == set(jax_art) - {"eval_precision_note"} | {"eval_precision"}
    assert art["eval_precision"] == "highest"
    for run in ("stock", "companion"):
        assert set(art[run]) == set(jax_art[run])
        assert set(art[run]["trajectory"][0]) == set(jax_art[run]["trajectory"][0])


def test_divergence_probes_have_the_jax_keys(study):
    """The instrumented probe: the diag record's keys (``combined_term_diag``),
    a diag every other step, the evals inside and after the epoch; the standard
    probe's trajectory; all finite."""
    stock = study["a"]["probes"]["stock_instrumented"]
    steps = SAMPLES // TINY["real_batch"]
    assert [r["it"] for r in stock["diag"]] == list(range(0, steps, 2))
    assert {"total_grad_norm", "mv_projection/value", "mv_projection/grad_norm",
            "mv_projection/cos_total"} <= set(stock["diag"][0])
    assert [(t["epoch"], t["it"]) for t in stock["trajectory"]] == [(-1, 0), (0, 2), (0, -1)]
    never = study["merged"]["probes"]["mv_never"]
    assert never["overrides"] == {"mv_curriculum_iters": 0}
    for probe in (stock, never):
        assert np.isfinite([t["mm"] for t in probe["trajectory"]]).all()


def test_divergence_study_resumes_and_merges(study, monkeypatch):
    """A second run over a study.json that holds its probe runs none again;
    the merged study holds both processes' probes, and the artifact the JAX
    record's keys (and the launch counters)."""
    def run_again(*_args, **_kwargs):
        raise AssertionError("a probe in study.json ran again")

    monkeypatch.setattr(divergence_study, "run_instrumented_stock", run_again)
    again = divergence_study.run(out=str(study["root"] / "a"), skip=study["only_stock"],
                                 **study["common"])
    assert again["probes"] == study["a"]["probes"]
    assert set(study["merged"]["probes"]) == {"stock_instrumented", "mv_never"}
    assert study["merged"]["probes"]["stock_instrumented"] == study["a"]["probes"][
        "stock_instrumented"]
    with open(os.path.join(GOLDENS, "divergence_study.json")) as f:
        jax_art = json.load(f)
    assert set(study["artifact"]) == set(jax_art) | {"launches"}
    assert set(study["artifact"]["collapse"]) == {"stock_instrumented", "mv_never"}


def test_summarize_diag_equals_the_jax_tools(study):
    records = study["a"]["probes"]["stock_instrumented"]["diag"]
    want = _jax_tool("divergence_study").summarize_diag(records)
    assert divergence_study.summarize_diag(records) == want
    assert divergence_study.summarize_diag([]) == {}


def test_collapse_row_reproduces_the_jax_record():
    """``collapse_row(margin=5.0)`` on each probe trajectory of the JAX
    record gives that record's row."""
    with open(os.path.join(GOLDENS, "divergence_study.json")) as f:
        collapse = json.load(f)["collapse"]
    probes = {name: {"trajectory": [{"mm": mm} for mm in row["trajectory_mm"]]}
              for name, row in collapse.items()}
    for name, row in collapse.items():
        assert divergence_study.collapse_row({"probes": probes}, name) == row
    assert divergence_study.collapse_row({"probes": probes}, "lr_1e-2") is None


def test_probe_names_are_the_jax_records():
    with open(os.path.join(GOLDENS, "divergence_study.json")) as f:
        assert sorted(divergence_study.probe_names()) == sorted(json.load(f)["collapse"])


def test_no_tool_writes_a_jax_record(tmp_path):
    with pytest.raises(ValueError, match="golden"):
        reference_recipe.run(out=os.path.join(GOLDENS, "recipe_run"), device="cpu")
    with pytest.raises(SystemExit, match="golden"):
        recipe_artifact.main(["--out", os.path.join(GOLDENS, "recipe_at_scale.json")])
    with pytest.raises(ValueError, match="golden"):
        divergence_study.run(out=str(tmp_path), device="cpu",
                             artifact=os.path.join(GOLDENS, "divergence_study.json"))
    with pytest.raises(SystemExit, match="golden"):
        divergence_study.main(["--artifact", os.path.join(GOLDENS, "divergence_study.json")])
    assert not os.path.exists(os.path.join(GOLDENS, "recipe_run"))
