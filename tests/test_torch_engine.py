"""The port's engine (``spherehand_torch.train.engine``) on the CPU, on fake
NYU shards at tiny widths, against the JAX engine's rules: the run
directory, checkpoints and resume, the epoch modes, the learning-rate and
curriculum schedule, the card-resident data path, eval and ``result.npz``.

The JAX engine itself is not run (its tests are slow-marked for their
compile time): its rules are read from its configuration and its source."""
import ast
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spherehand_tpu.evaluation import offline as joffline  # noqa: E402
from spherehand_tpu.losses.multitask import LOSS_WEIGHTS as JAX_LOSS_WEIGHTS  # noqa: E402
from spherehand_tpu.train.config import EngineConfig as JEngineConfig  # noqa: E402
from spherehand_torch.data.nyu import write_shard  # noqa: E402
from spherehand_torch.evaluation import offline  # noqa: E402
from spherehand_torch.hand.assets import load_hand_model  # noqa: E402
from spherehand_torch.infer import load_estimator  # noqa: E402
from spherehand_torch.train.config import EngineConfig  # noqa: E402
from spherehand_torch.train.engine import Engine, step_seed  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_ENGINE = os.path.join(ROOT, "spherehand_tpu", "train", "engine.py")
SPLITS = {"train": (1, 1), "test": (4,)}  # samples per shard
EPOCH_FNS = ("_epoch_synt", "_epoch_combined", "_epoch_real_train", "_epoch_real_eval")


@pytest.fixture(scope="module")
def hand():
    return load_hand_model(device="cpu")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Fake shards as ``tests/test_engine.py`` writes them: a train split of
    two shards of one sample (a batch of 2 gathers across them) and a test
    split of 4."""
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp("nyu")
    for subset, sizes in SPLITS.items():
        d = root / subset
        d.mkdir()
        for i, n in enumerate(sizes):
            dms = np.full((n, 3, 64, 64), 100.0, np.float32)
            dms[:, :, 24:44, 24:44] = rng.uniform(20, 60, (n, 3, 20, 20))
            joints = rng.uniform(-80, 80, (n, 3, 36, 3)).astype(np.float32)
            poses = np.tile(np.eye(4, dtype=np.float32), (n, 3, 1, 1))
            write_shard(str(d), f"mv_data_{i}", dms, joints, poses)
    return str(root)


def _cfg(model_dir, data_dir, **kw):
    base = dict(mode="Train", model_dir=str(model_dir), dataset_dir=data_dir, epoch=2,
                real_batch=2, synt_batch=2, eval_batch=2, synt_iters_per_epoch=1, tag="t_")
    return EngineConfig(**{**base, **kw})


def _snapshot(state):
    return {
        "network": {k: v.clone() for k, v in state.network.state_dict().items()},
        "optimizer": {i: {k: v.clone() for k, v in s.items()}
                      for i, s in state.optimizer.state_dict()["state"].items()},
        "step": state.step, "prev_skel": state.prev_skel.clone(),
        "has_prev": state.has_prev.clone(),
    }


def _assert_same(a, b):
    assert a["step"] == b["step"]
    assert torch.equal(a["prev_skel"], b["prev_skel"]) and torch.equal(a["has_prev"], b["has_prev"])
    assert a["network"].keys() == b["network"].keys()
    for k, v in a["network"].items():
        assert torch.equal(v, b["network"][k]), k
    assert a["optimizer"].keys() == b["optimizer"].keys()
    for i, s in a["optimizer"].items():
        for k, v in s.items():
            assert torch.equal(v, b["optimizer"][i][k]), (i, k)


def _records(engine):
    with open(engine.metrics_file) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, data_dir, hand):
    """A: 2 combined epochs (host loader). B: 1 epoch (card-resident path),
    C: resumed from B's latest for 1 more. Then eval of A's last epoch."""
    model_dir = tmp_path_factory.mktemp("runs")
    a = Engine(_cfg(model_dir, data_dir, device_data="off"), device="cpu", hand=hand)
    init = _snapshot(a.state)
    a.train()
    b = Engine(_cfg(model_dir, data_dir, epoch=1, device_data="on"), device="cpu", hand=hand)
    b.train()
    c = Engine(_cfg(model_dir, data_dir, device_data="on", restore_from_model=b.model_name),
               device="cpu", hand=hand)
    restored, c_start = _snapshot(c.state), c.starting_epoch
    c.train()
    ckpt = os.path.join(a.model_path, "model_1.pt")
    ev = Engine(_cfg(model_dir, data_dir, mode="Test", initial_model=ckpt,
                     eval_precision="highest"), device="cpu", hand=hand)
    result = ev.eval()
    return {"a": a, "b": b, "c": c, "init": init, "restored": restored, "c_start": c_start,
            "ev": ev, "result": result, "ckpt": ckpt, "model_dir": model_dir}


@pytest.fixture(scope="module")
def other_modes(tmp_path_factory, data_dir, hand):
    """One synthetic-only epoch (no real loss) and one real-only epoch at
    ``eval_batch`` 2 with ``real_batch`` 3 (draws sized by the batch given)."""
    model_dir = tmp_path_factory.mktemp("modes")
    synt = Engine(_cfg(model_dir, data_dir, epoch=1, mv_projection=False, mv_consistency=False,
                       collision=False, bone_length=False, prior=False), device="cpu", hand=hand)
    synt.train()
    real = Engine(_cfg(model_dir, data_dir, epoch=1, synthesize=False, real_batch=3),
                  device="cpu", hand=hand)
    real.train()
    return {"synt": synt, "real": real}


def test_combined_run_writes_the_run_directory(runs):
    a, init = runs["a"], runs["init"]
    assert a.state.step == 2  # 2 epochs of 1 batch (2 train samples, batch 2)
    names = set(os.listdir(a.model_path))
    assert {"loss_weights.txt", "config.json", "log.txt", "metrics.jsonl", "images"} <= names
    for which, epoch in ((-1, 1), (0, 0), (1, 1)):
        assert f"model_{which}.pt" in names
        with open(os.path.join(a.model_path, f"model_{which}.meta.json")) as f:
            assert json.load(f) == {"epoch": epoch, "step": epoch + 1}
    with open(os.path.join(a.model_path, "config.json")) as f:
        assert json.load(f)["device_data"] == "off"
    moved = [k for k, v in a.state.network.state_dict().items()
             if not torch.equal(v, init["network"][k])]
    assert len(moved) == len(init["network"])
    records = _records(a)
    assert [(r["mode"], r["epoch"], r["it"]) for r in records] == [("both", 0, 0), ("both", 1, 0)]
    assert all(np.isfinite(v) for r in records for v in r.values() if isinstance(v, float))
    with open(a.log_file) as f:
        assert f.read().count("metric+loss") == 2


def test_loss_weights_file_equals_jax(runs):
    with open(os.path.join(runs["a"].model_path, "loss_weights.txt")) as f:
        text = f.read()
    assert text == json.dumps(JAX_LOSS_WEIGHTS)


def _jax_fixed_keys() -> dict[str, set]:
    """The constant keys of each ``_log_metrics`` record the JAX engine's
    per-step epoch loops and eval write, by mode."""
    with open(JAX_ENGINE) as f:
        tree = ast.parse(f.read())
    out = {}
    for fn in ast.walk(tree):
        if not (isinstance(fn, ast.FunctionDef) and fn.name in EPOCH_FNS):
            continue
        for call in ast.walk(fn):
            if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                    and call.func.attr == "_log_metrics"):
                rec = call.args[0]
                keys = {k.value for k in rec.keys if k is not None}
                mode = next(v.value for k, v in zip(rec.keys, rec.values)
                            if k is not None and k.value == "mode")
                out[mode] = keys
    return out


def test_metrics_records_keep_the_jax_fixed_keys(runs, other_modes):
    fixed = _jax_fixed_keys()
    assert fixed == {"synt": {"epoch", "it", "mode"}, "real": {"epoch", "it", "mode"},
                     "both": {"epoch", "it", "mode", "steps_per_sec"},
                     "eval": {"epoch", "mode"}}
    every = set().union(*fixed.values())
    seen = set()
    for engine in (runs["a"], runs["ev"], other_modes["synt"], other_modes["real"]):
        for rec in _records(engine):
            seen.add(rec["mode"])
            assert set(rec) & every == fixed[rec["mode"]], rec
            metrics = {k: v for k, v in rec.items() if k not in every}
            assert metrics and all(np.isfinite(v) for v in metrics.values()), rec
    assert seen == set(fixed)


def test_resume_from_latest_equals_the_uninterrupted_run(runs):
    """1 epoch, resume from the rolling latest, 1 more epoch: bit for bit
    the 2-epoch run (the draws and index plan depend on (seed, epoch, it)
    alone; the restored state is the saved one). The resumed run starts at
    the epoch after the one the latest holds."""
    a, b, c = runs["a"], runs["b"], runs["c"]
    assert runs["c_start"] == 1 and c.model_path == b.model_path
    with open(os.path.join(b.model_path, "model_-1.meta.json")) as f:
        assert json.load(f) == {"epoch": 1, "step": 2}  # rewritten by C's epoch 1
    _assert_same(_snapshot(c.state), _snapshot(a.state))
    b_records = _records(c)  # B's epoch 0 and C's epoch 1, one file
    assert [r["epoch"] for r in b_records] == [0, 1]
    assert b_records == _records(a)


def test_restore_puts_back_the_saved_state(runs, data_dir, hand):
    """Full resume restores what B saved, bit for bit (parameters, Adam
    moments, step, temporal state); ``initial_model`` restores the weights
    only: a fresh optimizer, step 0, epoch 0."""
    b = runs["b"]
    saved = torch.load(os.path.join(b.model_path, "model_0.pt"), weights_only=True)
    restored = runs["restored"]
    assert restored["step"] == saved["step"] == 1 and saved["epoch"] == 0
    for k, v in saved["network"].items():
        assert torch.equal(restored["network"][k], v), k
    for i, s in saved["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(restored["optimizer"][i][k], v), (i, k)
    assert torch.equal(restored["prev_skel"], saved["prev_skel"])
    weights_only = Engine(_cfg(runs["model_dir"], data_dir,
                               initial_model=os.path.join(b.model_path, "model_0.pt")),
                          device="cpu", hand=hand)
    assert weights_only.starting_epoch == 0 and weights_only.state.step == 0
    assert not weights_only.state.optimizer.state_dict()["state"]
    for k, v in saved["network"].items():
        assert torch.equal(weights_only.state.network.state_dict()[k], v), k
    explicit = Engine(_cfg(runs["model_dir"], data_dir, restore_from_model=b.model_name,
                           restore_from_epoch=0), device="cpu", hand=hand)
    assert explicit.starting_epoch == 1 and explicit.state.step == 1


def test_lr_is_mv_and_draws_follow_the_jax_rule(tmp_path, data_dir, hand):
    """Each combined step gets ``lr_at_epoch(epoch)`` of the JAX
    configuration, ``is_mv = it < mv_curriculum_iters`` (engine.py:241)
    and the draws of ``(seed, epoch, it)``; ``steps_per_call`` 2 runs the
    same steps one by one and says so once in log.txt."""
    cfg = _cfg(tmp_path, data_dir, epoch=4, real_batch=1, mv_curriculum_iters=1, lr=3e-3,
               steps_per_call=2, device_data="off")
    engine = Engine(cfg, device="cpu", hand=hand)
    calls = []

    def record(state, lr, draws, batch, is_mv):
        calls.append((lr, is_mv, draws.poses.clone(), batch.dms.shape[0]))
        return state, {"loss": torch.zeros(())}, None

    engine.steps = engine.steps._replace(combined_step=record)
    engine.train()
    ref = JEngineConfig(epoch=4, lr=3e-3, mv_curriculum_iters=1)
    expect = [(ref.lr_at_epoch(e), it < ref.mv_curriculum_iters) for e in range(4)
              for it in range(2)]
    assert [c[:2] for c in calls] == expect
    assert {c[3] for c in calls} == {1}
    for n, (e, it) in enumerate((e, it) for e in range(4) for it in range(2)):
        assert torch.equal(calls[n][2], engine.step_draws(e, it).poses)
    assert not torch.equal(calls[0][2], calls[1][2])
    assert len({step_seed(0, e, it) for e in range(4) for it in range(4)}) == 16
    with open(engine.log_file) as f:
        log = f.read()
    assert log.count("steps_per_call 2") == 1
    assert log.count("[viz] dump failed") == 4  # no images from the stand-in step


def test_device_data_gathers_the_host_loaders_batches(tmp_path, data_dir, hand):
    """The card-resident split gives the host loader's batches bit for bit
    (the same index plan, exact gathers); ``auto`` above its cap uses the
    host loader."""
    engines = {mode: Engine(_cfg(tmp_path, data_dir, device_data=mode), device="cpu", hand=hand)
               for mode in ("on", "off")}
    for train, batch, epoch, steps in ((True, 2, 0, 1), (True, 1, 1, 2), (False, 3, 0, 1)):
        got = {m: list(e.batches(train, batch, epoch)) for m, e in engines.items()}
        assert len(got["on"]) == len(got["off"]) == steps
        for (i_on, on), (i_off, off) in zip(got["on"], got["off"]):
            np.testing.assert_array_equal(i_on, i_off)
            for x, y in zip(on, off):
                assert (x is None and y is None) or torch.equal(x, y)
    assert engines["on"]._resident_data[True] is not None
    capped = Engine(_cfg(tmp_path, data_dir, device_data="auto", device_data_max_gb=1e-6),
                    device="cpu", hand=hand)
    assert capped._resident(True) is None
    with open(capped.log_file) as f:
        assert "using the host loader" in f.read()


def test_synthetic_only_and_real_only_epochs(other_modes):
    synt, real = other_modes["synt"], other_modes["real"]
    assert synt.state.step == 1 and real.state.step == 1  # 2 samples at eval_batch 2
    (s,), r = _records(synt), _records(real)
    assert s["mode"] == "synt" and "synt_joint_err" in s
    assert [x["mode"] for x in r] == ["real"] and "avg_joint_error" in r[0]
    assert set(synt.steps_per_sec) == {"synt"} and set(real.steps_per_sec) == {"real"}
    assert os.path.exists(os.path.join(real.model_path, "model_0.pt"))


def test_eval_writes_result_npz_for_the_offline_evaluator(runs, data_dir, tmp_path):
    ev = runs["ev"]
    path = os.path.join(ev.model_path, "result.npz")
    with np.load(path) as f:
        gt, est = f["gt"], f["est"]
    assert gt.shape == (4, 36, 3) and est.shape == (4, 41, 3)
    test = ev._split(train=False)
    np.testing.assert_array_equal(gt, test.gather_joints(np.arange(4))[:, 0])
    assert np.isfinite(runs["result"]["avg_joint_error"])
    # the same checkpoint served: the eval step's denoised view-0 joints
    served = load_estimator(runs["ckpt"], device="cpu", precision="highest")
    np.testing.assert_allclose(served.predict(test.gather_dms(np.arange(4))[:, 0]), est,
                               atol=1e-4)
    # the port's offline evaluator equals the JAX package's on that file
    outs = {}
    for name, mod in (("port", offline), ("jax", joffline)):
        d = tmp_path / name
        d.mkdir()
        copy = str(d / "result.npz")
        with open(path, "rb") as src, open(copy, "wb") as dst:
            dst.write(src.read())
        outs[name] = (mod.evaluate_result_file(copy, make_plot=False), d)
    (ours, d_ours), (ref, d_ref) = outs["port"], outs["jax"]
    assert ours["mean_error"] == ref["mean_error"]
    for k in ("per_joint_error", "thresholds", "fractions"):
        np.testing.assert_array_equal(ours[k], ref[k])
    for name in ("per_joint_mean_error.txt", "mean_error.txt", "max_error.txt"):
        assert (d_ours / name).read_text() == (d_ref / name).read_text()
    for a, b in zip(offline.load_result_file(path), joffline.load_result_file(path)):
        np.testing.assert_array_equal(a, b)


def test_step_timer_syncs_at_window_edges_and_trace_steps_writes_a_trace(tmp_path,
                                                                          monkeypatch):
    from spherehand_torch.utils import profiling

    syncs = []
    monkeypatch.setattr(profiling, "_sync", syncs.append)
    timer = profiling.StepTimer(window=3)
    assert [timer.tick(i) for i in range(7)] == [False, False, False, True, False, False, True]
    assert syncs == [0, 3, 6] and timer.steps_per_sec > 0
    timer.tick(7)
    assert timer.finish(7) > 0 and syncs == [0, 3, 6, 7]  # a partial window closes
    assert profiling.StepTimer().finish() == 0.0
    with profiling.trace_steps(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_engine_refuses_to_fall_back_to_cpu(data_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(_cfg(tmp_path, data_dir))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_estimator(os.path.join(tmp_path, "missing.pt"))


RANK_CHILD = r"""
import dataclasses, json, os, sys
import torch
torch.set_num_threads(1)
from spherehand_torch.parallel.mesh import form_group, leave_group
from spherehand_torch.train import cli
from spherehand_torch.train.config import EngineConfig

rank, init, fields, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
cfg = EngineConfig(**json.loads(fields))
group = form_group(rank, 2, "cpu", init, timeout_s=60)
try:
    engine = cli.run(cfg, torch.device("cpu"), group)
    torch.save(engine.state.network.state_dict(), os.path.join(out, f"params{rank}.pt"))
    ckpt = os.path.join(engine.model_path, "model_0.pt")
    cli.run(dataclasses.replace(cfg, mode="Test", initial_model=ckpt), torch.device("cpu"), group)
finally:
    leave_group()
"""


def test_engine_over_two_gloo_ranks_equals_one(tmp_path, data_dir):
    """The engine as 2 gloo ranks (spawned, the CLI's ``run`` with a
    file-rendezvous group) on the fake shards: one combined epoch of 2
    steps at real batch 1 (rank 1's rows are all padding) and synthetic
    batch 2, then eval of its checkpoint at eval batch 3 (padded to 4).
    Both ranks end with the same parameters bit for bit; rank 0 alone
    writes the one run directory, its records and checkpoints; the first
    step's logged loss equals one device's within 1e-6 relative (later
    steps drift apart through Adam's sign-like first updates); the eval's
    ``result.npz`` holds the eval plan's rows and equals one device's eval
    of the same checkpoint within 1e-4 mm; under ``--temporal`` a group
    whose rank count does not divide every batch is refused."""
    import dataclasses
    import subprocess
    import sys

    from spherehand_torch.parallel.mesh import RankGroup

    fields = dict(mode="Train", dataset_dir=data_dir, epoch=1, real_batch=1, synt_batch=2,
                  eval_batch=3, synt_iters_per_epoch=1, mesh="lite", device_data="off",
                  eval_precision="highest", tag="dp_")
    runs = {}
    for name in ("one", "two"):
        (tmp_path / name).mkdir()
        runs[name] = dict(fields, model_dir=str(tmp_path / name))
    init = "file://" + str(tmp_path / "rendezvous")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CHILD, str(r), init,
                               json.dumps(runs["two"]), str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: oneDNN rounds by thread count
    try:
        one = Engine(EngineConfig(**runs["one"]), device="cpu")
        one.train()
        logs = [p.communicate(timeout=240)[0] for p in procs]
        assert [p.returncode for p in procs] == [0, 0], [log[-3000:] for log in logs]
        run_dirs = sorted(os.listdir(tmp_path / "two"))
        assert len(run_dirs) == 2  # the training run and the eval run, each named by rank 0
        train_dir, eval_dir = (
            sorted(run_dirs, key=lambda d: not os.path.exists(tmp_path / "two" / d / "model_0.pt")))
        ev = Engine(EngineConfig(**{**runs["one"], "mode": "Test", "initial_model": str(
            tmp_path / "two" / train_dir / "model_0.pt")}), device="cpu")
        ev.eval()
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    params = [torch.load(tmp_path / f"params{r}.pt", weights_only=True) for r in range(2)]
    assert all(torch.equal(v, params[1][k]) for k, v in params[0].items())
    assert one.state.step == 2
    names = set(os.listdir(tmp_path / "two" / train_dir))
    assert {"model_0.pt", "model_-1.pt", "log.txt", "metrics.jsonl", "config.json"} <= names
    with open(tmp_path / "two" / train_dir / "log.txt") as f:
        assert "data-parallel over 2 ranks (gloo)" in f.read()
    with open(tmp_path / "two" / train_dir / "metrics.jsonl") as f:
        (record,) = [json.loads(line) for line in f]  # rank 0 alone writes
    (ref,) = _records(one)
    assert record["it"] == ref["it"] == 0
    assert abs(record["loss"] - ref["loss"]) <= 1e-6 * abs(ref["loss"])
    with np.load(tmp_path / "two" / eval_dir / "result.npz") as f, \
            np.load(os.path.join(ev.model_path, "result.npz")) as g:
        assert f["est"].shape == g["est"].shape == (3, 41, 3)
        np.testing.assert_array_equal(f["gt"], g["gt"])
        np.testing.assert_allclose(f["est"], g["est"], atol=1e-4)

    temporal = EngineConfig(**dict(runs["one"], temporal=True, real_batch=3))
    with pytest.raises(ValueError, match="temporal over 2 ranks"):
        Engine(temporal, group=RankGroup(0, 2, torch.device("cpu"), "gloo"))
    with pytest.raises(ValueError, match="temporal over 2 ranks"):
        Engine(dataclasses.replace(temporal, real_batch=2), group=RankGroup(
            0, 2, torch.device("cpu"), "gloo"))  # eval batch 3
