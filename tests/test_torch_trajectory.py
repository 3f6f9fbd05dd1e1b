"""The port's self-supervised loop against the JAX package's, past the four
steps of ``test_torch_evidence.py``: what each engine feeds its step, and
how far the two trajectories part.

Both engines run the selfsup demo's combined loop (the shipped weights, lr
3e-5, temporal off, evals in float32 with TF32 off) over the same pseudo-NYU
shards, written by the port and read by each package's ``NyuDataset``, at
batch 2 real x 3 views and 1 synthetic hand, one torch thread. ``epoch`` is
3, so ``lr_at_epoch`` steps down once, after the first of the two epochs
run, and the ``is_mv`` window ends inside each epoch.

(a) **The schedule, exact.** Every combined step of both engines gets the
    same sample indices and batch (bit for bit), ``is_mv``, learning rate
    (as float32), real-augmentation flag and temporal state; the index
    plans agree with ``temporal`` on as well (no shuffle). Each engine's
    ``eval()`` on the shipped weights agrees within 1e-3 mm.
(b) **The trajectory, on the same draws.** JAX's engine loop runs its own
    keys, ``fold_in(fold_in(key(seed), epoch), it)``; the port's engine
    loop gets the draws JAX takes from each key (``_jax_step_draws`` of
    ``test_torch_evidence.py``: the synthetic batch, the resize-crop
    draws, the prior noise) through ``Engine.step_draws``. Each step
    records the loss, each term, and the relative distance between the
    two packages' parameter moves from the start, |d_port - d_jax| /
    |d_jax|. That free distance is a record, not a test: the loop
    amplifies rounding, so two runs with other rounding part by 0.6-0.76
    from step 25 on, where moves unrelated to JAX's would read about 1.4.

    So each step is also taken *teacher-forced*: the port's step n starts
    from JAX's state after step n - 1 (its weights, Adam moments and
    count) and takes the port loop's inputs of step n (the draws, batch,
    ``is_mv`` and lr, equal to JAX's by (a)). At every step:

    - *the objective*: its loss and terms, the port's objective on JAX's
      weights, within the first-step tolerances of
      ``test_torch_evidence.py`` of JAX's (5e-3 relative; 1e-4 for a
      pole-dominated mutual projection above 1e8);
    - *the update path*: its new weights equal those that optax's Adam
      (``make_optimizer``, JAX's moments and count, the lr) gives from
      the port's own gradient of that step, each within two float32 ulps
      of the weight plus 1e-4 of its update (and 1e-5 of the update's
      RMS).

    A fault in the objective, the augmentation or the draws shows in the
    terms; one in Adam, the weight decay, the count or the lr in the
    update path, at whatever step it acts. What is left, the gradient,
    is held at fixed inputs by ``test_torch_train.py`` and
    ``test_torch_term_diag.py``; here its effect is the teacher-forced
    update distance |u_port - u_jax| / |u_jax| against JAX's own update.

    *Control*: JAX's step jitted against the
    same step under ``jax.disable_jit()`` (the same semantics; XLA fuses
    and contracts into FMAs, ROADMAP "Traps"), teacher-forced from the
    same state: its distance |u_eager - u_jax| / |u_jax| and its terms'
    gaps from the jitted step's. Op-by-op JAX compiles each op on its
    first step, too slow for the tier-1 case, so the control runs in the
    ``slow`` case only, at every step.

    *Departure*: a step where the update path leaves its tolerance; or a
    term leaves its tolerance and, where the control ran, its gap is over
    10x JAX's own gap in that term; or, where the control ran, the
    teacher-forced distance is over 10x JAX's own. The tier-1 case holds
    the terms and the update path at every step and records the
    distance. The cheaper controls tried first, the port with oneDNN off
    and the port on weights moved one ulp, touch less of the rounding that
    the mutual projection's ill-conditioned gradient and Adam's sign-like
    early steps amplify, and mostly read far under JAX's (PERF.md); the
    ``slow`` case prints the one-ulp control beside JAX's at the steps it
    prints.

The tier-1 case runs 6 steps (3 an epoch, ``is_mv`` for the first 2 of
each); the ``slow`` case runs 600 (300 an epoch, ``is_mv`` for the first
150 of each, the lr step between the epochs) and prints its curve every 25
steps.
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import spherehand_torch.train.steps as port_steps  # noqa: E402
import spherehand_tpu.train.engine as jax_engine  # noqa: E402
import spherehand_tpu.train.steps as jax_steps  # noqa: E402
from spherehand_torch import convert  # noqa: E402
from spherehand_torch.data import pseudo_real  # noqa: E402
from spherehand_torch.infer import load_params_npz  # noqa: E402
from spherehand_torch.tools.selfsup_demo import PRETRAINED, TEST_SEED_OFFSET  # noqa: E402
from spherehand_torch.train.config import EngineConfig  # noqa: E402
from spherehand_torch.train.engine import Engine  # noqa: E402
from spherehand_tpu.data.nyu import NyuDataset as JNyuDataset  # noqa: E402
from spherehand_tpu.train.config import EngineConfig as JEngineConfig  # noqa: E402
from spherehand_tpu.train.engine import Engine as JEngine  # noqa: E402
from spherehand_tpu.train.steps import RealBatch as JRealBatch  # noqa: E402
from spherehand_tpu.train.steps import TrainState as JTrainState  # noqa: E402
from spherehand_tpu.train.steps import make_optimizer as jmake_optimizer  # noqa: E402
from test_torch_evidence import _jax_step_draws  # noqa: E402

REAL, SYNT, LR, EPOCHS_RUN = 2, 1, 3e-5, 2
TERM_RTOL, POLE_RTOL, POLE_MM2 = 5e-3, 1e-4, 1e8  # test_torch_evidence.py:281-288
CONTROL_FACTOR = 10.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(cls, data_dir: str, model_dir: str, mv_iters: int, **extra):
    return cls(mode="Train", model_dir=model_dir, dataset_dir=data_dir, epoch=3, num_stacks=1,
               lr=LR, real_batch=REAL, synt_batch=SYNT, eval_batch=2,
               mv_curriculum_iters=mv_iters, eval_precision="highest", device_data="on",
               tag="traj_", **extra)


def _flat(arrays: dict) -> np.ndarray:
    return np.concatenate([np.asarray(arrays[k], np.float64).ravel() for k in sorted(arrays)])


def _jax_engine(cfg, monkeypatch):
    """JAX's Engine on one device, its state the shipped weights with a
    fresh optax Adam (as test_torch_evidence builds it; flax's op-by-op
    init of weights replaced at once is skipped)."""
    real_build = jax_engine.build_steps

    def build(*args, **kwargs):
        fns = real_build(*args, **kwargs)

        def init_state(_key):
            params = jax.tree.map(jnp.asarray, load_params_npz(PRETRAINED))
            return JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=jmake_optimizer(cfg.weight_decay).init(params),
                               prev_skel=jnp.zeros((3, 41, 3)), has_prev=jnp.zeros((), bool))
        return fns._replace(init_state=init_state)

    with monkeypatch.context() as m:
        m.setattr(jax_engine, "build_steps", build)
        return JEngine(cfg)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _jax_state(state) -> dict:
    """A numpy copy of JAX's train state before its step (the step donates
    it): weights, Adam moments and count under their flax names, and the
    optimizer state as optax holds it."""
    opt_state = jax.tree.map(lambda x: np.array(x, copy=True), state.opt_state)
    adam = opt_state[1]  # chain(add_decayed_weights, scale_by_adam)
    return {"params": convert.flatten_params(jax.tree.map(lambda x: np.array(x, copy=True),
                                                          state.params)),
            "mu": convert.flatten_params(adam.mu), "nu": convert.flatten_params(adam.nu),
            "count": int(adam.count), "opt_state": opt_state}


def _run_jax(engine, epochs: int, metric_keys, on_step, monkeypatch) -> list[dict]:
    """JAX's combined epochs with a spy on its step (what it is fed, via a
    debug callback) and on its accumulating program (its outputs); after
    step n, ``on_step(n, state before, weights after, metrics)``."""
    fed, out, traced = [], [], []
    real_step, real_forward = engine.steps.combined_step, jax_steps.forward

    def spy_forward(*args, **kwargs):
        traced.append(bool(kwargs.get("train")) and kwargs.get("real_aug", True)
                      and kwargs.get("real_dms") is not None)
        return real_forward(*args, **kwargs)

    def spy_step(state, key, lr, batch, is_mv):
        jax.debug.callback(lambda *a: fed.append([np.array(x) for x in a]), is_mv, lr,
                           state.has_prev, batch.dms, ordered=True)
        return real_step(state, key, lr, batch, is_mv)

    engine.steps = engine.steps._replace(combined_step=spy_step)
    engine._build_acc_steps()
    # Fresh metric sums (each epoch's are donated) placed on the engine's
    # mesh as the step's outputs are, else the second step compiles the
    # program again; given here, they need no eval_shape of the step.
    monkeypatch.setattr(engine, "_metric_zeros", lambda *_a: {
        k: jax.device_put(np.zeros((), np.float32), engine._replicated) for k in metric_keys})
    acc = engine._jit_combined_acc_dev

    def spy_acc(state, base_key, epoch_it, lr, data, idx, w, sums):
        before = _jax_state(state)
        res = acc(state, base_key, epoch_it, lr, data, idx, w, sums)
        new = res[0]
        metrics = {k: float(v) for k, v in jax.device_get(res[1]).items()}
        out.append({"epoch_it": tuple(int(v) for v in epoch_it), "idx": np.array(idx),
                    "metrics": metrics, "has_prev_after": bool(new.has_prev)})
        on_step(len(out), before, convert.flatten_params(jax.device_get(new.params)), metrics)
        return res

    engine._jit_combined_acc_dev = spy_acc
    with monkeypatch.context() as m:
        m.setattr(jax_steps, "forward", spy_forward)
        m.setattr(engine, "_dump_train_images", lambda *_a: None)
        for epoch in range(epochs):
            engine._epoch_combined(epoch)
    jax.effects_barrier()
    assert len(fed) == len(out) and set(traced) == {True}, (len(fed), len(out), traced)
    return [{**o, "is_mv": bool(f[0]), "lr": np.float32(f[1]), "has_prev": bool(f[2]),
             "dms": f[3], "real_aug": traced[0]} for f, o in zip(fed, out)]


def _run_port(engine, epochs: int, draws_of, keep, monkeypatch) -> list[dict]:
    """The port's combined epochs on JAX's draws, with a spy on its step
    (the parameters after step n where ``keep(n)``)."""
    recs, plans = [], []
    real_step, real_plan = engine.steps.combined_step, engine.index_plan
    current = {}

    def spy_plan(train, batch_size, epoch=0):
        plan = real_plan(train, batch_size, epoch)
        plans.extend(plan)
        return plan

    def step_draws(epoch, it, synt=True, real=True, real_rows=None):
        current["epoch_it"] = (epoch, it)
        synt_batch, draws = draws_of(epoch, it)
        return draws._replace(poses=synt_batch)  # handed through synthesize_from_draws

    def spy_forward(network, synt_dms=None, real_dms=None, scales=None):
        current["real_aug"] = scales is not None
        return real_forward(network, synt_dms=synt_dms, real_dms=real_dms, scales=scales)

    def spy_step(state, lr, draws, batch, is_mv):
        rec = {"epoch_it": current["epoch_it"], "lr": np.float32(lr), "lr_given": lr,
               "is_mv": bool(is_mv), "has_prev": bool(state.has_prev),
               "dms": batch.dms.numpy().copy(), "batch": batch}
        state, metrics, vis = real_step(state, lr, draws, batch, is_mv)
        n = len(recs) + 1
        rec.update(metrics={k: float(v) for k, v in metrics.items()},
                   params=_net_params(state.network) if keep(n) else None,
                   has_prev_after=bool(state.has_prev), real_aug=current["real_aug"])
        recs.append(rec)
        return state, metrics, vis

    real_forward = port_steps.forward
    with monkeypatch.context() as m:
        m.setattr(port_steps, "forward", spy_forward)
        m.setattr(engine, "step_draws", step_draws)
        m.setattr(engine, "index_plan", spy_plan)
        m.setattr(engine, "_dump_train_images", lambda *_a: None)
        engine.steps = engine.steps._replace(combined_step=spy_step)
        for epoch in range(epochs):
            engine._epoch_combined(epoch)
    for rec, idx in zip(recs, plans):
        rec["idx"] = idx
    return recs


def _net_params(network) -> dict:
    """A copy of a network's parameters under their flax names."""
    arrays = convert.flax_arrays({n: p.detach() for n, p in network.named_parameters()})
    return {k: np.array(v, copy=True) for k, v in arrays.items()}


def _port_engine(cfg):
    engine = Engine(cfg, device="cpu")
    engine.state = convert.train_state_from_params(engine.steps.init_state,
                                                   load_params_npz(PRETRAINED))
    return engine


def _forced_step(steps, probe, before: dict, rec: dict, synt, draws):
    """The port's step from JAX's state ``before`` (weights, Adam moments
    and count) on the port loop's inputs ``rec`` of that step: its
    metrics, the weights after it and its gradient."""
    convert.load_hourglass(probe.network, _nest(before["params"]))
    mu, nu = (convert.hourglass_state_dict(_nest(before[k])) for k in ("mu", "nu"))
    probe.optimizer.state.clear()
    for name, p in probe.network.named_parameters():
        probe.optimizer.state[p] = {"step": torch.tensor(float(before["count"])),
                                    "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    _, metrics, _ = steps.combined_step(probe, rec["lr_given"], draws._replace(poses=synt),
                                        rec["batch"], rec["is_mv"])
    grads = convert.flax_arrays({n: p.grad for n, p in probe.network.named_parameters()})
    return {k: float(v) for k, v in metrics.items()}, _net_params(probe.network), grads


def _optax_path(weight_decay: float):
    """JAX's update path (steps.py:138-143) as a function of (weights,
    optimizer state, gradient, lr): the weights after it."""
    tx = jmake_optimizer(weight_decay)

    @jax.jit
    def after(params, opt_state, grads, lr):
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, jax.tree.map(lambda u: -lr * u, updates))
    return after


def _update_path_gap(after_port: dict, after_optax: dict, before: dict) -> float:
    """The largest gap of a weight between the two update paths, in units
    of two float32 ulps of the weight, 1e-4 of its update (optax computes
    the bias corrections 1 - beta ** count in float32) and 1e-5 of the
    update's RMS (a weight near 1e-33, whose decay XLA flushes to zero,
    moves in the port alone, by far less)."""
    moves = {k: np.asarray(ref) - before[k] for k, ref in after_optax.items()}
    floor = 1e-5 * np.sqrt(np.mean(np.concatenate([m.ravel() for m in moves.values()])
                                   .astype(np.float64) ** 2))
    return max(float(np.max(np.abs(after_port[k] - np.asarray(ref)) / (
        2 * np.spacing(np.abs(np.asarray(ref))) + 1e-4 * np.abs(moves[k]) + floor)))
        for k, ref in after_optax.items())


def _ulp_moved(params: dict, seed: int) -> dict:
    """Each weight moved one float32 ulp up or down, the direction drawn
    from ``seed``: the same weights to within their rounding."""
    rng = np.random.default_rng(seed)
    return {k: np.nextafter(v, np.where(rng.random(v.shape) < 0.5, -np.inf, np.inf)
                            .astype(np.float32)) for k, v in sorted(params.items())}


def _term_gaps(got: dict, want: dict) -> dict:
    """The gap of the loss and of each term, in units of its tolerance."""
    gaps = {}
    for name, ref in want.items():
        if name != "avg_joint_error":
            tol = POLE_RTOL if name == "mv_projection" and ref > POLE_MM2 else TERM_RTOL
            gaps[name] = abs(got[name] - ref) / (tol * max(abs(ref), 1e-6))
    return gaps


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    """|a - b| / |b|."""
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_eager(real_step, before: dict, rec: dict, key) -> tuple[dict, dict]:
    """JAX's step under ``jax.disable_jit()`` from the state ``before`` on
    the step's inputs: the weights after it and its metrics."""
    t = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    b = rec["batch"]
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=_nest(before["params"]),
                        opt_state=before["opt_state"], prev_skel=jnp.zeros((3, 41, 3)),
                        has_prev=jnp.zeros((), bool))
    with jax.disable_jit():
        new, metrics, _ = real_step(state, key, jnp.float32(rec["lr"]),
                                    JRealBatch(t(b.dms), t(b.gt_joints), t(b.poses),
                                               t(b.inv_poses)),
                                    jnp.asarray(rec["is_mv"]))
    return (convert.flatten_params(jax.device_get(new.params)),
            {k: float(v) for k, v in metrics.items()})


def _trajectories(root, hand_model, monkeypatch, train_n: int, mv_iters: int, keep,
                  control: bool = False) -> dict:
    """Each engine's eval on the shipped weights, then both loops over
    ``EPOCHS_RUN`` epochs of ``train_n`` samples, each JAX step followed by
    the port's teacher-forced step and the update path's check, and with
    ``control`` by JAX's step op by op. The port loop's parameters are
    kept after step n where ``keep(n)``, for the free distance, and there
    the port's step on weights one ulp away runs too. ``curve``: a row a
    step (see the module docstring)."""
    data = os.path.join(root, "data")
    for split, n, seed in (("train", train_n, 0), ("test", 4, TEST_SEED_OFFSET)):
        pseudo_real.generate_pseudo_nyu(os.path.join(data, split), n, seed, "cpu")
    jeng = _jax_engine(_config(JEngineConfig, data, os.path.join(root, "jax"), mv_iters,
                               data_parallel=False), monkeypatch)
    jax_eval = jeng.eval()
    port = _port_engine(_config(EngineConfig, data, os.path.join(root, "port"), mv_iters))
    port_eval = port.eval()

    to_port = _jax_step_draws(hand_model, SYNT, REAL * 3)
    cache = {}

    def draws_of(epoch, it):
        if (epoch, it) not in cache:
            cache[epoch, it] = to_port(jeng._step_key(epoch, it))
        return cache[epoch, it]

    monkeypatch.setattr(port_steps, "synthesize_from_draws", lambda hand, synt, *_a, **_k: synt)
    steps, jax_step = port.steps, jeng.steps.combined_step  # before the loops' spies
    port_recs = _run_port(port, EPOCHS_RUN, draws_of, keep, monkeypatch)
    start = _flat(convert.flatten_params(load_params_npz(PRETRAINED)))
    probe = steps.init_state(torch.Generator().manual_seed(0))
    optax_after = _optax_path(jeng.cfg.weight_decay)
    curve = []

    def on_step(n, before, after, metrics):
        rec = port_recs[n - 1]
        synt_draws = draws_of(*rec["epoch_it"])
        got, moved, grads = _forced_step(steps, probe, before, rec, *synt_draws)
        path = convert.flatten_params(jax.device_get(optax_after(
            _nest(before["params"]), before["opt_state"], _nest(grads), np.float32(rec["lr"]))))
        b, a = _flat(before["params"]), _flat(after)
        gaps = _term_gaps(got, metrics)
        row = {"step": n, "epoch_it": rec["epoch_it"], "is_mv": rec["is_mv"],
               "loss_rel": abs(got["loss"] - metrics["loss"]) / metrics["loss"],
               "update_path": _update_path_gap(moved, path, before["params"]),
               "forced": _rel(_flat(moved) - b, a - b), "free": float("nan"),
               "term_gaps": gaps, "jax_control": float("nan"), "ulp_control": float("nan"),
               "jax_term_gaps": None}
        row["worst_term"] = max(gaps, key=gaps.get)
        row["worst_term_over_tol"] = gaps[row["worst_term"]]
        if rec["params"] is not None:
            row["free"] = _rel(_flat(rec.pop("params")) - start, a - start)
        if control:
            eager, eager_metrics = _jax_eager(jax_step, before, rec,
                                              jeng._step_key(*rec["epoch_it"]))
            row["jax_control"] = _rel(_flat(eager) - b, a - b)
            row["jax_term_gaps"] = _term_gaps(eager_metrics, metrics)
        if control and keep(n):
            _, ulp, _ = _forced_step(steps, probe, {**before, "params": _ulp_moved(
                before["params"], n)}, rec, *synt_draws)
            row["ulp_control"] = _rel(_flat(ulp) - b, _flat(moved) - b)
        curve.append(row)

    jax_recs = _run_jax(jeng, EPOCHS_RUN, port_recs[0]["metrics"], on_step, monkeypatch)
    return {"jax": jax_recs, "port": port_recs, "curve": curve, "jax_eval": jax_eval,
            "port_eval": port_eval, "jax_data": JNyuDataset(os.path.join(data, "train")),
            "iters": train_n // REAL, "mv_iters": mv_iters, "data": data}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, hand_model):
    with pytest.MonkeyPatch.context() as monkeypatch:
        yield _trajectories(str(tmp_path_factory.mktemp("traj")), hand_model, monkeypatch,
                            train_n=6, mv_iters=2, keep=lambda n: True)


def test_schedule_is_the_same_step_for_step(runs):
    """(a) Indices, batch, is_mv, lr (float32), real augmentation and the
    temporal state, equal at every combined step of two epochs."""
    jax_recs, port_recs = runs["jax"], runs["port"]
    iters, mv_iters = runs["iters"], runs["mv_iters"]
    assert len(jax_recs) == len(port_recs) == EPOCHS_RUN * iters
    assert [r["epoch_it"] for r in jax_recs] == [r["epoch_it"] for r in port_recs] == [
        (e, i) for e in range(EPOCHS_RUN) for i in range(iters)]
    lrs = set()
    for j, p in zip(jax_recs, port_recs):
        assert np.array_equal(j["idx"], p["idx"]), (j["epoch_it"], j["idx"], p["idx"])
        assert np.array_equal(j["dms"], p["dms"]), j["epoch_it"]
        for key in ("is_mv", "lr", "real_aug", "has_prev", "has_prev_after"):
            assert j[key] == p[key], (key, j["epoch_it"], j[key], p[key])
        assert j["metrics"].keys() == p["metrics"].keys()
        lrs.add(float(j["lr"]))
    assert [r["is_mv"] for r in jax_recs] == [i < mv_iters for _ in range(EPOCHS_RUN)
                                               for i in range(iters)]
    assert len(lrs) == 2 and max(lrs) == np.float32(LR)  # one StepLR step, between the epochs
    epochs = [np.sort(np.concatenate([r["idx"] for r in jax_recs[e * iters:(e + 1) * iters]]))
              for e in range(EPOCHS_RUN)]
    assert all(np.array_equal(e, np.arange(iters * REAL)) for e in epochs)
    assert not np.array_equal(jax_recs[0]["idx"], jax_recs[iters]["idx"])  # reshuffled


@pytest.mark.parametrize("temporal", [False, True])
def test_index_plans_equal(runs, temporal):
    """(a) The engines' index plans for three epochs, shuffled without
    ``temporal`` and in order with it (engine.py:326-327)."""
    jcfg = _config(JEngineConfig, runs["data"], "-", 0, temporal=temporal)
    stub = types.SimpleNamespace(cfg=jcfg, _split=lambda train: runs["jax_data"])
    port = Engine.__new__(Engine)
    port.cfg, port._data = _config(EngineConfig, runs["data"], "-", 0, temporal=temporal), {}
    for epoch in range(3):
        want = list(JEngine._real_loader(stub, True, REAL, epoch).iter_index_batches())
        got = port.index_plan(True, REAL, epoch)
        assert len(want) == len(got) == runs["iters"]
        for a, b in zip(want, got):
            assert np.array_equal(a, b), (temporal, epoch)
        flat = np.concatenate(got)
        assert np.array_equal(flat, np.arange(len(flat))) == temporal


def test_eval_matches_jax_on_the_same_weights(runs):
    """Each engine's ``eval()`` over the same test shards on the shipped
    weights, TF32 off: the denoised and raw view-0 joint errors within
    1e-3 mm."""
    for key in ("avg_joint_error", "avg_joint_error_raw"):
        assert abs(runs["port_eval"][key] - runs["jax_eval"][key]) <= 1e-3, (
            key, runs["port_eval"][key], runs["jax_eval"][key])


def _departures(curve: list[dict]) -> list[dict]:
    """The steps that depart: the update path out of its tolerance; a term
    out of its tolerance and, where JAX's op-by-op control ran, over 10x
    JAX's own gap in that term; or, where it ran, the teacher-forced
    distance over 10x JAX's own."""
    out = []
    for r in curve:
        own = r["jax_term_gaps"]
        terms = [k for k, g in r["term_gaps"].items()
                 if g > 1.0 and (own is None or g > CONTROL_FACTOR * own[k])]
        far = np.isfinite(r["jax_control"]) and r["forced"] > CONTROL_FACTOR * r["jax_control"]
        if r["update_path"] > 1.0 or terms or far:
            out.append(r)
    return out


def test_no_departure_over_the_first_steps(runs):
    """(b) 6 steps, two epochs, teacher-forced (see the module docstring for
    the checks, the control and the rule); the free and teacher-forced
    distances recorded at each."""
    curve = runs["curve"]
    assert [r["step"] for r in curve] == list(range(1, 2 * runs["iters"] + 1))
    assert np.isfinite([[r["free"], r["forced"]] for r in curve]).all()
    assert not _departures(curve), _departures(curve)[0]


@pytest.mark.slow
@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP Queue 3 item 1 (closed, not a fault of the port): the teacher-forced update departs "
    "from JAX's at step 132 of 600 (86.3x JAX's own jitted-against-op-by-op distance, the same "
    "with the view transforms rounded as XLA's), every term and the update path within "
    "tolerance. There the two networks' joints, 0.00226 mm apart, flip one pixel of sphere 13's "
    "silhouette (sq > 1e-2), which carries the mutual projection's gradient gap (20,573 against "
    "15,071); on the same joints the port's term and gradient are JAX's, and JAX's own step on "
    "the port's joints gives the port's update (tests/test_torch_mv_rounding.py). Step 507 "
    "(Queue 3 item 8, closed, not a fault) is the same kind: epoch 1, iteration 206, outside the "
    "is_mv window, its update 25x JAX's control from JAX's; every term agrees on the same "
    "joints, and the networks' joints, 0.0055 mm apart, flip one pixel of sphere 15's "
    "silhouette in view 1's own camera, which JAX's step on the port's mv joints reproduces "
    "(tests/test_torch_mv_step507.py)"))
def test_no_departure_over_600_steps(tmp_path, hand_model, monkeypatch):
    """(b) 600 steps: 300 an epoch, is_mv for the first 150 of each, the lr
    step between the epochs; JAX's op-by-op control at every step, the free
    distance and the one-ulp control at steps 1-5 and every 25th. Prints
    the curve there and at every step where a term leaves its tolerance."""
    curve = _trajectories(str(tmp_path), hand_model, monkeypatch, train_n=600, mv_iters=150,
                          keep=lambda n: n <= 5 or n % 25 == 0, control=True)["curve"]
    print("step epoch-it is_mv loss_rel worst-term:port/tol:jax-own/tol update_path free "
          "forced jax_control ulp_control")
    for r in curve:
        if r["step"] <= 5 or r["step"] % 25 == 0 or r["worst_term_over_tol"] > 1.0:
            print(f"{r['step']} {r['epoch_it'][0]}-{r['epoch_it'][1]} {int(r['is_mv'])} "
                  f"{r['loss_rel']:.3e} {r['worst_term']}:{r['worst_term_over_tol']:.4f}:"
                  f"{r['jax_term_gaps'][r['worst_term']]:.4f} {r['update_path']:.3f} "
                  f"{r['free']:.4f} {r['forced']:.4e} {r['jax_control']:.4e} "
                  f"{r['ulp_control']:.4e}", flush=True)
    forced = np.array([r["forced"] for r in curve])
    ratio = forced / np.array([r["jax_control"] for r in curve])
    terms = np.array([r["worst_term_over_tol"] for r in curve])
    print(f"over {len(curve)} steps: teacher-forced distance median {np.median(forced):.4e}, "
          f"max {forced.max():.4e} at step {int(forced.argmax()) + 1}; over JAX's control "
          f"median {np.median(ratio):.3f}, max {ratio.max():.3f} at step "
          f"{int(ratio.argmax()) + 1}; a term out of its tolerance at {int((terms > 1.0).sum())}"
          f" steps (worst {terms.max():.4f} at step {int(terms.argmax()) + 1}); worst update "
          f"path {max(r['update_path'] for r in curve):.3f}")
    assert not _departures(curve), _departures(curve)[0]
