"""The port's evidence path (``spherehand_torch.tools``, the reference-layout
weights of ``convert`` and the shifted sensor of ``data.pseudo_real``) on
the CPU, against the JAX package's tools where they can run here: the
reference ``.pth`` import and the parity drill on the same files, the
sensor's deterministic core on the same draws; and each entry point once
at a tiny size; and the first steps of the self-supervised loop against
JAX's own jitted step."""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_tpu.data.noise import _rowwise_uniform  # noqa: E402
from spherehand_tpu.data.nyu import NyuDataset as JNyuDataset  # noqa: E402
from spherehand_tpu.data.sampler import sample_poses as jsample_poses  # noqa: E402
from spherehand_tpu.data.synthesizer import synthesize as jsynthesize  # noqa: E402
from spherehand_tpu.train.config import EngineConfig as JEngineConfig  # noqa: E402
from spherehand_tpu.train.steps import RealBatch as JRealBatch  # noqa: E402
from spherehand_tpu.train.steps import TrainState as JTrainState  # noqa: E402
from spherehand_tpu.train.steps import build_steps as jbuild_steps  # noqa: E402
from spherehand_tpu.train.steps import make_optimizer as jmake_optimizer  # noqa: E402
from spherehand_torch import convert  # noqa: E402
from spherehand_torch.data import pseudo_real  # noqa: E402
from spherehand_torch.data.noise import ResizeDraws  # noqa: E402
from spherehand_torch.data.nyu import NyuDataset  # noqa: E402
from spherehand_torch.data.synthesizer import SyntheticBatch  # noqa: E402
from spherehand_torch.hand.assets import load_hand_model  # noqa: E402
from spherehand_torch.infer import load_estimator, load_params_npz  # noqa: E402
from spherehand_torch.models.hourglass import HourglassNet  # noqa: E402
from spherehand_torch.train.config import EngineConfig  # noqa: E402
from spherehand_torch.train.steps import RealBatch, StepDraws, build_steps  # noqa: E402
from spherehand_torch.tools import (  # noqa: E402
    eval_synthetic,
    import_torch_checkpoint,
    lite_mesh_e2e,
    parity_eval,
    pole_study,
    selfsup_demo,
    train_synthetic_full,
)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
META = {"x", "out0", "out1", "latent0", "latent1"}  # hourglass.npz's non-weights
SELFSUP_GOLDEN = os.path.join(ROOT, "tests", "goldens", "selfsup_demo.json")
TINY_ENGINE = dict(real_batch=4, synt_batch=2, eval_batch=2)
PRETRAINED = os.path.join(ROOT, "assets", "pretrained", "synthetic_params.npz")
POLE_MM = -1.0e6


def _reference_state(goldens) -> dict:
    g = goldens("hourglass")
    return {k: np.asarray(g[k]) for k in g.files if k not in META}


def _write_pth(path, state: dict, wrapped: bool) -> str:
    """A reference state as a ``.pth``: in a {"state_dict"} envelope with
    DataParallel's ``module.`` prefixes, or bare."""
    prefix = "module." if wrapped else ""
    tensors = {prefix + k.replace("/", "."): torch.from_numpy(v) for k, v in state.items()}
    torch.save({"state_dict": tensors} if wrapped else tensors, str(path))
    return str(path)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (the suite's workers share the
    cores, and many threads each oversubscribe them); restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pseudo_nyu(tmp_path_factory):
    """8 train + 4 test shifted-sensor hands written by the port, as the
    selfsup demo lays them out; the self-check gaps."""
    out = tmp_path_factory.mktemp("selfsup")
    gaps = [pseudo_real.generate_pseudo_nyu(str(out / "data" / split), n, seed, "cpu")
            for split, n, seed in (("train", 8, 0), ("test", 4, selfsup_demo.TEST_SEED_OFFSET))]
    return str(out), gaps


@pytest.fixture(scope="module")
def synthetic_run(tmp_path_factory):
    run = train_synthetic_full.train_synthetic(3, batch=2, device="cpu")
    return run, train_synthetic_full.save_run(str(tmp_path_factory.mktemp("synthetic")), run)


def test_reference_layout_loader_matches_golden(goldens):
    """The reference state dict of hourglass.npz (num_stacks=2) through
    reference_hourglass_state reproduces the golden scores (the JAX test's
    atol=2e-3, rtol=1e-3); the inverse gives the reference arrays back bit
    for bit; a missing or extra entry raises."""
    g = goldens("hourglass")
    state = _reference_state(goldens)
    network = HourglassNet(num_stacks=2)
    network.load_state_dict(convert.reference_hourglass_state(state, num_stacks=2))
    with torch.no_grad():
        scores, latents = network(torch.from_numpy(np.asarray(g["x"])))
    for s in range(2):
        np.testing.assert_allclose(scores[s].numpy(), g[f"out{s}"], atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(latents[0].numpy(), g["latent0"], atol=2e-3, rtol=1e-3)

    back = convert.reference_state_from_hourglass(network)
    assert set(back) == {k.replace("/", ".") for k in state}
    for k, v in state.items():
        got = back[k.replace("/", ".")].numpy()
        assert got.dtype == v.dtype and np.array_equal(got, v), k
    with pytest.raises(ValueError, match="missing"):
        convert.reference_hourglass_state({k: v for k, v in state.items() if k != "bn1/bias"}, 2)
    with pytest.raises(ValueError, match="unused"):
        convert.reference_hourglass_state(state, num_stacks=1)


@pytest.fixture(scope="module")
def jax_import(goldens, tmp_path_factory):
    """The golden reference state as a wrapped .pth, through the JAX tool."""
    from import_torch_checkpoint import import_checkpoint

    d = tmp_path_factory.mktemp("import")
    pth = _write_pth(d / "released.pth", _reference_state(goldens), wrapped=True)
    import_checkpoint(pth, str(d / "jax.npz"), num_stacks=2)
    return str(d / "jax.npz")


@pytest.mark.parametrize("wrapped", [True, False], ids=["state_dict+module", "bare"])
def test_import_equals_the_jax_tool(goldens, jax_import, tmp_path, wrapped):
    """The golden's .pth, in a {"state_dict"} envelope with module. prefixes
    or bare, through the port's import against the JAX tool's import of the
    wrapped one: equal keys, and every array equal bit for bit (dtype and
    shape too)."""
    pth = _write_pth(tmp_path / "released.pth", _reference_state(goldens), wrapped)
    import_torch_checkpoint.import_checkpoint(pth, str(tmp_path / "port.npz"), num_stacks=2)
    with np.load(jax_import) as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 252
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k
    if wrapped:  # the command line once
        import_torch_checkpoint.main([pth, str(tmp_path / "cli.npz"), "--num_stacks", "2"])
        assert os.path.exists(tmp_path / "cli.npz")


def test_parity_drill_equals_the_jax_drill(goldens, tmp_path):
    """The port's parity_eval and tools/parity_eval.run_parity_eval on the
    same fake shards (6 samples, batch 3) and .pth: the same sample count,
    both errors within 1e-3 mm, the same output files."""
    from parity_eval import run_parity_eval as jax_drill
    from test_nyu_data import _write_fake_shards

    shards = _write_fake_shards(tmp_path / "nyu", num_samples=6, shard_size=3)
    pth = _write_pth(tmp_path / "released.pth", _reference_state(goldens), wrapped=True)
    ref = jax_drill(pth, shards, num_stacks=2, out_dir=str(tmp_path / "jax"), batch_size=3)
    out_dir = str(tmp_path / "port")
    got = parity_eval.run_parity_eval(pth, shards, num_stacks=2, out_dir=out_dir, batch_size=3,
                                      device="cpu")
    assert got["num_samples"] == ref["num_samples"] == 6
    for key in ("avg_joint_error_mm", "offline_mean_error_mm"):
        assert abs(got[key] - ref[key]) <= 1e-3, (key, got, ref)
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert os.path.exists(os.path.join(out_dir, name)), name
    with open(os.path.join(out_dir, "parity.json")) as f:
        assert json.load(f) == got


def test_sensor_core_equals_jax_bit_for_bit():
    """corrupt() fed the draws jax.random.split(key, 4) gives inside the JAX
    tool's _corrupt equals _corrupt op by op (jax.disable_jit: no FMA
    contraction), bit for bit; the constants are the tool's."""
    import selfsup_demo as jax_demo

    for name in ("SHIFT_PIXEL_SIGMA", "Z_SIGMA", "DROPOUT", "BLUR_KERNEL"):
        assert getattr(pseudo_real, name) == getattr(jax_demo, name), name
    rng = np.random.RandomState(3)
    dms = np.ones((1, 64, 64), np.float32)
    dms[:, 18:46, 12:50] = rng.uniform(0.3, 0.95, (1, 28, 38))
    key = jax.random.key(5)
    with jax.disable_jit():
        want = np.asarray(jax_demo._corrupt(key, jnp.asarray(dms)))
        kx, ky, kz, kd = jax.random.split(key, 4)
        draws = pseudo_real.SensorDraws(
            *(torch.tensor(np.asarray(jax.random.normal(k, dms.shape))) for k in (kx, ky, kz)),
            torch.tensor(np.asarray(jax.random.uniform(kd, dms.shape))))
    got = pseudo_real.corrupt(torch.from_numpy(dms), draws).numpy()
    assert np.array_equal(got, want)
    assert 0.05 < (got != dms).mean() < 0.9  # the sensor moved pixels


def test_sensor_draws_by_distribution():
    """Three standard normal planes and a U[0, 1) plane; about DROPOUT of
    the pixels fall to holes (tolerances: 6 standard errors at 2^18 draws)."""
    shape = (16, 128, 128)
    draws = pseudo_real.sensor_draws(torch.Generator().manual_seed(0), shape)
    n = float(np.prod(shape))
    for plane in draws[:3]:
        assert plane.shape == shape
        assert abs(float(plane.mean())) < 6 / n ** 0.5
        assert abs(float(plane.std()) - 1.0) < 6 / (2 * n) ** 0.5
    u = draws.dropout
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    share = float((u <= pseudo_real.DROPOUT).float().mean())
    assert abs(share - pseudo_real.DROPOUT) < 6 * (0.12 * 0.88 / n) ** 0.5


def test_pseudo_nyu_writer_and_self_check(pseudo_nyu):
    """8 + 4 hands on the CPU (the exact rule): the self-check under
    0.5 mm, the shards read by both packages' NyuDataset with equal arrays,
    foreground depth with holes, the joints in the NYU rows."""
    out, gaps = pseudo_nyu
    assert max(gaps) < pseudo_real.SELF_CHECK_MM
    for split, n in (("train", 8), ("test", 4)):
        d = os.path.join(out, "data", split)
        idx = np.arange(n)
        ours, theirs = NyuDataset(d).gather(idx), JNyuDataset(d).gather(idx)
        for a, b in zip(ours, theirs):
            assert np.array_equal(a, b)
        dms, joints = ours[0], ours[1]
        assert dms.shape == (n, 3, 64, 64) and joints.shape == (n, 3, 36, 3)
        assert (dms < 100.0).mean() > 0.05 and (dms == 100.0).mean() > 0.5
        assert np.abs(joints).max() > 1.0


def test_pole_study_lists_and_drops_the_lowest_samples(pseudo_nyu, tmp_path):
    """pole_study's helpers on the 8 train hands: each sample's lowest depth
    over its views, and the split rewritten without the k lowest, the rest
    in order and bit for bit."""
    out, _ = pseudo_nyu
    train = os.path.join(out, "data", "train")
    dms, joints, poses, _ = NyuDataset(train).gather(np.arange(8))
    low = pole_study.lowest_depths(train)
    np.testing.assert_array_equal(low, dms.reshape(8, -1).min(axis=1))
    dropped = pole_study.drop_lowest(train, str(tmp_path / "kept"), 2)
    assert list(dropped) == list(np.argsort(low, kind="stable")[:2])
    kept = np.setdiff1d(np.arange(8), dropped)
    got = NyuDataset(str(tmp_path / "kept")).gather(np.arange(6))
    for a, b in zip(got[:3], (dms[kept], joints[kept], poses[kept])):
        assert np.array_equal(a, b)


def _jax_step_draws(hand_model, synt_batch: int, rows: int):
    """A function of a step key giving the draws JAX's combined_step takes
    from it (split 5: poses, synthesis, resample, resize-crop, prior
    noise) as the port's inputs: the synthetic batch and StepDraws."""
    @jax.jit
    def draw(key):
        k_pose, k_synt, _, k_aug, k_prior = jax.random.split(key, 5)
        synt = jsynthesize(hand_model, k_synt, jsample_poses(k_pose, synt_batch))
        k_coin, k_base, k_u, k_v = jax.random.split(k_aug, 4)
        resize = [jax.random.uniform(k_coin, ())] + [
            _rowwise_uniform(k, (rows, 1))[:, 0] for k in (k_base, k_u, k_v)]
        row_keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.split(k_prior, 1)[0],
                                                           jnp.arange(rows))
        noise = jax.vmap(lambda k: jax.random.normal(k, (32,), jnp.float32))(row_keys)
        return tuple(synt), resize, noise

    def port_inputs(key):
        t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
        synt, resize, noise = draw(key)
        return (SyntheticBatch(*(t(a) for a in synt)),
                StepDraws(None, None, ResizeDraws(*(t(a) for a in resize)), (t(noise),)))

    return port_inputs


def test_first_combined_steps_with_adam_follow_jax(pseudo_nyu, hand_model):
    """The selfsup demo's loop, four steps from the shipped weights at its
    learning rate 3e-5 on the port's 8 train hands (2 a step, one synthetic
    hand), with a -1e6 mm pole pixel planted in the first batch (the
    rasterizers' 1/z rule gives such pixels where a face straddles z = 0):
    JAX's own jitted combined_step (its optax Adam) against the port's
    objective and torch Adam on the same draws. Tolerances: the first
    step's terms within 5e-3 relative (collision's pairs sit on its clamp
    edge) and the pole-dominated mutual projection within 1e-4; every
    step's loss within 5e-3 relative; after the last step the parameters'
    moves from the start within 1e-2 in norm and at a cosine above 0.98
    (Adam's first step is sign-like, so float-level gradient gaps flip
    elements whose gradient is near zero: measured 0.977 after one step,
    0.990 after four)."""
    steps_n, real, lr = 4, 2, 3e-5
    train = os.path.join(pseudo_nyu[0], "data", "train")
    dms, joints, poses, inv = NyuDataset(train).gather(np.arange(steps_n * real))
    fg = np.argwhere(dms[0, 1] < 99.0)
    row, col = fg[np.argmin(((fg - 31.5) ** 2).sum(axis=1))]
    dms[0, 1, row, col] = POLE_MM
    params = load_params_npz(PRETRAINED)

    jcfg = JEngineConfig(synt_batch=1, real_batch=real, lr=lr)
    jfns = jbuild_steps(jcfg, hand_model)
    jparams = jax.tree.map(jnp.asarray, params)  # init_state's fields, the shipped weights
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                         opt_state=jmake_optimizer(jcfg.weight_decay).init(jparams),
                         prev_skel=jnp.zeros((3, 41, 3)), has_prev=jnp.zeros((), bool))
    jstep = jax.jit(jfns.combined_step)
    port_inputs = _jax_step_draws(hand_model, 1, real * 3)
    steps = build_steps(EngineConfig(synt_batch=1, real_batch=real, lr=lr),
                        load_hand_model(device="cpu"))
    state = convert.train_state_from_params(steps.init_state, params)
    start = convert.flatten_params(params)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731

    for k in range(steps_n):
        batch = [a[k * real:(k + 1) * real] for a in (dms, joints, poses, inv)]
        key = jax.random.fold_in(jax.random.key(1), k)
        jstate, ref, _ = jstep(jstate, key, jnp.asarray(lr),
                               JRealBatch(*(jnp.asarray(a) for a in batch)), jnp.asarray(True))
        synt, draws = port_inputs(key)
        loss, terms, _ = steps.combined_grads(state, draws, RealBatch(*(t(a) for a in batch)),
                                              True, real_aug=True, synt=synt)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        ref_loss = float(ref["loss"])
        assert abs(float(loss) - ref_loss) <= 5e-3 * ref_loss, (k, float(loss), ref_loss)
        if k == 0:
            assert float(ref["mv_projection"]) > 1e8  # the pole dominates the objective
            for name, value in terms.items():
                want = float(ref[name])
                tol = 1e-4 if name == "mv_projection" else 5e-3
                assert abs(float(value) - want) <= tol * max(abs(want), 1e-6), (name, want)

    ours = convert.flax_arrays({n: p.detach() for n, p in state.network.named_parameters()})
    theirs = convert.flatten_params(jax.tree.map(np.asarray, jstate.params))
    assert ours.keys() == theirs.keys() == start.keys()
    a = np.concatenate([(theirs[n] - start[n]).ravel() for n in sorted(start)]).astype(np.float64)
    b = np.concatenate([(ours[n] - start[n]).ravel() for n in sorted(start)]).astype(np.float64)
    assert abs(np.linalg.norm(b) - np.linalg.norm(a)) <= 1e-2 * np.linalg.norm(a)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.98


def test_train_synthetic_full_tiny(synthetic_run):
    """3 steps at batch 2: the StepLR thirds equal the JAX tool's jnp.select
    on tier 3 i // N (float32), the history and files, the checkpoint
    served by load_estimator and the flat params equal to the network."""
    run, paths = synthetic_run
    for n in (3, 7, 200):
        tier = (3 * jnp.arange(n)) // n
        want = jnp.select([tier == 0, tier == 1], [jnp.float32(1e-3), jnp.float32(1e-4)],
                          jnp.float32(1e-5))
        got = np.float32([train_synthetic_full.learning_rate(i, n) for i in range(n)])
        assert np.array_equal(got, np.asarray(want)), n
    assert [r["step"] for r in run.history] == [0, 2]
    assert [r["lr"] for r in run.history] == [1e-3, 1e-5]
    assert run.losses.shape == run.errors.shape == (3,) and np.isfinite(run.losses).all()
    with open(paths["history.json"]) as f:
        assert json.load(f) == run.history
    served = load_estimator(paths["model_final.pt"], device="cpu")
    flat = convert.flatten_params(load_params_npz(paths["synthetic_params.npz"]))
    assert flat.keys() == convert.flax_arrays(dict(run.state.network.named_parameters())).keys()
    for name, p in served.network.state_dict().items():
        assert torch.equal(p, run.state.network.state_dict()[name]), name


def test_train_synthetic_seed_moves_the_run(synthetic_run):
    """seed 0 is the default run (its first step's loss bit for bit); seed 1
    starts from another network on other draws."""
    run, _ = synthetic_run
    again = train_synthetic_full.train_synthetic(1, batch=2, device="cpu", seed=0)
    other = train_synthetic_full.train_synthetic(1, batch=2, device="cpu", seed=1)
    assert again.losses[0] == run.losses[0]
    assert other.losses[0] != run.losses[0]

def test_eval_synthetic_tiny(synthetic_run):
    """4 held-out hands: the .pt and the flat .npz of the same network give
    the same errors; the JAX tool's output keys; a max-error curve that
    rises."""
    _, paths = synthetic_run
    by_pt = eval_synthetic.evaluate(paths["model_final.pt"], 4, 4, "cpu")
    by_npz = eval_synthetic.evaluate(paths["synthetic_params.npz"], 4, 4, "cpu")
    assert by_pt["errors"].shape == (4, 41) and np.isfinite(by_pt["errors"]).all()
    np.testing.assert_array_equal(by_pt["errors"], by_npz["errors"])
    with np.load(by_pt["path"]) as f:
        assert sorted(f.files) == ["errors", "fractions", "thresholds"]
    assert np.all(np.diff(by_pt["fractions"]) >= 0)


def test_lite_mesh_e2e_tiny_and_its_guard(tmp_path):
    """2 steps an arm at batch 2, 2 held-out hands; the JAX tool's keys;
    no run, short or at the golden's 50,000 steps and beyond, writes the
    JAX record."""
    art = tmp_path / "lite.json"
    result = lite_mesh_e2e.run_arms(["lite", "full"], 2, str(art), batch=2, eval_samples=2,
                                    eval_batch=2, device="cpu")
    with open(art) as f:
        assert json.load(f) == result
    assert result["steps"] == 2
    for arm in ("lite", "full"):
        assert set(result[arm]) == {"train_secs", "heldout_mm"}
        assert np.isfinite(result[arm]["heldout_mm"])
    for steps in (10, 50_000, 75_000):
        with pytest.raises(ValueError, match="golden"):
            lite_mesh_e2e.run_arms(["lite"], steps, lite_mesh_e2e.GOLDEN, device="cpu")
        with pytest.raises(SystemExit, match="golden"):
            lite_mesh_e2e.main(["--steps", str(steps), "--artifact", lite_mesh_e2e.GOLDEN])


def test_lite_mesh_e2e_merge_joins_arms_of_separate_runs(tmp_path):
    """Arms trained in separate runs join into one artifact: the arms side
    by side, launches summed; runs of another length or seed, or an arm
    twice, are refused, and so is a JAX record."""
    parts = [str(tmp_path / f"{arm}.json") for arm in ("lite", "full")]
    runs = [lite_mesh_e2e.run_arms([arm], 2, path, batch=2, eval_samples=2, eval_batch=2,
                                   device="cpu") for arm, path in zip(("lite", "full"), parts)]
    assert all(set(r) == {"steps", "seed", "backend", "launches", arm}
               for r, arm in zip(runs, ("lite", "full")))
    merged = lite_mesh_e2e.merge(parts, str(tmp_path / "both.json"))
    assert merged == {"steps": 2, "seed": 0, "backend": "cpu", "launches": {},
                      "lite": runs[0]["lite"], "full": runs[1]["full"]}
    lite_mesh_e2e.run_arms(["lite"], 3, str(tmp_path / "long.json"), batch=2, eval_samples=2,
                           eval_batch=2, device="cpu")
    with pytest.raises(ValueError, match="steps differs"):
        lite_mesh_e2e.merge([parts[0], str(tmp_path / "long.json")], str(tmp_path / "x.json"))
    with pytest.raises(ValueError, match="twice"):
        lite_mesh_e2e.merge([parts[0], parts[0]], str(tmp_path / "x.json"))
    with pytest.raises(ValueError, match="golden"):
        lite_mesh_e2e.merge(parts, lite_mesh_e2e.GOLDEN)


def test_selfsup_demo_tiny(pseudo_nyu, tmp_path):
    """One combined epoch from the shipped weights on the 8 + 4 shards at a
    small EngineConfig (batches 4 real, 2 synthetic, 2 eval): the result
    has the JAX artifact's keys (and its seed and parameter hash), two
    steps, finite errors; the default artifact goes under --out."""
    out, _ = pseudo_nyu
    art = str(tmp_path / "result.json")
    result = selfsup_demo.run(out=out, samples=8, test=4, epochs=1, device="cpu", artifact=art,
                              engine_overrides=TINY_ENGINE)
    with open(SELFSUP_GOLDEN) as f:  # the JAX artifact's keys, and the run's seed and hash
        assert set(result) == set(json.load(f)) | {"seed", "params_sha256"}
    with open(art) as f:
        assert json.load(f) == result
    assert result["steps"] == 8 // TINY_ENGINE["real_batch"] and result["backend"] == "cpu"
    assert np.isfinite([result[k] for k in ("before_mm", "after_mm", "before_raw_mm",
                                            "after_raw_mm")]).all()


def test_entry_points_refuse_to_fall_back_to_cpu(tmp_path):
    """Without a GPU, each new entry point raises unless told device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    calls = [
        lambda: train_synthetic_full.train_synthetic(1, batch=1),
        lambda: eval_synthetic.evaluate(os.path.join(ROOT, "assets", "pretrained",
                                                     "synthetic_params.npz"), 1, 1),
        lambda: lite_mesh_e2e.run_arms(["full"], 1, str(tmp_path / "l.json"), batch=1),
        lambda: pseudo_real.generate_pseudo_nyu(str(tmp_path / "p"), 1, 0),
        lambda: parity_eval.run_parity_eval("x.npz", str(tmp_path), 1, str(tmp_path / "q")),
        lambda: selfsup_demo.run(out=str(tmp_path / "s"), samples=1, test=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
