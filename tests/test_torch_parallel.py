"""The port's data parallelism (``spherehand_torch.parallel``) on the CPU:
the pad plan against the JAX engine's, two gloo ranks against one device
(``parallel.check``, one spawned pair running every group check), and one
padded device against the JAX package's padded ``combined_grads``."""
import concurrent.futures
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_tpu.data.sampler import sample_poses as jsample_poses  # noqa: E402
from spherehand_tpu.data.synthesizer import synthesize as jsynthesize  # noqa: E402
from spherehand_tpu.train.config import EngineConfig as JEngineConfig  # noqa: E402
from spherehand_tpu.train.engine import Engine as JEngine  # noqa: E402
from spherehand_tpu.train.steps import RealBatch as JRealBatch  # noqa: E402
from spherehand_tpu.train.steps import build_steps as jbuild_steps  # noqa: E402
from spherehand_torch.convert import flax_arrays, train_state_from_params  # noqa: E402
from spherehand_torch.data.synthesizer import SyntheticBatch  # noqa: E402
from spherehand_torch.hand.assets import load_hand_model  # noqa: E402
from spherehand_torch.parallel import check  # noqa: E402
from spherehand_torch.parallel.mesh import pad_batch, pad_idx, rank_rows  # noqa: E402
from spherehand_torch.train.config import EngineConfig  # noqa: E402
from spherehand_torch.train.steps import RealBatch, StepDraws, build_steps  # noqa: E402

# The spawned pair: 2 synthetic rows (one a rank) on the lite mesh keep the
# CPU renders short; the real batch is 3 samples, padded to 4.
PAIR_SYNT = 2
PAIR_MESH = "lite"
PAIR_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the spawned ranks use: oneDNN's rounding of
    a row depends on the thread count, and one thread is also fastest when
    the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_pad_plan_equals_the_jax_engines(n):
    """``pad_batch`` / ``pad_idx`` equal ``Engine._pad_batch`` /
    ``_pad_idx`` (called unbound on a stand-in with ``_n_devices``) for 25
    rows over ``n`` ranks; the ranks' blocks tile the padded plan, and the
    global total is the true row count."""
    stub = types.SimpleNamespace(_n_devices=n)
    rng = np.random.RandomState(n)
    raw = [rng.uniform(size=(25, 3, 2)).astype(np.float32), rng.randint(0, 9, (25, 4))]
    idx = rng.permutation(40)[:25]
    ref_idx, ref_w = JEngine._pad_idx(stub, idx)
    got_idx, got_w = pad_idx(idx, n)
    np.testing.assert_array_equal(got_idx, ref_idx)
    assert got_idx.dtype == ref_idx.dtype
    assert (got_w is None) == (ref_w is None) and (got_w is None or np.array_equal(got_w, ref_w))
    ref = JEngine._pad_batch(stub, raw + raw[:1] + raw[:1])
    arrays, weights = pad_batch(raw, n)
    for a, b in zip(arrays, ref[:2]):
        np.testing.assert_array_equal(a, b)
    assert (weights is None) == (ref.weights is None)
    if weights is not None:
        np.testing.assert_array_equal(weights, ref.weights)
    blocks = [rank_rows(25, r, n) for r in range(n)]
    np.testing.assert_array_equal(np.concatenate([b.index for b in blocks]),
                                  pad_idx(np.arange(25), n)[0])
    assert {b.total for b in blocks} == {25 if n > 1 else None}
    assert len({len(b.index) for b in blocks}) == 1
    if weights is not None:
        np.testing.assert_array_equal(np.concatenate([b.weights for b in blocks]), weights)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Every group check as 2 gloo ranks (one spawned pair) and on one
    device; the comparison's worst gaps."""
    out = tmp_path_factory.mktemp("ranks")
    kw = dict(synt_batch=PAIR_SYNT, mesh=PAIR_MESH)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the ranks run meanwhile
        ref = pool.submit(check.reference, "cpu", **kw)
        ranks = check.launch(2, str(out), device="cpu", timeout_s=PAIR_TIMEOUT_S, **kw)
        return ranks, ref.result(timeout=PAIR_TIMEOUT_S)


@pytest.mark.parametrize("part", check.CHECKS)
def test_two_gloo_ranks_equal_one_device(pair, part):
    """The part's results on 2 gloo ranks against one device
    (``parallel.check``'s limits: loss and terms rtol 1e-6, gradients 5e-3
    of their tensor's largest entry, eval metrics 2e-4 and joints 1e-4 mm,
    term-diag values and norms 1e-5; the temporal check's loss and
    gradients as ``grads``'); after 2 combined steps the two ranks'
    parameters are equal bit for bit."""
    ranks, ref = pair
    keys = {k for k in ref if k.startswith(part + "/")}
    assert keys and all(keys <= set(r) for r in ranks[:1])
    check.compare([{k: r[k] for k in r if k in keys} for r in ranks],
                  {k: ref[k] for k in keys})
    if part == "eval":
        assert ref["eval/joints"].shape == (check.EVAL_SAMPLES, 41, 3)
        assert "eval/joints" not in ranks[1]
    if part == "steps":
        assert all(np.isfinite(ranks[0][f"steps/loss{i}"]) for i in range(2))


def _jax_row_noise(key, rows):
    """The normals JAX's PoseVae draws from ``key``, one fold_in per row."""
    keys = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(rows))
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (32,), jnp.float32))(keys))


def test_padded_combined_grads_match_jax(hand_model):
    """The port's padded ``combined_grads`` (synt_batch 8, the real batch 3
    padded to 4 at weight 0, ``real_aug=False``) against the JAX package's
    on the same parameters, the JAX synthetic batch (fed through ``synt=``)
    and the JAX prior noise, at the grad-parity tolerances of
    ``tests/test_torch_train.py``: terms within 2e-3 and the loss within
    1e-4 relative, each gradient's norm within 5 % and its first 16
    entries within 10 % + 2e-3 of the norm."""
    jcfg = JEngineConfig(synt_batch=8, real_batch=3, num_stacks=1)
    jsteps = jbuild_steps(jcfg, hand_model)
    jstate = jax.jit(jsteps.init_state)(jax.random.key(0))
    fake = check.real_batch("cpu", 3, 100)
    arrays, weights = pad_batch([x.numpy() for x in fake[:4]], 4)
    jbatch = JRealBatch(*(jnp.asarray(a) for a in arrays), jnp.asarray(weights))
    key = jax.random.key(7)
    jloss, jgrads = jax.jit(functools.partial(jsteps.combined_grads, real_aug=False))(
        jstate, key, jbatch, jnp.asarray(True))

    k_pose, k_synt, _, _, k_prior = jax.random.split(key, 5)
    synt = jax.jit(lambda kp, ks: jsynthesize(hand_model, ks, jsample_poses(kp, 8)))(
        k_pose, k_synt)
    noise = _jax_row_noise(jax.random.split(k_prior, 1)[0], 4 * 3)
    fns = build_steps(EngineConfig(synt_batch=8, real_batch=3, num_stacks=1),
                      hand=load_hand_model(device="cpu"))
    params = jax.tree.map(np.asarray, jstate.params)
    state = train_state_from_params(fns.init_state, params)
    batch = RealBatch(*(torch.from_numpy(np.array(a)) for a in arrays),
                      torch.from_numpy(weights))
    loss, terms, grads = fns.combined_grads(
        state, StepDraws(None, None, None, (torch.from_numpy(noise.copy()),)), batch, True,
        real_aug=False, synt=SyntheticBatch(*(torch.from_numpy(np.array(a)) for a in synt)))

    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert float(terms["pose_prior"]) != 0.0 and float(terms["mv_projection"]) != 0.0
    ours = flax_arrays(grads)
    ref = {"/".join(str(p.key) for p in path): np.asarray(g)
           for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert ours.keys() == ref.keys()
    for k, r in ref.items():
        g, r = ours[k].astype(np.float64).reshape(-1), r.astype(np.float64).reshape(-1)
        norm = np.linalg.norm(r)
        assert abs(np.linalg.norm(g) - norm) <= 0.05 * norm + 1e-9, k
        assert np.linalg.norm(g[:16] - r[:16]) <= 0.1 * np.linalg.norm(r[:16]) + 2e-3 * norm, k


def test_serving_over_two_devices_equals_one():
    """``PoseEstimator(devices=["cpu", "cpu"])`` on 2n + 1 rows with
    ``serve_chunk`` 2 (each device's block of n + 1 rows runs the chunk
    loop, its last chunk padded) equals one device bit for bit, joints and
    heatmaps; the pad row is gone."""
    from spherehand_torch.infer import PoseEstimator
    from spherehand_torch.models.estimator import make_network
    from spherehand_torch.train.steps import init_like_jax

    network = init_like_jax(make_network(1), torch.Generator().manual_seed(3))
    rng = np.random.RandomState(4)
    dms = np.full((7, 64, 64), 100.0, np.float32)  # 2n + 1, n = 3
    dms[:, 20:44, 20:44] = rng.uniform(-40, 40, (7, 24, 24))
    one = PoseEstimator(network, serve_chunk=2, device="cpu")
    two = PoseEstimator(network, serve_chunk=2, devices=["cpu", "cpu"])
    assert len(two.replicas) == 2 and two.replicas[1][1] is not two.network
    joints, heatmaps = two.predict_with_heatmaps(dms)
    ref_joints, ref_heatmaps = one.predict_with_heatmaps(dms)
    assert joints.shape == (7, 41, 3) and heatmaps.shape == (7, 41, 16, 16)
    np.testing.assert_array_equal(joints, ref_joints)
    np.testing.assert_array_equal(heatmaps, ref_heatmaps)
    np.testing.assert_array_equal(two.predict(dms[:1]), one.predict(dms[:1]))
