"""The port's ``combined_term_diag`` on the CPU: the per-term gradients sum
to ``combined_grads``' (as ``tests/test_term_diag.py`` pins the JAX one),
each term's value and gradient norm equal a JAX computation of the same
terms (``forward``, ``multitask_loss`` and one ``jax.vjp`` a term, as
``spherehand_tpu/train/steps.py:298-338``), and ``update_norm`` is optax's
Adam direction."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from spherehand_tpu.data.sampler import sample_poses as jsample_poses  # noqa: E402
from spherehand_tpu.data.synthesizer import synthesize as jsynthesize  # noqa: E402
from spherehand_tpu.losses import multitask as jmt  # noqa: E402
from spherehand_tpu.models import estimator as jest  # noqa: E402
from spherehand_tpu.models import pose_vae as jvae  # noqa: E402
from spherehand_tpu.models.hourglass import convert_torch_state  # noqa: E402
from spherehand_tpu.train.steps import make_optimizer  # noqa: E402
from spherehand_torch.convert import flax_arrays, train_state_from_params  # noqa: E402
from spherehand_torch.data.synthesizer import SyntheticBatch  # noqa: E402
from spherehand_torch.hand.assets import load_hand_model  # noqa: E402
from spherehand_torch.train.config import EngineConfig  # noqa: E402
from spherehand_torch.train.steps import (  # noqa: E402
    RealBatch,
    StepDraws,
    adam_direction_norm,
    build_steps,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: these tests run many small
    CPU ops, which a parallel region slows down when the suite's workers
    share the cores; the previous count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_hand():
    return load_hand_model(device="cpu")


def _terms(diag):
    return sorted(k.split("/")[0] for k in diag if k.endswith("/value"))


def _fake_batch(seed, b=1):
    """A real batch as tests/test_term_diag.py makes it: a block of depth in
    each view, identity cameras."""
    rng = np.random.RandomState(seed)
    dms = np.full((b, 3, 64, 64), 100.0, np.float32)
    dms[:, :, 24:40, 24:40] = rng.uniform(20, 60, (b, 3, 16, 16))
    eye = torch.eye(4).expand(b, 3, 4, 4).contiguous()
    return RealBatch(torch.from_numpy(dms),
                     torch.from_numpy(rng.uniform(-80, 80, (b, 3, 36, 3)).astype(np.float32)),
                     eye, eye.clone())


def _setup(port_hand, seed=3, **kw):
    cfg = EngineConfig(synt_batch=2, real_batch=1, **kw)
    fns = build_steps(cfg, hand=port_hand)
    state = fns.init_state(torch.Generator().manual_seed(seed))
    return cfg, fns, state, _fake_batch(seed)


def test_term_grads_sum_to_combined_grads(port_hand):
    """Per-term gradients sum to ``combined_grads``' total (global norm within
    rtol 1e-4, the JAX test's bound), values are the logged terms and sum to
    the loss (rtol 1e-5), cosines lie in [-1, 1] and sum_k <g_k, g> = |g|^2
    (rtol 1e-3); no parameter's ``.grad`` is written and the optimizer state
    is left as it was."""
    _, fns, state, batch = _setup(port_hand)
    draws = fns.draw(torch.Generator().manual_seed(11))
    state.network.zero_grad(set_to_none=True)
    diag = fns.combined_term_diag(state, draws, batch, True)
    assert all(p.grad is None for p in state.network.parameters())
    assert state.optimizer.state_dict()["state"] == {}
    loss, terms, grads = fns.combined_grads(state, draws, batch, True)
    total = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values())))
    np.testing.assert_allclose(float(diag["total_grad_norm"]), total, rtol=1e-4)
    names = _terms(diag)
    assert names == sorted(terms) and len(names) >= 7
    vsum = 0.0
    for name in names:
        np.testing.assert_allclose(float(diag[f"{name}/value"]), float(terms[name]), rtol=1e-5)
        vsum += float(diag[f"{name}/value"])
    np.testing.assert_allclose(vsum, float(loss), rtol=1e-5)
    dot_sum = 0.0
    for name in names:
        n, c = float(diag[f"{name}/grad_norm"]), float(diag[f"{name}/cos_total"])
        assert n >= 0.0 and -1.0 - 1e-5 <= c <= 1.0 + 1e-5
        dot_sum += c * n * total
    np.testing.assert_allclose(dot_sum, total * total, rtol=1e-3)
    assert float(diag["update_norm"]) > 0.0 and float(diag["param_norm"]) > 0.0


def test_ablated_terms(port_hand):
    """An ablated term leaves the dict (``mv_projection=False``, as the JAX
    test), and a term gated off (``is_mv`` False: the consistency weight is
    0) has a gradient norm of exactly 0."""
    _, fns, state, batch = _setup(port_hand, mv_projection=False)
    draws = fns.draw(torch.Generator().manual_seed(11))
    diag = fns.combined_term_diag(state, draws, batch, False)
    names = _terms(diag)
    assert "mv_projection" not in names and "mv_consistency" in names
    assert float(diag["mv_consistency/grad_norm"]) == 0.0
    assert float(diag["mv_consistency/value"]) == 0.0


def _jax_row_noise(key, rows):
    keys = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(rows))
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (32,), jnp.float32))(keys))


def test_terms_match_jax_vjp(goldens, hand_model, port_hand):
    """With JAX's ``synthesize`` batch as ``synt=``, ``real_aug=False`` and
    JAX's prior noise, from the golden init: each term's value within rtol
    1e-5 (2e-4 for the mutual projection, as tests/test_torch_losses.py)
    and each term's gradient norm and the total within rtol 1e-2 of a
    jitted JAX computation of the same terms. Gradient norms carry float32
    accumulation order through GroupNorm and the silhouettes: on these
    inputs JAX's own jitted and op-by-op runs differ by 5e-3 in
    ``mv_projection``'s norm and 2.6e-3 in the total."""
    gold = goldens("grad_parity_ab")
    params = convert_torch_state(dict(goldens("grad_parity_init")), num_stacks=1)
    synt_b = 2
    synt = jax.jit(lambda k1, k2: jsynthesize(hand_model, k1, jsample_poses(k2, synt_b)))(
        jax.random.PRNGKey(5), jax.random.PRNGKey(4))
    real = {k: np.asarray(gold[k][:1], np.float32)
            for k in ("real_dms", "real_poses", "real_inv_poses")}
    key = jax.random.key(8)
    noise = _jax_row_noise(jax.random.split(key, 1)[0], 3)

    cfg = EngineConfig(synt_batch=synt_b, real_batch=1)
    net = jest.make_network(1)
    target = {"real_dms": jnp.asarray(real["real_dms"]),
              "camera_poses": jnp.asarray(real["real_poses"]),
              "inv_camera_poses": jnp.asarray(real["real_inv_poses"])}
    vae_params = jvae.load_pose_vae_params()

    def terms_fn(p):
        out = jest.forward(net, p, synt_dms=synt.dms, real_dms=target["real_dms"] * 0.01,
                           train=True, real_aug=False)
        terms, _, _ = jmt.multitask_loss(
            jmt.LossConfig(**vars(cfg.loss_config)), out, hand_model.kp_radius,
            vae_params=vae_params, synt_target=synt, real_target=target, rng=key,
            is_mv=jnp.asarray(True), prev_skel=jnp.zeros((3, 41, 3)),
            has_prev=jnp.asarray(False))
        return terms

    names = sorted(jax.eval_shape(terms_fn, params))

    @jax.jit
    def reference(p):
        """Each term's value and gradient norm, one one-hot cotangent a term
        (steps.py:298-338), and the total's (all-ones)."""
        terms, vjp_fn = jax.vjp(terms_fn, p)
        cots = {n: jnp.asarray([1.0 if m == n else 0.0 for m in names] + [1.0])
                for n in names}
        (grads,) = jax.vmap(vjp_fn)(cots)
        return terms, jax.vmap(optax.global_norm)(grads)

    terms, norms = reference(params)
    ref_norm = dict(zip(names + ["total"], np.asarray(norms).tolist()))

    fns = build_steps(cfg, hand=port_hand)
    state = train_state_from_params(fns.init_state, params)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    batch = RealBatch(t(real["real_dms"]), torch.zeros(1, 3, 36, 3), t(real["real_poses"]),
                      t(real["real_inv_poses"]))
    diag = fns.combined_term_diag(
        state, StepDraws(None, None, None, (torch.from_numpy(noise.copy()),)), batch, True,
        real_aug=False, synt=SyntheticBatch(*(t(a) for a in synt)))
    assert _terms(diag) == names
    for name in names:
        np.testing.assert_allclose(float(diag[f"{name}/value"]), float(terms[name]), atol=1e-6,
                                   rtol=2e-4 if name == "mv_projection" else 1e-5)
        np.testing.assert_allclose(float(diag[f"{name}/grad_norm"]), ref_norm[name],
                                   rtol=1e-2, atol=1e-6 * ref_norm["total"])
    np.testing.assert_allclose(float(diag["total_grad_norm"]), ref_norm["total"], rtol=1e-2)
    np.testing.assert_allclose(
        float(diag["param_norm"]),
        np.sqrt(sum((np.asarray(x, np.float64) ** 2).sum() for x in jax.tree.leaves(params))),
        rtol=1e-6)


def _adam_state(optimizer, by_name):
    return {(n, k): torch.as_tensor(v).clone() for n, p in by_name.items()
            for k, v in optimizer.state.get(p, {}).items()}


def test_update_norm_is_optax_adam_direction(port_hand):
    """``adam_direction_norm`` equals optax's ``add_decayed_weights`` ->
    ``scale_by_adam`` direction (the JAX step's optimizer) for the same
    gradient at the port's Adam moments and count, at a fresh state and
    after one Adam step (rtol 2e-5, both norms summed in float64: after
    the step optax's float32 direction is 1.0e-5 from the same formula in
    float64, which the port's matches to 1e-8); the optimizer state is left
    as it was. At the fresh state the diagnostics' ``update_norm`` (from
    the sum of the per-term gradients) is within 1e-3 of it (the two
    gradients differ in float32 rounding, which near-zero elements carry
    into a sign-like direction)."""
    cfg, fns, state, batch = _setup(port_hand, seed=4)
    gen = torch.Generator().manual_seed(12)
    tx = make_optimizer(cfg.weight_decay)
    by_name = dict(state.network.named_parameters())
    for stepped in (False, True):
        if stepped:
            state.optimizer.step()  # the moments of the fresh step's gradient
        draws = fns.draw(gen)
        if not stepped:
            diag = fns.combined_term_diag(state, draws, batch, True)
        _, _, grads = fns.combined_grads(state, draws, batch, True)
        before = _adam_state(state.optimizer, by_name)
        ours = float(adam_direction_norm(state.optimizer, {by_name[n]: g
                                                           for n, g in grads.items()}))
        after = _adam_state(state.optimizer, by_name)
        assert before.keys() == after.keys()
        assert all(torch.equal(before[k], after[k]) for k in before)
        params = flax_arrays(by_name)
        opt = tx.init(params)
        if stepped:
            st = state.optimizer.state
            assert {int(st[p]["step"]) for p in by_name.values()} == {1}
            mu = flax_arrays({n: st[p]["exp_avg"] for n, p in by_name.items()})
            nu = flax_arrays({n: st[p]["exp_avg_sq"] for n, p in by_name.items()})
            opt = (opt[0], opt[1]._replace(count=jnp.asarray(1, jnp.int32), mu=mu, nu=nu))
        updates, _ = tx.update(flax_arrays(grads), opt, params)
        ref = np.sqrt(sum((np.asarray(u, np.float64) ** 2).sum()
                          for u in jax.tree.leaves(updates)))
        np.testing.assert_allclose(ours, ref, rtol=2e-5)
        if not stepped:
            np.testing.assert_allclose(float(diag["update_norm"]), ref, rtol=1e-3)


def test_term_diag_under_bf16(port_hand):
    """Under ``bf16`` the diagnostics run, and every entry is a finite
    float32 scalar."""
    _, fns, state, batch = _setup(port_hand, bf16=True)
    diag = fns.combined_term_diag(state, fns.draw(torch.Generator().manual_seed(2)), batch, True)
    assert len(_terms(diag)) >= 7
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v)) for v in diag.values())
