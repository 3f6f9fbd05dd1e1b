"""Training at two stacks (the reference network's depth) against the JAX
package on the CPU, at small widths (2 synthetic, 1 x 3 real): the
hourglass's 2-stack gradient against ``jax.grad``, the estimator's
per-stack outputs, ``synt_step`` and ``combined_step`` against JAX's jitted
steps on the same draws and parameters (JAX's own 2-stack init, carried
across as numpy), every loss term and each stack's share of the mutual
projection and the prior at fixed network outputs, ``eval_step`` with its
headline on the last stack, an engine epoch, the CLI's Test mode and a
2-stack checkpoint served by the port and by JAX's estimator; then two
pieces of the tools: ``bench_infer``'s copy filter and
``train_synthetic_full``'s resume."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from spherehand_tpu.data.noise import _rowwise_uniform  # noqa: E402
from spherehand_tpu.data.sampler import sample_poses as jsample_poses  # noqa: E402
from spherehand_tpu.data.synthesizer import SyntheticBatch as JSyntheticBatch  # noqa: E402
from spherehand_tpu.data.synthesizer import synthesize as jsynthesize  # noqa: E402
from spherehand_tpu.infer import PoseEstimator as JPoseEstimator  # noqa: E402
from spherehand_tpu.infer import load_params_npz as jload_params_npz  # noqa: E402
from spherehand_tpu.losses import multitask as jmt  # noqa: E402
from spherehand_tpu.losses.multiview import mutual_projection_loss as jmpl  # noqa: E402
from spherehand_tpu.models import estimator as jest  # noqa: E402
from spherehand_tpu.models import pose_vae as jvae  # noqa: E402
from spherehand_tpu.train.config import EngineConfig as JEngineConfig  # noqa: E402
from spherehand_tpu.train.steps import RealBatch as JRealBatch  # noqa: E402
from spherehand_tpu.train.steps import build_steps as jbuild_steps  # noqa: E402
from spherehand_torch import convert  # noqa: E402
from spherehand_torch.constants import Constants  # noqa: E402
from spherehand_torch.data import pseudo_real  # noqa: E402
from spherehand_torch.data.noise import ResizeDraws, resize_scales  # noqa: E402
from spherehand_torch.data.nyu import write_shard  # noqa: E402
from spherehand_torch.data.synthesizer import SyntheticBatch  # noqa: E402
from spherehand_torch.evaluation.metrics import average_joint_error  # noqa: E402
from spherehand_torch.hand.assets import load_hand_model  # noqa: E402
from spherehand_torch.infer import load_estimator  # noqa: E402
from spherehand_torch.losses.multitask import LOSS_WEIGHTS, multitask_loss  # noqa: E402
from spherehand_torch.losses.multiview import mutual_projection_loss  # noqa: E402
from spherehand_torch.models.estimator import forward, make_network  # noqa: E402
from spherehand_torch.models.pose_vae import load_pose_vae_model, prior_loss  # noqa: E402
from spherehand_torch.tools import bench_infer, train_synthetic_full  # noqa: E402
from spherehand_torch.tools.selfsup_demo import params_sha256  # noqa: E402
from spherehand_torch.train import cli  # noqa: E402
from spherehand_torch.train.config import EngineConfig  # noqa: E402
from spherehand_torch.train.engine import Engine, save_state  # noqa: E402
from spherehand_torch.train.priors import save_flax_params_npz  # noqa: E402
from spherehand_torch.train.steps import RealBatch, StepDraws, build_steps  # noqa: E402

STACKS, SYNT, REAL, VIEWS = 2, 2, 1, 3
LR = 1e-3


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_hand():
    return load_hand_model(device="cpu")


@pytest.fixture(scope="module")
def setup(hand_model, port_hand):
    """Both packages' step functions at 2 stacks, JAX's init as numpy, and
    a rendered 1 x 3 real batch."""
    kw = dict(num_stacks=STACKS, synt_batch=SYNT, real_batch=REAL, eval_precision="highest")
    jfns = jbuild_steps(JEngineConfig(**kw), hand_model)
    jstate = jfns.init_state(jax.random.key(0))
    params = jax.tree.map(np.asarray, jstate.params)
    fns = build_steps(EngineConfig(**kw), hand=port_hand)
    real = pseudo_real.render_multiview_batch(port_hand, torch.Generator().manual_seed(3), REAL)
    return {"jfns": jfns, "jstate": jstate, "params": params, "fns": fns,
            "batch": RealBatch(*real[:4])}


def _port_state(setup):
    return convert.train_state_from_params(setup["fns"].init_state, setup["params"])


def _row_noise(key, rows: int) -> np.ndarray:
    """The normals JAX's prior draws from a stack's key, one fold_in a row."""
    keys = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(rows))
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (32,), jnp.float32))(keys))


def _stack_noise(key, rows: int) -> tuple:
    """One noise tensor a stack, from ``jax.random.split(key, 2)`` in order."""
    return tuple(t(_row_noise(k, rows)) for k in jax.random.split(key, STACKS))


def _jax_synt(hand_model, k_pose, k_synt) -> SyntheticBatch:
    synt = jsynthesize(hand_model, k_synt, jsample_poses(k_pose, SYNT))
    return SyntheticBatch(*(t(a) for a in synt))


def _params_after(state) -> dict:
    return convert.flax_arrays({n: p.detach() for n, p in state.network.named_parameters()})


def _assert_terms(ours: dict, ref: dict, rel: float, tag: str):
    assert set(ref) <= set(ours), (tag, sorted(ref), sorted(ours))
    for name, value in ref.items():
        want = float(value)
        assert abs(float(ours[name]) - want) <= rel * max(abs(want), 1e-6), (tag, name, want,
                                                                            float(ours[name]))


def _assert_step_terms(ours: dict, ref: dict, tag: str):
    """Through the two networks: the loss within 1e-4 relative and each term
    within 2e-3 (tests/test_grad_parity.py's bars). ``collision``, a hinge
    whose few active pairs sit at its 6 mm edge, moves by tens of percent
    with joints a thousandth of a millimetre apart, so it is held at fixed
    joints instead (``test_terms_and_each_stacks_share_at_fixed_outputs``)."""
    assert sorted(ref) == sorted(ours), tag
    _assert_terms(ours, {"loss": ref["loss"]}, 1e-4, tag)
    _assert_terms(ours, {k: v for k, v in ref.items() if k not in ("loss", "collision")}, 2e-3,
                  tag)


def _assert_adam_step(state, jstate):
    ours = _params_after(state)
    theirs = convert.flatten_params(jax.tree.map(np.asarray, jstate.params))
    assert ours.keys() == theirs.keys() and any(k.startswith("hg1/") for k in ours)
    for k in ours:
        assert np.abs(ours[k] - theirs[k]).max() <= 2.5 * LR, k


def test_hourglass_two_stack_gradient_matches_jax_grad(setup):
    """A weighted sum of both stacks' scores and latents, through the
    re-injection between them (``inter_fc``, ``inter_score``): the port's
    float32 gradient of every parameter within 1e-4 of its tensor's largest
    entry of ``jax.grad``'s, and the scores within 1e-4 of their largest.
    JAX runs in float64 here: its own float32 gradient of the first layers
    (``conv1``, ``layer1``) lies 1.3 % of the largest entry from its float64
    one, where the port's float32 lies within 2e-6."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0.2, 1.0, (2, 64, 64)).astype(np.float32)
    w_score = rng.standard_normal((STACKS, 2, 82, 16, 16)).astype(np.float32)
    w_latent = rng.standard_normal((STACKS, 2, 256, 4, 4)).astype(np.float32)
    params = setup["params"]
    with jax.enable_x64(True):
        jnet = jest.make_network(STACKS, dtype=jnp.float64, precision="highest")

        def jloss(p):
            scores, latents = jnet.apply({"params": p}, jnp.asarray(x, jnp.float64))
            total = 0.0
            for s in range(STACKS):
                total += jnp.sum(scores[s] * w_score[s].transpose(0, 2, 3, 1).astype(np.float64))
                total += jnp.sum(latents[s] * w_latent[s].transpose(0, 2, 3, 1).astype(np.float64))
            return total, scores

        (_, jscores), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params))
        jscores = [np.asarray(a) for a in jscores]
        theirs = convert.flatten_params(jax.tree.map(np.asarray, jgrads))
    net = convert.load_flax_params(make_network(STACKS), params)
    scores, latents = net(torch.from_numpy(x))
    assert len(scores) == len(latents) == STACKS
    total = sum((scores[s] * t(w_score[s])).sum() + (latents[s] * t(w_latent[s])).sum()
                for s in range(STACKS))
    total.backward()
    for s in range(STACKS):
        want = jscores[s].transpose(0, 3, 1, 2)
        assert np.abs(scores[s].detach().numpy() - want).max() <= 1e-4 * np.abs(want).max(), s
    ours = convert.flax_arrays({n: p.grad for n, p in net.named_parameters()})
    assert ours.keys() == theirs.keys()
    assert {"inter_fc0/kernel", "inter_score0/kernel", "score1/kernel"} <= ours.keys()
    for k, g in theirs.items():
        assert g.dtype == np.float64 and np.abs(g).max() > 0, k
        assert np.abs(ours[k] - g).max() <= 1e-4 * np.abs(g).max(), k


def test_flax_params_round_trip_at_two_stacks(setup):
    """JAX's 2-stack parameters into the port and back out, bit for bit."""
    net = convert.load_flax_params(make_network(STACKS), setup["params"])
    back = convert.flatten_params(convert.flax_params(net))
    want = convert.flatten_params(setup["params"])
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) for k in want)


def test_synt_step_matches_jax(setup, hand_model):
    """One synthetic step from JAX's 2-stack init on JAX's synthetic batch:
    the loss within 1e-4 relative, each term within 2e-3
    (tests/test_grad_parity.py's bars), the parameters after Adam within
    2.5 lr of JAX's (tests/test_torch_train.py's)."""
    key = jax.random.key(11)
    jstate, ref = jax.jit(setup["jfns"].synt_step)(setup["jstate"], key, jnp.asarray(LR))
    k_pose, k_synt, _ = jax.random.split(key, 3)
    state = _port_state(setup)
    state, metrics = setup["fns"].synt_step(state, LR, StepDraws(None, None, None, None),
                                            synt=_jax_synt(hand_model, k_pose, k_synt))
    _assert_step_terms(metrics, ref, "synt_step")
    _assert_adam_step(state, jstate)


def _combined_inputs(setup, hand_model, key):
    """JAX's combined draws from ``key`` (split 5: poses, synthesis,
    resample, resize-crop, prior) as the port's synthetic batch and draws."""
    k_pose, k_synt, _, k_aug, k_prior = jax.random.split(key, 5)
    rows = REAL * VIEWS
    k_coin, k_base, k_u, k_v = jax.random.split(k_aug, 4)
    resize = [jax.random.uniform(k_coin, ())] + [
        _rowwise_uniform(k, (rows, 1))[:, 0] for k in (k_base, k_u, k_v)]
    draws = StepDraws(None, None, ResizeDraws(*(t(a) for a in resize)),
                      _stack_noise(k_prior, rows))
    return _jax_synt(hand_model, k_pose, k_synt), draws


def test_combined_step_matches_jax(setup, hand_model):
    """One combined step (is_mv on) from JAX's 2-stack init on JAX's draws,
    a VAE noise a stack: the loss and terms as ``_assert_step_terms``, the
    last stack's joints within 1e-2 mm (the serving limit), the parameters
    after Adam within 2.5 lr."""
    key = jax.random.key(12)
    jbatch = JRealBatch(*(jnp.asarray(a.numpy()) for a in setup["batch"][:4]))
    jstate, ref, jvis = jax.jit(setup["jfns"].combined_step)(
        setup["jstate"], key, jnp.asarray(LR), jbatch, jnp.asarray(True))
    synt, draws = _combined_inputs(setup, hand_model, key)
    state = _port_state(setup)
    state, metrics, vis = setup["fns"].combined_step(state, LR, draws, setup["batch"], True,
                                                     synt=synt)
    _assert_step_terms(metrics, ref, "combined_step")
    np.testing.assert_allclose(vis["real_xyz"].numpy(), np.asarray(jvis["real_xyz"]),
                               atol=1e-2)
    _assert_adam_step(state, jstate)


def _assert_grads_match(ours: dict, theirs: dict):
    """Leaf by leaf, as tests/test_torch_train.py holds the 1-stack gradient
    against the reference's: each gradient's norm within 5 % and its first
    16 entries within 10 % of theirs plus 2e-3 of the norm."""
    assert ours.keys() == theirs.keys()
    assert {"inter_fc0/kernel", "inter_score0/kernel", "score1/kernel"} <= ours.keys()
    for k, g in theirs.items():
        g = np.asarray(g, np.float64).reshape(-1)
        mine = np.asarray(ours[k], np.float64).reshape(-1)
        norm = np.linalg.norm(g)
        assert norm > 0 and abs(np.linalg.norm(mine) - norm) <= 0.05 * norm, k
        assert np.linalg.norm(mine[:16] - g[:16]) <= 0.1 * np.linalg.norm(g[:16]) + 2e-3 * norm, k


def test_combined_grads_and_term_diag_match_jax(setup, hand_model):
    """The combined objective's gradient at 2 stacks against ``jax.vjp`` of
    JAX's (``steps.py:298-338``: its forward and ``multitask_loss`` on the
    draws of ``test_combined_step_matches_jax``, one one-hot cotangent a
    term and one all-ones): ``combined_grads`` leaf by leaf as
    ``_assert_grads_match``, and ``combined_term_diag``'s values within
    rtol 1e-5 (2e-4 for the mutual projection), its gradient norms, each
    term's and the total's, within rtol 1e-2 (tests/test_torch_term_diag.py's
    bars, without its atol: the prior's norm is a millionth of the total's,
    and each term's norm is held on its own). The synthetic step's terms (``synt_uv``, ``synt_d``) are terms of
    this objective, through both stacks. ``collision``'s value is left out
    as in ``_assert_step_terms`` (its hinge edge), its gradient norm is not.
    A stack detached from a term, or a stack's share of the mutual
    projection or the prior lost from the backward, moves that term's norm
    by far more."""
    key = jax.random.key(12)
    _, _, _, k_aug, k_prior = jax.random.split(key, 5)
    synt, draws = _combined_inputs(setup, hand_model, key)
    batch, jstate = setup["batch"], setup["jstate"]
    jsynt = JSyntheticBatch(*(jnp.asarray(a.numpy()) for a in synt))
    target = {"real_dms": jnp.asarray(batch.dms.numpy()),
              "camera_poses": jnp.asarray(batch.poses.numpy()),
              "inv_camera_poses": jnp.asarray(batch.inv_poses.numpy())}
    net = jest.make_network(STACKS)
    vae_params = jvae.load_pose_vae_params()
    loss_cfg = JEngineConfig(num_stacks=STACKS).loss_config

    def terms_fn(p):
        out = jest.forward(net, p, synt_dms=jsynt.dms,
                           real_dms=target["real_dms"] * Constants().depth_scale, rng=k_aug,
                           train=True, real_aug=True)
        terms, _, _ = jmt.multitask_loss(
            loss_cfg, out, hand_model.kp_radius, vae_params=vae_params, synt_target=jsynt,
            real_target=target, rng=k_prior, is_mv=jnp.asarray(True),
            prev_skel=jstate.prev_skel, has_prev=jstate.has_prev)
        return terms

    names = sorted(jax.eval_shape(terms_fn, jstate.params))

    @jax.jit
    def reference(p):
        terms, vjp_fn = jax.vjp(terms_fn, p)
        cots = {n: jnp.asarray([1.0 if m == n else 0.0 for m in names] + [1.0]) for n in names}
        (grads,) = jax.vmap(vjp_fn)(cots)
        return terms, jax.vmap(optax.global_norm)(grads), jax.tree.map(lambda g: g[-1], grads)

    terms, norms, total = reference(jstate.params)
    ref_norm = dict(zip(names + ["total"], np.asarray(norms).tolist()))

    state = _port_state(setup)
    _, values, grads = setup["fns"].combined_grads(state, draws, batch, True, synt=synt)
    _assert_grads_match(convert.flax_arrays(grads),
                        convert.flatten_params(jax.tree.map(np.asarray, total)))
    diag = setup["fns"].combined_term_diag(state, draws, batch, True, synt=synt)
    assert sorted(k[:-len("/value")] for k in diag if k.endswith("/value")) == names
    assert {"mv_projection", "pose_prior"} <= set(names)
    for name in names:
        rtol = 2e-4 if name == "mv_projection" else 1e-5
        for got in (values[name], diag[f"{name}/value"]):
            if name != "collision":
                np.testing.assert_allclose(float(got), float(terms[name]), atol=1e-6, rtol=rtol,
                                           err_msg=name)
        np.testing.assert_allclose(float(diag[f"{name}/grad_norm"]), ref_norm[name], rtol=1e-2,
                                   err_msg=name)
    np.testing.assert_allclose(float(diag["total_grad_norm"]), ref_norm["total"], rtol=1e-2)


def test_terms_and_each_stacks_share_at_fixed_outputs(setup, hand_model):
    """The port's estimator outputs at 2 stacks equal JAX's ``forward`` on
    the same parameters and inputs (per stack, in JAX's order), and on those
    outputs every term of the port's ``multitask_loss`` (temporal on, with a
    carried skeleton) equals JAX's within rtol 1e-5 (2e-4 for the mutual
    projection), atol 1e-6 (tests/test_torch_train.py's bars), as does each
    stack's share of the mutual projection and of the prior."""
    rng = np.random.RandomState(4)
    state = _port_state(setup)
    synt, draws = _combined_inputs(setup, hand_model, jax.random.key(13))
    batch = setup["batch"]
    c = Constants()
    scales = resize_scales(draws.resize)
    with torch.no_grad():
        out = forward(state.network, synt_dms=synt.dms, real_dms=batch.dms * c.depth_scale,
                      scales=scales)
    jout = jax.jit(lambda p, sd, rd: jest.forward(
        jest.make_network(STACKS, precision="highest"), p, synt_dms=sd, real_dms=rd))(
        jax.tree.map(jnp.asarray, setup["params"]), jnp.asarray(synt.dms.numpy()),
        jnp.asarray(batch.dms.numpy() * c.depth_scale))
    for name in ("synt_uv_hms", "synt_xyz"):
        ours, theirs = getattr(out, name), getattr(jout, name)
        assert len(ours) == len(theirs) == STACKS
        for s in range(STACKS):
            want = np.asarray(theirs[s])
            assert np.abs(ours[s].numpy() - want).max() <= 1e-4 * np.abs(want).max(), (name, s)
    assert len(out.real_xyz) == len(out.synt_latent) == len(out.real_latent) == STACKS

    heads = [tuple(jnp.asarray(x.numpy()) for x in getattr(out, k))
             for k in jest.EstimatorOutput._fields[:6]]
    latents = [tuple(jnp.asarray(x.numpy().transpose(0, 2, 3, 1)) for x in getattr(out, k))
               for k in ("synt_latent", "real_latent")]  # NCHW -> NHWC
    j_out = jest.EstimatorOutput(*heads, None, *latents)
    target = {"real_dms": batch.dms, "camera_poses": batch.poses,
              "inv_camera_poses": batch.inv_poses}
    jtarget = {k: jnp.asarray(v.numpy()) for k, v in target.items()}
    prev = rng.uniform(-50, 50, (VIEWS, 41, 3)).astype(np.float32)
    key = jax.random.key(14)
    cfg = EngineConfig(temporal=True).loss_config
    vae = load_pose_vae_model(device="cpu")
    vae_params = jvae.load_pose_vae_params()
    radii = hand_model.kp_radius
    radii_t = t(radii)
    noise = _stack_noise(key, REAL * VIEWS)
    with torch.no_grad():
        ours, _, (new_prev, _) = multitask_loss(
            cfg, out, radii_t, vae=vae, synt_target=synt,
            real_target=target, vae_noise=noise, is_mv=True, prev_skel=t(prev),
            has_prev=torch.tensor(True))
    jsynt = JSyntheticBatch(*(jnp.asarray(a.numpy()) for a in synt))
    ref, _, (jprev, _) = jax.jit(lambda o, st, rt, k, p: jmt.multitask_loss(
        jmt.LossConfig(temporal=True), o, radii, vae_params=vae_params, synt_target=st,
        real_target=rt, rng=k, is_mv=jnp.asarray(True), prev_skel=p,
        has_prev=jnp.asarray(True)))(j_out, jsynt, jtarget, key, jnp.asarray(prev))
    assert sorted(ours) == sorted(ref) and "domain_loss" in ref and "temporal_smooth" in ref
    for name, value in ref.items():
        np.testing.assert_allclose(float(ours[name]), float(value), atol=1e-6,
                                   rtol=2e-4 if name == "mv_projection" else 1e-5, err_msg=name)
    np.testing.assert_array_equal(new_prev.numpy(), np.asarray(jprev))

    rngs = jax.random.split(key, STACKS)
    shares = {"mv_projection": [], "pose_prior": []}
    for s in range(STACKS):
        xyz = out.real_xyz[s]
        with torch.no_grad():
            mine = mutual_projection_loss(batch.poses, batch.inv_poses, xyz, batch.dms, radii_t)[0]
            prior = prior_loss(vae, xyz / 100.0, noise[s])
        want = jmpl(jtarget["camera_poses"], jtarget["inv_camera_poses"],
                    jnp.asarray(xyz.numpy()), jtarget["real_dms"], radii)[0]
        want_prior = jvae.prior_loss(vae_params, jnp.asarray(xyz.numpy()) / 100.0, rngs[s])
        np.testing.assert_allclose(float(mine), float(want), rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(float(prior), float(want_prior), rtol=1e-5, atol=1e-6)
        shares["mv_projection"].append(LOSS_WEIGHTS["mv_projection"] * float(want))
        shares["pose_prior"].append(LOSS_WEIGHTS["prior"] * float(want_prior))
    for name, parts in shares.items():
        np.testing.assert_allclose(float(ref[name]), sum(parts), rtol=1e-5)
        assert min(parts) > 0


def test_eval_step_matches_jax_and_reads_the_last_stack(setup, hand_model):
    """``eval_step`` at 2 stacks: its terms equal JAX's ``multitask_loss`` on
    the same outputs and a noise a stack (rtol 1e-5, 2e-4 for the mutual
    projection, atol 1e-6; tests/test_torch_train.py's bars); its headline
    is the last stack's, and within 1e-2 mm (the serving limit) of JAX's
    jitted ``eval_step`` on the same parameters, through the two networks."""
    state = _port_state(setup)
    batch = setup["batch"]
    key = jax.random.key(15)
    draws = StepDraws(None, None, None, _stack_noise(key, REAL * VIEWS))
    metrics, denoised = setup["fns"].eval_step(state, draws, batch)
    with torch.no_grad():
        out = forward(state.network, real_dms=batch.dms * Constants().depth_scale)
    heads = [tuple(jnp.asarray(x.numpy()) for x in getattr(out, k))
             for k in jest.EstimatorOutput._fields[3:6]]
    target = {"real_dms": batch.dms, "camera_poses": batch.poses,
              "inv_camera_poses": batch.inv_poses}
    ref, _, _ = jmt.multitask_loss(
        jmt.LossConfig(), jest.EstimatorOutput((), (), (), *heads, None, (), ()),
        hand_model.kp_radius, vae_params=jvae.load_pose_vae_params(),
        real_target={k: jnp.asarray(v.numpy()) for k, v in target.items()}, rng=key,
        is_mv=jnp.asarray(True), prev_skel=jnp.zeros((VIEWS, 41, 3)),
        has_prev=jnp.asarray(False))
    assert sorted(ref) == sorted(k for k in metrics if not k.startswith("avg_joint_error"))
    for name, value in ref.items():
        np.testing.assert_allclose(float(metrics[name]), float(value), atol=1e-6,
                                   rtol=2e-4 if name == "mv_projection" else 1e-5, err_msg=name)

    raw = [float(average_joint_error(batch.gt_joints[:, 0], xyz[:, 0])) for xyz in out.real_xyz]
    assert abs(raw[0] - raw[1]) > 1e-3  # the stacks differ, so the headline names one
    assert float(metrics["avg_joint_error_raw"]) == pytest.approx(raw[-1], abs=1e-5), raw
    jbatch = JRealBatch(*(jnp.asarray(a.numpy()) for a in batch[:4]))
    jmetrics, jdenoised = jax.jit(setup["jfns"].eval_step)(
        jax.tree.map(jnp.asarray, setup["params"]), key, jbatch)
    for name in ("avg_joint_error", "avg_joint_error_raw"):
        assert abs(float(metrics[name]) - float(jmetrics[name])) <= 1e-2, name
    np.testing.assert_allclose(denoised.numpy(), np.asarray(jdenoised), atol=1e-2)


def _shards(root) -> str:
    rng = np.random.RandomState(0)
    for subset, n in (("train", 2), ("test", 2)):
        d = root / subset
        d.mkdir()
        dms = np.full((n, 3, 64, 64), 100.0, np.float32)
        dms[:, :, 24:44, 24:44] = rng.uniform(20, 60, (n, 3, 20, 20))
        joints = rng.uniform(-80, 80, (n, 3, 36, 3)).astype(np.float32)
        poses = np.tile(np.eye(4, dtype=np.float32), (n, 3, 1, 1))
        write_shard(str(d), "mv_data_0", dms, joints, poses)
    return str(root)


def test_engine_epoch_cli_test_mode_and_serving_at_two_stacks(tmp_path, port_hand):
    """A synthetic epoch takes ``synt_iters_per_epoch`` x ``num_stacks``
    steps (JAX engine.py:601); its checkpoint records 2 stacks, refuses a
    1-stack load, runs the CLI's ``--mode Test --num_stacks 2`` into
    ``result.npz`` (every array finite), and serves three crops through
    ``load_estimator(num_stacks=2)``: finite joints of the right shape (the
    comparison with JAX's estimator is the next test's)."""
    data = _shards(tmp_path)
    kw = dict(mode="Train", model_dir=str(tmp_path / "runs"), dataset_dir=data, epoch=1,
              real_batch=2, synt_batch=2, eval_batch=2, synt_iters_per_epoch=2, tag="s_",
              mv_projection=False, mv_consistency=False, collision=False, bone_length=False,
              prior=False)
    steps = {}
    for stacks in (1, STACKS):
        engine = Engine(EngineConfig(num_stacks=stacks, **kw), device="cpu", hand=port_hand)
        engine.train()
        steps[stacks] = engine.state.step
    assert steps == {1: 2, STACKS: 4}
    ckpt = os.path.join(engine.model_path, "model_0.pt")
    assert torch.load(ckpt, weights_only=True)["num_stacks"] == STACKS
    with pytest.raises(ValueError, match="2-stack"):
        load_estimator(ckpt, num_stacks=1, device="cpu")

    cli.main(["--mode", "Test", "--num_stacks", "2", "--initial_model", ckpt,
              "--dataset_dir", data, "--model_dir", str(tmp_path / "runs"), "--eval_batch", "2",
              "--eval_precision", "highest", "--device", "cpu"])
    results = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path / "runs") for f in fs
               if f == "result.npz"]
    assert len(results) == 1
    with np.load(results[0]) as res:
        assert all(np.isfinite(res[k]).all() for k in res.files)

    crops = np.full((3, 64, 64), 100.0, np.float32)
    crops[:, 20:44, 20:44] = np.random.RandomState(1).uniform(20, 60, (3, 24, 24))
    served = load_estimator(ckpt, num_stacks=STACKS, device="cpu").predict(crops)
    assert served.shape == (3, 41, 3) and np.isfinite(served).all()


def test_two_stack_checkpoint_serves_as_jax_does(tmp_path, goldens, setup):
    """The reference's released 2-stack weights (``hourglass.npz``) as the
    engine's checkpoint: ``load_estimator(num_stacks=2)`` serves three
    rendered views as JAX's estimator does on the converted parameters,
    within 1e-3 mm. JAX runs its float64 network here (its ``PoseEstimator``
    with ``make_network(2, dtype=float64)``): its own float32 estimator lies
    6.1e-3 mm from that, the port's 3.2e-4 mm."""
    golden = goldens("hourglass")
    weights = {k: np.asarray(golden[k]) for k in golden.files
               if k not in ("x", "out0", "out1", "latent0", "latent1")}
    state = setup["fns"].init_state(torch.Generator().manual_seed(0))
    state.network.load_state_dict(convert.reference_hourglass_state(weights, STACKS))
    ckpt = str(tmp_path / "model_0.pt")
    save_state(ckpt, state, epoch=0)
    est = load_estimator(ckpt, num_stacks=STACKS, precision="highest", device="cpu")
    npz = str(tmp_path / "two_stacks.npz")
    save_flax_params_npz(npz, convert.flax_params(est.network))
    crops = setup["batch"].dms.reshape(-1, 64, 64).numpy()
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jload_params_npz(npz))
        jestimator = JPoseEstimator(params, num_stacks=STACKS, denoise=True,
                                    precision="highest")
        jestimator.network = jest.make_network(STACKS, dtype=jnp.float64, precision="highest")
        theirs = np.asarray(jestimator.predict(crops))
    assert theirs.dtype == np.float64
    np.testing.assert_allclose(est.predict(crops), theirs, atol=1e-3)


def test_bench_infer_leaves_the_copies_out():
    """``device_ms`` is the union of the activities that are not host<->
    device copies; the copies' own union and the union of all are printed
    beside it."""
    spans = [("sgemm_kernel", 0.0, 10.0), ("Memcpy HtoD (Pageable -> Device)", 8.0, 14.0),
             ("Memcpy DtoD (Device -> Device)", 20.0, 22.0), ("Memset (Device)", 21.0, 23.0),
             ("Memcpy DtoH (Device -> Pageable)", 30.0, 35.0), ("upsample2x_fwd", 33.0, 34.0)]
    own, copies, union = bench_infer.split_copies(spans)
    assert (own, copies, union) == (14.0, 11.0, 22.0)
    assert own + copies >= union
    assert bench_infer.split_copies([]) == (0.0, 0.0, 0.0)


class _Stop(Exception):
    """A process killed at this point."""


def test_train_synthetic_full_resumes_bit_for_bit(tmp_path, monkeypatch):
    """Checkpoints every 2 steps. Stopped before step 3 of 5, its checkpoint
    at step 2, and resumed; or stopped between the checkpoint of step 4 and
    the state that records it: the straight run's parameters, losses,
    errors and history, bit for bit; other settings are refused."""
    tsf = train_synthetic_full
    kw = dict(batch=2, device="cpu", log_every=2)
    straight = tsf.train_synthetic(5, **kw)
    monkeypatch.setattr(tsf, "SAVE_EVERY", 2)
    learning_rate, write_json = tsf.learning_rate, tsf._write_json

    def stop_at_3(step, num_steps):
        if step == 3:
            raise _Stop
        return learning_rate(step, num_steps)

    stop = str(tmp_path / "stop")
    monkeypatch.setattr(tsf, "learning_rate", stop_at_3)
    with pytest.raises(_Stop):
        tsf.train_synthetic(5, resume_dir=stop, **kw)
    monkeypatch.setattr(tsf, "learning_rate", learning_rate)
    with open(os.path.join(stop, "resume.json")) as f:
        assert json.load(f)["step"] == 2
    resumed = tsf.train_synthetic(5, resume_dir=stop, **kw)

    def stop_recording_4(path, obj):
        if obj["step"] == 4 and obj["pending"] is None:
            raise _Stop
        write_json(path, obj)

    between = str(tmp_path / "between")
    monkeypatch.setattr(tsf, "_write_json", stop_recording_4)
    with pytest.raises(_Stop):
        tsf.train_synthetic(5, resume_dir=between, **kw)
    monkeypatch.setattr(tsf, "_write_json", write_json)
    with open(os.path.join(between, "resume.json")) as f:
        rstate = json.load(f)
    assert (rstate["step"], rstate["pending"]) == (2, 4)
    assert torch.load(os.path.join(between, "resume.pt"), weights_only=True)["step"] == 4
    carried = tsf.train_synthetic(5, resume_dir=between, **kw)
    for run in (resumed, carried):
        assert params_sha256(run.state.network) == params_sha256(straight.state.network)
        assert np.array_equal(run.losses, straight.losses) and len(run.losses) == 5
        assert np.array_equal(run.errors, straight.errors)
        assert run.history == straight.history
    with pytest.raises(RuntimeError, match="other settings"):
        tsf.train_synthetic(6, resume_dir=stop, **kw)
