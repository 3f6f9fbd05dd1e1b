"""The port's train steps on the CPU: gradient and Adam-step parity with the
reference golden, the synthetic step, init statistics, the pseudo-real
batch and the configuration, against the JAX package."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_tpu.data.sampler import sample_poses as jsample_poses  # noqa: E402
from spherehand_tpu.data.synthesizer import synthesize as jsynthesize  # noqa: E402
from spherehand_tpu.models.estimator import make_network as jmake_network  # noqa: E402
from spherehand_tpu.models.hourglass import convert_torch_state  # noqa: E402
from spherehand_tpu.train.config import EngineConfig as JEngineConfig  # noqa: E402
from spherehand_torch.convert import flax_arrays, train_state_from_params  # noqa: E402
from spherehand_torch.data import pseudo_real  # noqa: E402
from spherehand_torch.data.synthesizer import SyntheticBatch  # noqa: E402
from spherehand_torch.hand.assets import load_hand_model  # noqa: E402
from spherehand_torch.hand.kinematics import forward_kinematics  # noqa: E402
from spherehand_torch.render.raster import render_depth_64  # noqa: E402
from spherehand_torch.train.config import EngineConfig  # noqa: E402
from spherehand_torch.train.steps import RealBatch, StepDraws, build_steps  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def port_hand():
    return load_hand_model(device="cpu")


def test_combined_grads_and_adam_step_match_golden(goldens, hand_model, port_hand):
    """One ``combined_grads`` plus one Adam step from the golden's init on
    its combined batch (synthetic half made by the JAX ``synthesize`` and
    handed in), against the reference torch stack's golden, with the
    tolerances of tests/test_grad_parity.py: terms < 2e-3 relative and the
    total < 1e-4 (f32 summation order; collision sits on a clamp edge),
    gradient norms within 5 % and first-16 slices within 10 % + 2e-3 of the
    norm (f32 rounding through GroupNorm, measured by that test's f64
    cross-check), post-Adam elements within 2.5 lr (one Adam step moves an
    element by about lr)."""
    sys.path.insert(0, ROOT)
    from tools import grad_parity_ab as ab

    gold = goldens("grad_parity_ab")
    params0 = convert_torch_state(dict(goldens("grad_parity_init")), num_stacks=1)
    poses = jsample_poses(jax.random.PRNGKey(ab.POSE_SEED), ab.SYNT_B)
    synt = jax.tree.map(np.asarray, jsynthesize(hand_model, jax.random.PRNGKey(ab.SYNT_SEED), poses))
    real_dms = np.asarray(gold["real_dms"], np.float32)
    real_poses = np.asarray(gold["real_poses"], np.float32)
    assert ab.digest(synt.dms, real_dms, real_poses) == bytes(gold["input_digest"]).decode()

    cfg = EngineConfig(prior=False, synt_batch=ab.SYNT_B, real_batch=ab.REAL_B,
                       lr=ab.LR, weight_decay=ab.WEIGHT_DECAY)
    fns = build_steps(cfg, hand=port_hand)
    state = train_state_from_params(fns.init_state, params0)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    batch = RealBatch(t(real_dms), torch.zeros(ab.REAL_B, 3, 36, 3), t(real_poses),
                      t(gold["real_inv_poses"]))
    synt_t = SyntheticBatch(*(t(a) for a in synt))
    loss, terms, grads = fns.combined_grads(
        state, StepDraws(None, None, None, None), batch, True, real_aug=False, synt=synt_t)

    for key in gold.files:
        if key.startswith("term_"):
            name = key[len("term_"):]
            ref = float(gold[key])
            assert abs(float(terms[name]) - ref) / max(abs(ref), 1e-12) < 2e-3, (name, ref)
    assert abs(float(loss) - float(gold["loss_total"])) / abs(float(gold["loss_total"])) < 1e-4

    for group in state.optimizer.param_groups:
        group["lr"] = ab.LR
    state.optimizer.step()
    flat_g = flax_arrays(grads)
    flat_p = flax_arrays(dict(state.network.named_parameters()))
    checked = 0
    for k in sorted(flat_g):
        safe = k.replace("/", ".")
        gnorm_t = float(gold[f"gnorm_{safe}"])
        gslice_t = np.asarray(gold[f"gslice_{safe}"], np.float64)
        g = flat_g[k].astype(np.float64).reshape(-1)
        p = flat_p[k].astype(np.float64).reshape(-1)
        assert abs(np.linalg.norm(g) - gnorm_t) <= 0.05 * gnorm_t + 1e-9, k
        d = np.linalg.norm(g[: gslice_t.size] - gslice_t)
        assert d <= 0.1 * np.linalg.norm(gslice_t) + 2e-3 * gnorm_t, k
        pslice_t = np.asarray(gold[f"pslice_{safe}"], np.float64)
        assert np.abs(p[: pslice_t.size] - pslice_t).max() <= 2.5 * ab.LR, k
        checked += 1
    assert checked == sum(1 for f in gold.files if f.startswith("gnorm_"))


def test_synt_step_trains_on_cpu(port_hand):
    cfg = EngineConfig(synt_batch=2, real_batch=1)
    fns = build_steps(cfg, hand=port_hand)
    gen = torch.Generator().manual_seed(0)
    state = fns.init_state(gen)
    before = {k: v.clone() for k, v in state.network.state_dict().items()}
    losses = []
    for _ in range(3):
        state, metrics = fns.synt_step(state, 1e-3, fns.draw(gen, real=False))
        assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
        losses.append(float(metrics["loss"]))
    assert state.step == 3
    moved = [k for k, v in state.network.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)
    assert sorted(metrics) == ["loss", "synt_d", "synt_joint_err", "synt_uv"]


def test_real_combined_and_eval_steps_on_cpu(port_hand):
    cfg = EngineConfig(synt_batch=2, real_batch=2, temporal=True, eval_precision="highest")
    fns = build_steps(cfg, hand=port_hand)
    gen = torch.Generator().manual_seed(1)
    state = fns.init_state(gen)
    batch = RealBatch(*pseudo_real.render_multiview_batch(port_hand, gen, 2)[:4])
    state, m1, vis = fns.combined_step(state, 1e-3, fns.draw(gen), batch, False)
    assert float(m1["mv_consistency"]) == 0.0 and bool(state.has_prev)
    assert vis["synt_dms"].shape == (2, 64, 64) and vis["real_xyz"].shape == (2, 3, 41, 3)
    state, m2, _ = fns.real_step(state, 1e-3, fns.draw(gen, synt=False), batch)
    draws = fns.draw(gen, synt=False)
    metrics, denoised = fns.eval_step(state, draws, batch)
    for m in (m1, m2, metrics):
        assert all(bool(torch.isfinite(v)) for v in m.values()), m
    assert state.step == 2 and denoised.shape == (2, 41, 3)
    assert "pose_prior" in metrics and "avg_joint_error_raw" in metrics
    # the eval step carries no temporal state: the train state's skeleton
    # (carried since the combined step) does not reach its metrics
    assert bool(state.has_prev)
    state.prev_skel = state.prev_skel + 50.0
    again, _ = fns.eval_step(state, draws, batch)
    assert all(torch.equal(again[k], v) for k, v in metrics.items())


def _jax_row_noise(key, rows):
    """The normals JAX's PoseVae draws from ``key``, one fold_in per row."""
    keys = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(rows))
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (32,), jnp.float32))(keys))


def test_eval_step_temporal_term_is_within_batch_like_jax(goldens, hand_model, port_hand):
    """With ``temporal`` on, ``eval_step``'s terms equal JAX's
    ``multitask_loss`` given a zero ``prev_skel`` and ``has_prev`` False
    (the form that needs no state; JAX's own eval step passes none) on the
    same estimator outputs, real batch and prior noise, with the tolerances
    of tests/test_torch_losses.py (rtol 1e-5, 2e-4 for the mutual
    projection); and they stay the same bits whatever skeleton the train
    state carries, where a carried skeleton would move the temporal term."""
    from spherehand_tpu.losses import multitask as jmt
    from spherehand_tpu.models import estimator as jest
    from spherehand_tpu.models import pose_vae as jvae
    from spherehand_torch.constants import Constants
    from spherehand_torch.infer import float32_precision
    from spherehand_torch.models.estimator import forward

    rng = np.random.RandomState(21)
    g = goldens("multiview")
    dms, poses, inv = (np.asarray(g[k], np.float32) for k in ("dms", "poses", "inv_poses"))
    batch_n, views = dms.shape[:2]
    gt = rng.uniform(-60, 60, (batch_n, views, 36, 3)).astype(np.float32)
    cfg = EngineConfig(synt_batch=2, real_batch=batch_n, temporal=True, eval_precision="highest")
    fns = build_steps(cfg, hand=port_hand)
    state = fns.init_state(torch.Generator().manual_seed(5))
    batch = RealBatch(*(torch.from_numpy(a) for a in (dms, gt, poses, inv)))
    key = jax.random.key(8)
    noise = _jax_row_noise(jax.random.split(key, 1)[0], batch_n * views)
    draws = StepDraws(None, None, None, (torch.from_numpy(noise.copy()),))
    metrics, _ = fns.eval_step(state, draws, batch)

    with torch.no_grad(), float32_precision("highest"):
        out = forward(state.network, real_dms=batch.dms * Constants().depth_scale)
    real = [tuple(jnp.asarray(x.numpy()) for x in getattr(out, k))
            for k in ("real_uv_hms", "real_d_hms", "real_xyz")]
    j_out = jest.EstimatorOutput((), (), (), *real, None, (), ())
    target = {"real_dms": jnp.asarray(dms), "camera_poses": jnp.asarray(poses),
              "inv_camera_poses": jnp.asarray(inv)}

    def jax_terms(prev, has_prev):
        terms, _, _ = jmt.multitask_loss(
            jmt.LossConfig(temporal=True), j_out, hand_model.kp_radius,
            vae_params=jvae.load_pose_vae_params(), real_target=target, rng=key,
            is_mv=jnp.asarray(True), prev_skel=jnp.asarray(prev), has_prev=jnp.asarray(has_prev))
        return terms

    ref = jax_terms(np.zeros((views, 41, 3), np.float32), False)
    assert sorted(ref) == sorted(k for k in metrics if not k.startswith("avg_joint_error"))
    for name, value in ref.items():
        np.testing.assert_allclose(np.asarray(metrics[name]), np.asarray(value), atol=1e-6,
                                   rtol=2e-4 if name == "mv_projection" else 1e-5)

    carried = rng.uniform(-50, 50, (views, 41, 3)).astype(np.float32)
    state.prev_skel, state.has_prev = torch.from_numpy(carried), torch.tensor(True)
    again, _ = fns.eval_step(state, draws, batch)
    assert all(torch.equal(again[k], v) for k, v in metrics.items())
    moved = jax_terms(carried, True)["temporal_smooth"]
    assert abs(float(moved) - float(ref["temporal_smooth"])) > 1e-3 * abs(float(moved))


def test_eval_and_real_steps_draw_for_the_batch_they_are_given(hand_model, port_hand):
    """``draw(real_rows=)`` sizes the resize and prior-noise draws by the
    batch a step is given: at ``eval_batch`` 2 with ``real_batch`` 3, the
    eval and real-only steps run on 2 x 3 rows (sized by ``real_batch``,
    the noise was 9 rows and the prior raised on the shape), and their terms
    equal JAX's ``multitask_loss`` on the same estimator outputs, real batch
    and prior noise, at the tolerances of
    ``test_eval_step_temporal_term_is_within_batch_like_jax``."""
    from spherehand_tpu.losses import multitask as jmt
    from spherehand_tpu.models import estimator as jest
    from spherehand_tpu.models import pose_vae as jvae
    from spherehand_torch.constants import Constants
    from spherehand_torch.data.noise import resize_scales
    from spherehand_torch.models.estimator import forward

    cfg = EngineConfig(synt_batch=2, real_batch=3, eval_batch=2, eval_precision="highest")
    fns = build_steps(cfg, hand=port_hand)
    gen = torch.Generator().manual_seed(12)
    state = fns.init_state(gen)
    real = pseudo_real.render_multiview_batch(port_hand, gen, cfg.eval_batch)
    batch = RealBatch(*real[:4])
    rows = cfg.eval_batch * 3
    assert fns.draw(gen).resize.base.shape[0] == cfg.real_batch * 3
    draws = fns.draw(gen, synt=False, real_rows=rows)
    assert draws.poses is None and draws.resize.base.shape[0] == rows
    assert [n.shape for n in draws.vae_noise] == [(rows, 32)]
    key = jax.random.key(13)
    noise = _jax_row_noise(jax.random.split(key, 1)[0], rows)
    draws = draws._replace(vae_noise=(torch.from_numpy(noise.copy()),))
    target = {"real_dms": jnp.asarray(real.dms.numpy()),
              "camera_poses": jnp.asarray(real.poses.numpy()),
              "inv_camera_poses": jnp.asarray(real.inv_poses.numpy())}

    def jax_terms(scales):
        with torch.no_grad():
            out = forward(state.network, real_dms=batch.dms * Constants().depth_scale,
                          scales=scales)
        parts = [tuple(jnp.asarray(x.numpy()) for x in getattr(out, k))
                 for k in ("real_uv_hms", "real_d_hms", "real_xyz")]
        terms, _, _ = jmt.multitask_loss(
            jmt.LossConfig(), jest.EstimatorOutput((), (), (), *parts, None, (), ()),
            hand_model.kp_radius, vae_params=jvae.load_pose_vae_params(), real_target=target,
            rng=key, is_mv=jnp.asarray(True), prev_skel=jnp.zeros((3, 41, 3)),
            has_prev=jnp.asarray(False))
        return terms

    checks = [(fns.eval_step(state, draws, batch)[0], jax_terms(None))]
    ref_real = jax_terms(resize_scales(draws.resize))
    state, metrics, _ = fns.real_step(state, 1e-3, draws, batch)
    checks.append((metrics, ref_real))
    assert state.step == 1
    for ours, ref in checks:
        assert set(ref) <= set(ours)
        for name, value in ref.items():
            np.testing.assert_allclose(np.asarray(ours[name]), np.asarray(value), atol=1e-6,
                                       rtol=2e-4 if name == "mv_projection" else 1e-5)


def test_init_matches_jax_initialisers_by_distribution():
    """Conv kernels U(+-sqrt(1/fan_in)) like flax variance_scaling(1/3,
    fan_in, uniform): per-layer std within 10 % of the JAX init's (layers of
    at least 4096 weights), every weight inside the bound, biases 0 and
    GroupNorm 1 / 0 as in JAX."""
    fns = build_steps(EngineConfig(prior=False), hand=load_hand_model(device="cpu"))
    state = fns.init_state(torch.Generator().manual_seed(0))
    ours = flax_arrays(dict(state.network.named_parameters()))
    ref_tree = jmake_network(1).init(jax.random.key(0), jnp.zeros((1, 64, 64)))["params"]
    ref = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    assert sorted(ours) == sorted(ref)
    for k, w in ours.items():
        assert w.shape == ref[k].shape, k
        if k.endswith("kernel"):
            limit = np.sqrt(1.0 / np.prod(w.shape[:3]))
            assert np.abs(w).max() <= limit, k
            if w.size >= 4096:
                assert abs(w.std() / ref[k].std() - 1.0) < 0.1, k
        else:
            np.testing.assert_array_equal(w, ref[k])


def test_pseudo_real_views_follow_the_recipe(hand_model, port_hand):
    """The camera ring equals tools/selfsup_demo.py's, view 0 is the plain
    render, and each view's transforms are the recipe's F R^T F product."""
    sys.path.insert(0, ROOT)
    from tools import selfsup_demo

    np.testing.assert_array_equal(pseudo_real.camera_rotations(), selfsup_demo.camera_rotations())
    gen = torch.Generator().manual_seed(2)
    from spherehand_torch.data.sampler import sample_poses

    tr = forward_kinematics(port_hand, sample_poses(gen, 2))
    per_view = pseudo_real.view_transforms(port_hand, tr)
    np.testing.assert_array_equal(per_view[:, 0].numpy(), tr.numpy())
    rots = selfsup_demo.camera_rotations()
    flip = np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
    for v in range(3):
        rot4 = np.eye(4, dtype=np.float32)
        rot4[:3, :3] = flip @ rots[v].T @ flip
        ref = np.einsum("ij,bkjl->bkil", rot4, tr.numpy())
        np.testing.assert_allclose(per_view[:, v].numpy(), ref, atol=1e-5)
    dms, joints, poses, inv, kps = pseudo_real.render_multiview_batch(port_hand, gen, 1)
    assert dms.shape == (1, 3, 64, 64) and joints.shape == (1, 3, 36, 3)
    np.testing.assert_allclose((poses @ inv).numpy(), np.tile(np.eye(4), (1, 3, 1, 1)), atol=1e-6)
    assert float(dms.max()) == 100.0 and float((dms < 99).float().mean()) > 0.05
    np.testing.assert_array_equal(
        render_depth_64(port_hand, per_view[:, 0]).numpy().shape, (2, 64, 64))


def test_config_matches_jax():
    for kwargs in ({}, {"prior": False, "temporal": True, "epoch": 9, "lr": 3e-4}):
        ours, ref = EngineConfig(**kwargs), JEngineConfig(**kwargs)
        assert vars(ours.loss_config) == vars(ref.loss_config)
        assert ours.with_real == ref.with_real
        assert [ours.lr_at_epoch(e) for e in range(12)] == [ref.lr_at_epoch(e) for e in range(12)]
    for field in ("real_batch", "synt_batch", "num_stacks", "weight_decay", "lr"):
        assert getattr(EngineConfig(), field) == getattr(JEngineConfig(), field)


def test_build_steps_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_steps(EngineConfig())
