"""The port's loss stack vs the JAX package and the goldens.

Tolerances: values within rtol 1e-5 of JAX where both compute the same
float32 arithmetic in another summation order, and the goldens' own bounds
(tests/test_render_losses.py, tests/test_priors.py) against the goldens.
On the CPU both packages take their unfused mutual-projection path (the
port's plain per-field versions); the fused form, which the card takes, is
held to it in tests/test_torch_sphere_ops.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_tpu.data import noise as jnoise  # noqa: E402
from spherehand_tpu.losses import geometric as jgeo  # noqa: E402
from spherehand_tpu.losses import multitask as jmt  # noqa: E402
from spherehand_tpu.losses import multiview as jmv  # noqa: E402
from spherehand_tpu.models import estimator as jest  # noqa: E402
from spherehand_tpu.models import pose_vae as jvae  # noqa: E402
from spherehand_tpu.ops import reduce as jreduce  # noqa: E402
from spherehand_torch.data import noise  # noqa: E402
from spherehand_torch.losses import geometric, multitask, multiview  # noqa: E402
from spherehand_torch.models import estimator  # noqa: E402
from spherehand_torch.models.pose_vae import load_pose_vae_model, prior_loss  # noqa: E402
from spherehand_torch.ops import reduce  # noqa: E402
from spherehand_torch.ops.softargmax import heatmap_variance  # noqa: E402
from spherehand_tpu.ops import softargmax as jsoft  # noqa: E402

WEIGHTS = np.asarray([1.0, 0.0], np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(ours, ref, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(ours.detach()), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def vae():
    return load_pose_vae_model(device="cpu")


def _jax_row_noise(key, rows):
    """The normals JAX's PoseVae draws from ``key``, one fold_in per row."""
    keys = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(rows))
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (32,), jnp.float32))(keys))


@pytest.mark.parametrize("weights", [None, WEIGHTS[[0, 0, 1]]])
def test_reductions_match_jax(weights):
    x = np.random.RandomState(0).uniform(-2, 2, (3, 4, 5)).astype(np.float32)
    w = None if weights is None else torch.from_numpy(weights)
    jw = None if weights is None else jnp.asarray(weights)
    (tx,) = _t(x)
    _close(reduce.bmean(tx, w), jreduce.bmean(jnp.asarray(x), jw))
    _close(reduce.bsum(tx, w), jreduce.bsum(jnp.asarray(x), jw))
    _close(reduce.bmean_keep(tx, w, (2,)), jreduce.bmean_keep(jnp.asarray(x), jw, (2,)))


@pytest.mark.parametrize("is_mv, key", [(True, "mv_loss"), (False, "sv_loss")])
def test_mutual_projection_matches_golden(goldens, is_mv, key):
    g = goldens("multiview")
    radii = goldens("sphere_render")["radii_41"]
    loss, proj = multiview.mutual_projection_loss(
        *_t(g["poses"], g["inv_poses"], g["joints"], g["dms"], radii), is_mv=is_mv)
    _close(proj, g["projected_dms"], rtol=1e-5, atol=1e-2)
    _close(loss, g[key], rtol=2e-4)


@pytest.mark.parametrize("is_mv", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_mutual_projection_matches_jax(goldens, is_mv, weighted):
    """Value and joint gradient against the JAX loss (its XLA path on CPU)."""
    g = goldens("multiview")
    radii = goldens("sphere_render")["radii_41"]
    w = WEIGHTS if weighted else None
    args = (g["poses"], g["inv_poses"], g["joints"], g["dms"], radii)

    def jloss(joints):
        a = [jnp.asarray(x) for x in args]
        a[2] = joints
        return jmv.mutual_projection_loss(
            *a, is_mv=is_mv, weights=None if w is None else jnp.asarray(w))[0]

    ref, g_ref = jax.value_and_grad(jloss)(jnp.asarray(g["joints"]))
    tp, ti, tj, td, tr = _t(*args)
    leaf = tj.requires_grad_(True)
    loss, _ = multiview.mutual_projection_loss(
        tp, ti, leaf, td, tr, is_mv=is_mv, weights=None if w is None else torch.from_numpy(w))
    loss.backward()
    _close(loss, ref, rtol=1e-5)
    scale = float(np.abs(np.asarray(g_ref)).max())
    _close(leaf.grad, g_ref, rtol=0.0, atol=2e-5 * scale)


def test_consistency_matches_golden_and_jax(goldens):
    g = goldens("multiview")
    loss = multiview.multiview_consistency_loss(*_t(g["poses"], g["joints"]))
    _close(loss, g["consistency"], rtol=1e-4)
    ref = jmv.multiview_consistency_loss(jnp.asarray(g["poses"]), jnp.asarray(g["joints"]),
                                         weights=jnp.asarray(WEIGHTS))
    ours = multiview.multiview_consistency_loss(*_t(g["poses"], g["joints"], WEIGHTS))
    _close(ours, ref)


def test_multiview_extras_match_golden_and_jax(goldens):
    """``weighted_multiview_consistency_loss``, ``fuse_mv_pose`` and
    ``heatmap_variance`` against the torch-reference golden
    ``multiview_extras.npz`` (its bounds in tests/test_multiview_extras.py:
    rtol 1e-5; fused joints rtol 1e-4, atol 1e-3) and against JAX (rtol
    1e-5; the fused joints pick the same views, so within 1e-4 mm)."""
    g = goldens("multiview_extras")
    poses, inv, joints, hm_w, uv_hm = _t(g["poses"], g["inv_poses"], g["joints"],
                                         g["hm_weight"], g["uv_hm"])
    j = {k: jnp.asarray(g[k]) for k in ("poses", "inv_poses", "joints", "hm_weight", "uv_hm")}
    loss = multiview.weighted_multiview_consistency_loss(poses, joints, hm_w)
    _close(loss, g["weighted_consistency"])
    _close(loss, jmv.weighted_multiview_consistency_loss(j["poses"], j["joints"], j["hm_weight"]))
    fused = multiview.fuse_mv_pose(joints, poses, inv, uv_hm)
    _close(fused, g["fused_joints"], rtol=1e-4, atol=1e-3)
    _close(fused, jmv.fuse_mv_pose(j["joints"], j["poses"], j["inv_poses"], j["uv_hm"]),
           rtol=0.0, atol=1e-4)
    _close(heatmap_variance(uv_hm), jsoft.heatmap_variance(j["uv_hm"]))


def test_fuse_mv_pose_takes_the_sharpest_view_and_passes_no_gradient_to_heatmaps():
    """The behaviour tests/test_multiview_extras.py pins: a peaked view wins
    every joint; the heatmap weight is detached."""
    rng = np.random.RandomState(1)
    joints = torch.from_numpy(rng.uniform(-50, 50, (2, 3, 41, 3)).astype(np.float32))
    poses = torch.eye(4).expand(2, 3, 4, 4)
    hms = torch.from_numpy(np.random.RandomState(2).uniform(0, 1, (2, 3, 41, 16, 16)).astype(
        np.float32))
    hms[:, 1, :, 8, 8] = 50.0
    hms.requires_grad_(True)
    fused = multiview.fuse_mv_pose(joints, poses, poses, hms)
    _close(fused[:, 0], joints[:, 1], rtol=0.0, atol=1e-4)
    assert not fused.requires_grad


def test_geometric_losses_match_golden_and_jax(goldens):
    g = goldens("geometric_losses")
    (joints,) = _t(g["joints"])
    _close(geometric.collision_loss(joints), g["collision"], rtol=1e-5)
    _close(geometric.bone_length_loss(joints), g["bone_length"], rtol=1e-4)
    w = np.asarray([1, 0, 1, 1, 0], np.float32)
    jj, jw = jnp.asarray(g["joints"]), jnp.asarray(w)
    (tw,) = _t(w)
    _close(geometric.collision_loss(joints, weights=tw), jgeo.collision_loss(jj, weights=jw))
    _close(geometric.bone_length_loss(joints, weights=tw), jgeo.bone_length_loss(jj, weights=jw))


def test_pose_vae_matches_golden(goldens, vae):
    g = goldens("pose_vae")
    with torch.no_grad():
        recon, mu, logvar, likelihood = vae(*_t(g["x"]))
    for ours, key in ((mu, "mu"), (logvar, "logvar"), (recon, "recon")):
        _close(ours, g[key], rtol=1e-4, atol=1e-4)
    _close(likelihood, g["likelihood"], rtol=1e-4)


@pytest.mark.parametrize("weighted", [False, True])
def test_prior_loss_matches_jax_with_same_noise(goldens, vae, weighted):
    x = goldens("pose_vae")["x"]
    key = jax.random.key(4)
    w = np.asarray([1, 1, 0, 1, 0, 1], np.float32) if weighted else None
    ref = jvae.prior_loss(jvae.load_pose_vae_params(), jnp.asarray(x), key,
                          weights=None if w is None else jnp.asarray(w))
    noise_t, x_t = _t(_jax_row_noise(key, x.shape[0]), x)
    ours = prior_loss(vae, x_t, noise_t, weights=None if w is None else torch.from_numpy(w))
    _close(ours, ref, rtol=1e-5)


def test_resize_crop_bit_identical_to_jax():
    rng = np.random.RandomState(2)
    dms = rng.uniform(0.2, 1.0, (6, 64, 64)).astype(np.float32)
    u = np.asarray([1.0, 0.7, 0.93, 0.75, 0.81, 1.0], np.float32)
    v = np.asarray([1.0, 0.72, 0.9, 0.99, 0.7, 0.8], np.float32)
    ref = np.asarray(jnoise.resize_crop(jnp.asarray(dms), jnp.asarray(u), jnp.asarray(v)))
    ours = noise.resize_crop(*_t(dms, u, v)).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_resize_scale_core_matches_jax_draws(seed):
    """The scale core fed the uniforms JAX's sample_resize_scales draws."""
    key = jax.random.key(seed)
    n = 7
    k_coin, k_base, k_u, k_v = jax.random.split(key, 4)
    draws = noise.ResizeDraws(*_t(
        jax.random.uniform(k_coin, ()),
        *(jnoise._rowwise_uniform(k, (n, 1))[:, 0] for k in (k_base, k_u, k_v))))
    ref_u, ref_v = jnoise.sample_resize_scales(key, n)
    u, v = noise.resize_scales(draws)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ref_u))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))


def test_resize_scale_draws_by_distribution():
    gen = torch.Generator().manual_seed(0)
    coins = []
    for _ in range(200):
        u, v = noise.sample_resize_scales(gen, 5)
        identity = bool((u == 1.0).all() and (v == 1.0).all())
        coins.append(identity)
        if not identity:
            assert float(u.min()) >= 0.7 and float(u.max()) < 1.0
            assert float((u - v).abs().max()) < 0.1
    assert 0.35 < np.mean(coins) < 0.65


def test_temporal_smoothness_matches_jax():
    rng = np.random.RandomState(3)
    joints = rng.uniform(-10, 10, (4, 3, 41, 3)).astype(np.float32)
    prev = rng.uniform(-10, 10, (3, 41, 3)).astype(np.float32)
    for has_prev in (False, True):
        ref, ref_prev, _ = jmt.temporal_smoothness(
            jnp.asarray(joints), jnp.asarray(prev), jnp.asarray(has_prev))
        loss, new_prev, flag = multitask.temporal_smoothness(
            *_t(joints, prev), torch.tensor(has_prev))
        _close(loss, ref)
        np.testing.assert_array_equal(new_prev.numpy(), np.asarray(ref_prev))
        assert bool(flag)


def _random_outputs(rng, stacks=2, bs=3, br=2, views=3):
    """The same estimator outputs for both packages (latents NHWC / NCHW)."""
    f = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    a = {
        "synt_uv": [f(bs, 41, 16, 16) for _ in range(stacks)],
        "synt_d": [f(bs, 41, 16, 16) for _ in range(stacks)],
        "synt_xyz": [f(bs, 41, 3) * 60 for _ in range(stacks)],
        "real_uv": [f(br, views, 41, 16, 16) for _ in range(stacks)],
        "real_d": [f(br, views, 41, 16, 16) for _ in range(stacks)],
        "real_xyz": [f(br, views, 41, 3) * 60 for _ in range(stacks)],
        "synt_lat": [f(bs, 4, 4, 8) for _ in range(stacks)],
        "real_lat": [f(br * views, 4, 4, 8) for _ in range(stacks)],
    }
    j = jest.EstimatorOutput(
        *(tuple(jnp.asarray(x) for x in a[k]) for k in
          ("synt_uv", "synt_d", "synt_xyz", "real_uv", "real_d", "real_xyz")),
        None, tuple(jnp.asarray(x) for x in a["synt_lat"]),
        tuple(jnp.asarray(x) for x in a["real_lat"]))
    tt = lambda k, perm=None: tuple(  # noqa: E731
        torch.from_numpy(x if perm is None else np.ascontiguousarray(x.transpose(perm)))
        for x in a[k])
    t = estimator.EstimatorOutput(
        synt_uv_hms=tt("synt_uv"), synt_d_hms=tt("synt_d"), synt_xyz=tt("synt_xyz"),
        real_uv_hms=tt("real_uv"), real_d_hms=tt("real_d"), real_xyz=tt("real_xyz"),
        real_resized_dms=None, synt_latent=tt("synt_lat", (0, 3, 1, 2)),
        real_latent=tt("real_lat", (0, 3, 1, 2)))
    return j, t


@pytest.mark.parametrize("is_mv", [True, False])
def test_multitask_loss_term_by_term(goldens, hand_model, vae, is_mv):
    """Every term on the same outputs, targets and prior noise, two stacks,
    temporal on: rtol 1e-5, and 2e-4 for the
    mutual-projection term (fused against the unfused XLA path, the bound
    the golden holds both to)."""
    rng = np.random.RandomState(11)
    j_out, t_out = _random_outputs(rng)
    g = goldens("multiview")
    real = {"real_dms": g["dms"], "camera_poses": g["poses"], "inv_camera_poses": g["inv_poses"]}
    synt = {k: rng.uniform(0, 1, s).astype(np.float32)
            for k, s in (("uv_hms", (3, 41, 16, 16)), ("xyz", (3, 41, 3)))}
    key = jax.random.key(5)
    prev = rng.uniform(-10, 10, (3, 41, 3)).astype(np.float32)

    class JSynt:
        uv_hms = jnp.asarray(synt["uv_hms"])
        xyz = jnp.asarray(synt["xyz"])

    class TSynt:
        uv_hms, xyz = _t(synt["uv_hms"], synt["xyz"])

    cfg = jmt.LossConfig(temporal=True)
    j_terms, _, _ = jmt.multitask_loss(
        cfg, j_out, hand_model.kp_radius, vae_params=jvae.load_pose_vae_params(),
        synt_target=JSynt, real_target={k: jnp.asarray(v) for k, v in real.items()},
        rng=key, is_mv=is_mv, prev_skel=jnp.asarray(prev), has_prev=jnp.asarray(True))
    noise_t = tuple(torch.from_numpy(np.array(_jax_row_noise(k, 6))) for k in jax.random.split(key, 2))
    t_terms, projected, (new_prev, _) = multitask.multitask_loss(
        multitask.LossConfig(temporal=True), t_out, torch.from_numpy(np.asarray(hand_model.kp_radius)),
        vae=vae, synt_target=TSynt, real_target={k: torch.from_numpy(v) for k, v in real.items()},
        vae_noise=noise_t, is_mv=is_mv, prev_skel=torch.from_numpy(prev),
        has_prev=torch.tensor(True))
    assert sorted(t_terms) == sorted(j_terms)
    for name, ref in j_terms.items():
        _close(t_terms[name], ref, rtol=2e-4 if name == "mv_projection" else 1e-5, atol=1e-6)
    assert len(projected) == 2 and projected[0].shape == (2, 3, 3, 64, 64)
    np.testing.assert_array_equal(new_prev.numpy(), np.asarray(j_out.real_xyz[-1][-1]))
    total = multitask.combine_loss(t_terms)
    _close(total, jmt.combine_loss(j_terms), rtol=2e-4)
