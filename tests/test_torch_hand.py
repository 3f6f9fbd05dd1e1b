"""PyTorch port vs the JAX package: kinematics, skinning, projection, sampler.

Same numpy inputs (and the same draws, taken from JAX keys) go through both
packages on the CPU. Tolerances: rtol 1e-5 for f32 products whose summation
order differs between the two matmul back ends.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_tpu.data import sampler as jsampler  # noqa: E402
from spherehand_tpu.hand import kinematics as jkin  # noqa: E402
from spherehand_tpu.hand import skinning as jskin  # noqa: E402
from spherehand_torch.data import sampler as tsampler  # noqa: E402
from spherehand_torch.hand import skinning as tskin  # noqa: E402
from spherehand_torch.hand.assets import load_hand_model  # noqa: E402
from spherehand_torch.hand.kinematics import forward_kinematics  # noqa: E402


@pytest.fixture(scope="module")
def port_model():
    return load_hand_model(device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_assets_match_jax(hand_model, port_model):
    for name in ("vertices", "offset_mats", "inv_offset_mats", "skin_matrix",
                 "skin_matrix_faces", "kp_local", "kp_radius"):
        np.testing.assert_array_equal(
            getattr(port_model, name).numpy(), np.asarray(getattr(hand_model, name))
        )
    np.testing.assert_array_equal(port_model.faces.numpy(), np.asarray(hand_model.faces))
    assert port_model.raster_valid_frac == hand_model.raster_valid_frac
    assert port_model.num_faces == 3382 and port_model.num_vertices == 10144


def test_fk_matches_golden_and_jax(hand_model, port_model, goldens):
    g = goldens("fk")
    ours = forward_kinematics(port_model, _t(g["params"])).numpy()
    np.testing.assert_allclose(ours, g["transforms"], atol=2e-4, rtol=1e-5)
    ref = np.asarray(jkin.forward_kinematics(hand_model, jnp.asarray(g["params"])))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_skinning_matches_golden_and_jax(hand_model, port_model, goldens):
    g = goldens("lbs")
    tr_np = g["transforms"]
    tr_t, tr_j = _t(tr_np), jnp.asarray(tr_np)
    kp = tskin.lbs_keypoints(port_model, tr_t).numpy()
    np.testing.assert_allclose(kp, g["keypoints"], atol=2e-3, rtol=1e-5)
    np.testing.assert_allclose(
        kp, np.asarray(jskin.lbs_keypoints(hand_model, tr_j)), atol=1e-4, rtol=1e-5
    )
    mesh = tskin.lbs_mesh(port_model, tr_t).numpy()
    np.testing.assert_allclose(mesh, g["mesh_points"], atol=5e-3, rtol=1e-4)
    faces = tskin.lbs_faces(port_model, tr_t).numpy()
    np.testing.assert_allclose(
        faces, np.asarray(jskin.lbs_faces(hand_model, tr_j)), atol=1e-4, rtol=1e-5
    )
    rand_f = g["rand_f"]
    planes = tskin.project_faces_planes(port_model, tr_t, 640.0, _t(rand_f))
    ref = jskin.project_faces_planes(hand_model, tr_j, 640.0, jnp.asarray(rand_f))
    for ours, theirs in zip(planes, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-3, rtol=1e-5)
    proj = tskin.orthographic_project(_t(g["mesh_points"]), 640.0, _t(rand_f)).numpy()
    np.testing.assert_allclose(proj, g["projected"], atol=2e-3, rtol=1e-5)
    xyz = tskin.orthographic_project_xyz(_t(g["mesh_points"]), 640.0).numpy()
    np.testing.assert_allclose(xyz, g["projected_plain"][..., :3], atol=2e-3, rtol=1e-5)
    back = tskin.inverse_orthographic(_t(g["projected_plain"]), 640.0).numpy()
    np.testing.assert_allclose(back[..., :3], g["mesh_points"][..., :3], atol=5e-3)


def test_random_scale_core_matches_jax(hand_model, port_model, goldens):
    """The scale core fed the uniform draws jax.random makes from the key."""
    g = goldens("lbs")
    key = jax.random.key(3)
    ref = jskin.apply_random_scale(key, jnp.asarray(g["transforms"]), 0.1)
    u = np.asarray(jax.random.uniform(key, (4, 3), jnp.float32))
    ours = tskin.apply_scale(_t(g["transforms"]), _t(u), 0.1).numpy()
    np.testing.assert_array_equal(ours, np.asarray(ref))
    # the draw step: per-axis scales inside [0.85, 0.95)
    gen = torch.Generator().manual_seed(0)
    scaled = tskin.apply_random_scale(gen, _t(g["transforms"]), 0.1)
    ratio = (scaled[:, :, :3] / _t(g["transforms"])[:, :, :3]).nan_to_num(0.9)
    assert float(ratio.min()) >= 0.85 - 1e-5 and float(ratio.max()) < 0.95 + 1e-5


def _jax_pose_draws(key, batch):
    """The draws jax's sample_poses makes from ``key``, in its key order."""
    u = jsampler._u
    keys = jax.random.split(key, 10)
    palm_ranges = ((-3.14, 3.14), (0.0, 3.14), (-3.14, 3.14),
                   (-15.0, 15.0), (-15.0, 15.0), (-35.0, 15.0))
    palm = jnp.stack([u(keys[i], (batch,), lo, hi)
                      for i, (lo, hi) in enumerate(palm_ranges)], axis=-1)
    k_arch, k_mode, k_open, k_close, k_any, k_thumb = jax.random.split(keys[8], 6)
    ks = jax.random.split(k_arch, 8)
    k8, k9, k10 = jax.random.split(ks[7], 3)
    shape = (batch, 4)
    deg = jsampler._DEG
    kt = jax.random.split(k_thumb, 4)
    d = dict(
        palm=palm,
        spread=jax.random.uniform(keys[6], (batch, 1)),
        jitter=u(keys[7], shape, -5 * deg, 5 * deg),
        pert=u(ks[0], shape + (3,), -10 * deg, 10 * deg),
        big=u(ks[1], shape + (3,), 60 * deg, 90 * deg),
        small_tail=u(ks[2], shape + (2,), 5 * deg, 35 * deg),
        half_head=u(ks[3], shape, 0.0, 30 * deg),
        straight=jnp.stack([u(ks[4], shape, -0.25, 0.0), u(ks[5], shape, -0.4, 0.0),
                            u(ks[6], shape, -0.34, 0.0)], axis=-1),
        open_=jnp.stack([u(k8, shape, -0.1, 0.15), u(k9, shape, -0.1, 0.3),
                         u(k10, shape, -0.1, 0.24)], axis=-1),
        mode=jax.random.randint(k_mode, (batch,), 0, 10),
        open_pick=jax.random.randint(k_open, shape, 0, 3),
        close_pick=jax.random.randint(k_close, shape, 3, 5),
        any_pick=jax.random.randint(k_any, shape, 0, 5),
        thumb_bent=jax.random.uniform(kt[0], (batch,)) < 0.5,
        thumb_flex_bent=u(kt[1], (batch,), -0.25, 0.10),
        thumb_flex_open=u(kt[1], (batch,), 0.1, 0.7),
        thumb_abduct=u(kt[2], (batch,), -0.5, 0.5),
        thumb_flex3=u(kt[3], (batch,), -1.7, 0.3),
    )
    return tsampler.PoseDraws(
        **{k: torch.from_numpy(np.array(v)).to(
            torch.int64 if v.dtype == jnp.int32 else None) for k, v in d.items()}
    )


def test_sampler_core_matches_jax():
    key = jax.random.key(77)
    ref = np.asarray(jsampler.sample_poses(key, 64))
    ours = tsampler.mix_poses(_jax_pose_draws(key, 64)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)


def test_sampler_draws_distribution():
    """The torch draw step covers the same ranges as the JAX sampler."""
    poses = tsampler.sample_poses(torch.Generator().manual_seed(1), 4096).numpy()
    ref = np.asarray(jsampler.sample_poses(jax.random.key(1), 4096))
    assert poses.shape == (4096, 26) and np.isfinite(poses).all()
    lo, hi = ref.min(0), ref.max(0)
    span = hi - lo
    assert (poses.min(0) >= lo - 0.05 * span - 1e-6).all()
    assert (poses.max(0) <= hi + 0.05 * span + 1e-6).all()
    assert (np.abs(poses.mean(0) - ref.mean(0)) <= 0.03 * span + 1e-6).all()
    np.testing.assert_allclose(poses.std(0), ref.std(0), rtol=0.1, atol=0.02)
