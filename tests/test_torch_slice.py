"""The slice end to end: synthetic render -> serving, port vs JAX on the CPU.

The port's synthesizer core takes the draws JAX's ``synthesize`` makes from
its key (RNG rule), and the port's ``PoseEstimator`` serves the same crops
as JAX's ``PoseEstimator(precision="highest")``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_tpu.data.noise import depth_pixel_noise  # noqa: E402
from spherehand_tpu.data.sampler import sample_poses  # noqa: E402
from spherehand_tpu.data.synthesizer import synthesize as jsynthesize  # noqa: E402
from spherehand_tpu.infer import PoseEstimator as JPoseEstimator  # noqa: E402
from spherehand_tpu.infer import load_params_npz as jload_params  # noqa: E402
from spherehand_torch.data.noise import PixelNoiseDraws, apply_pixel_noise  # noqa: E402
from spherehand_torch.data.sampler import sample_poses as tsample_poses  # noqa: E402
from spherehand_torch.data.synthesizer import (  # noqa: E402
    SynthesisDraws,
    synthesize,
    synthesize_from_draws,
)
from spherehand_torch.hand.assets import load_hand_model  # noqa: E402
from spherehand_torch.hand.kinematics import forward_kinematics  # noqa: E402
from spherehand_torch.infer import PoseEstimator, load_params_npz  # noqa: E402
from spherehand_torch.render.heatmap import render_heatmaps, render_joint_heatmaps  # noqa: E402
from spherehand_torch.render import raster_cuda  # noqa: E402

PARAMS = os.path.join(os.path.dirname(__file__), "..", "assets", "pretrained",
                      "synthetic_params.npz")
B = 4


def _jax_synthesis_draws(key, batch):
    """The draws jax's ``synthesize`` makes from ``key``, in its key order."""
    k_scale, k_focal, k_noise = jax.random.split(key, 3)
    kx, ky, kz = jax.random.split(k_noise, 3)
    shape = (batch, 64, 64)

    def t(a):
        return torch.from_numpy(np.array(a))

    return SynthesisDraws(
        scale_u=t(jax.random.uniform(k_scale, (batch, 3), jnp.float32)),
        rand_f=t(jax.random.uniform(k_focal, (batch,), jnp.float32, 0.9, 1.1)),
        noise=PixelNoiseDraws(*(t(jax.random.normal(k, shape)) for k in (kx, ky, kz))),
    )


@pytest.fixture(scope="module")
def batches(hand_model):
    poses = np.array(sample_poses(jax.random.key(123456), B))
    key = jax.random.key(2)
    ref = jax.jit(lambda k, p: jsynthesize(hand_model, k, p, add_noise=True))(
        key, jnp.asarray(poses))
    port = load_hand_model(device="cpu")
    raster_cuda.reset_launch_counts()
    ours = synthesize_from_draws(port, torch.from_numpy(poses), _jax_synthesis_draws(key, B))
    assert raster_cuda.LAUNCHES == {"raster_fast_pooled": 0, "raster_fast": 0, "raster_exact": 0}
    return ref, ours


def test_synthesize_matches_jax(batches):
    ref, ours = batches
    assert ours.dms.shape == (B, 64, 64) and ours.xyz.shape == (B, 41, 3)
    d_mm = np.abs(ours.dms.numpy() - np.asarray(ref.dms)) * 100.0
    # the render's compiled-oracle contract (see test_torch_raster.py)
    assert np.median(d_mm) == 0.0 and (d_mm > 1.0).mean() < 1e-3
    np.testing.assert_allclose(ours.xyz.numpy(), np.asarray(ref.xyz), atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(ours.uv_hms.numpy(), np.asarray(ref.uv_hms), atol=1e-5)
    np.testing.assert_allclose(ours.d_hms.numpy(), np.asarray(ref.d_hms), atol=1e-5)


def test_serving_matches_jax_and_gt(batches):
    """Same crops through both estimators: joints within 1e-2 mm; the port's
    error against the GT joints under the 25 mm bound of test_infer.py."""
    ref, ours = batches
    crops = ours.dms.numpy() * 100.0
    est = PoseEstimator(load_params_npz(PARAMS), num_stacks=1, denoise=True,
                        precision="highest", device="cpu")
    joints = est.predict(crops)
    jest = JPoseEstimator(jload_params(PARAMS), num_stacks=1, denoise=True, precision="highest")
    np.testing.assert_allclose(joints, jest.predict(crops), atol=1e-2)
    err = np.linalg.norm(joints - ours.xyz.numpy(), axis=-1).mean()
    assert err < 25.0, f"port error {err:.1f} mm"
    adjusted = est.predict(crops, palm_adjust=True)
    np.testing.assert_allclose(adjusted[:, 11:], joints[:, 11:], atol=1e-5)
    j2, hms = est.predict_with_heatmaps(crops)
    np.testing.assert_array_equal(j2, joints)
    assert hms.shape == (B, 41, 16, 16)


def test_chunked_serving_matches_monolithic():
    """serve_chunk chunking and its ragged-tail padding change no sample."""
    params = load_params_npz(PARAMS)
    rng = np.random.RandomState(3)
    dms = np.full((5, 64, 64), 100.0, np.float32)
    dms[:, 20:44, 20:44] = rng.uniform(20, 60, (5, 24, 24))
    mono = PoseEstimator(params, serve_chunk=8, device="cpu").predict(dms)
    chunked = PoseEstimator(params, serve_chunk=2, device="cpu").predict(dms)
    np.testing.assert_allclose(chunked, mono, atol=1e-4)


def test_synthesize_draw_step():
    """The generator-driven entry point: shapes, ranges, determinism."""
    port = load_hand_model(device="cpu")
    poses = tsample_poses(torch.Generator().manual_seed(5), 2)
    a = synthesize(port, torch.Generator().manual_seed(7), poses)
    b = synthesize(port, torch.Generator().manual_seed(7), poses)
    np.testing.assert_array_equal(a.dms.numpy(), b.dms.numpy())
    fg = a.dms < 0.99
    assert fg.any() and torch.isfinite(a.dms).all()
    assert float(a.dms.max()) <= 1.0 + 0.3  # background 1.0 (noise only on foreground)


def test_pixel_noise_core_matches_jax():
    """The noise core fed the normals jax's depth_pixel_noise draws."""
    rng = np.random.RandomState(8)
    dms = np.ones((3, 64, 64), np.float32)
    dms[:, 10:50, 12:40] = rng.uniform(0.2, 0.9, (3, 40, 28))
    key = jax.random.key(9)
    ref = np.asarray(depth_pixel_noise(key, jnp.asarray(dms)))
    draws = _jax_synthesis_draws(jax.random.key(0), 3)._replace(
        noise=PixelNoiseDraws(*(torch.from_numpy(np.array(jax.random.normal(k, dms.shape)))
                                for k in jax.random.split(key, 3))))
    ours = apply_pixel_noise(torch.from_numpy(dms), draws.noise).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_heatmaps_match_golden(goldens):
    g = goldens("heatmap_render")
    uv, d = render_heatmaps(torch.from_numpy(g["uvd"]), 16)
    np.testing.assert_allclose(uv.numpy(), g["uv_hms"], atol=1e-5)
    np.testing.assert_allclose(d.numpy(), g["d_hms"], atol=1e-5)
    port = load_hand_model(device="cpu")
    uv, d, xyz = render_joint_heatmaps(
        port, torch.from_numpy(g["transforms"]), 16, torch.from_numpy(g["rand_f"]))
    np.testing.assert_allclose(uv.numpy(), g["hand_uv_hms"], atol=2e-3)
    np.testing.assert_allclose(d.numpy(), g["hand_d_hms"], atol=2e-3)
    np.testing.assert_allclose(xyz.numpy(), g["hand_xyz"], atol=2e-3, rtol=1e-4)
