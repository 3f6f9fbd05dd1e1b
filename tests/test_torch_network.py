"""PyTorch port vs the JAX package: hourglass, soft-argmax, denoiser, weights."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spherehand_tpu.evaluation import metrics as jmetrics  # noqa: E402
from spherehand_tpu.infer import load_params_npz as jload_params  # noqa: E402
from spherehand_tpu.models import estimator as jestimator  # noqa: E402
from spherehand_tpu.models.hourglass import HourglassNet as JHourglassNet  # noqa: E402
from spherehand_tpu.models.hourglass import convert_torch_state  # noqa: E402
from spherehand_torch.convert import (  # noqa: E402
    flatten_params,
    hourglass_state_dict,
    load_denoiser,
    load_hourglass,
)
from spherehand_torch.evaluation import metrics  # noqa: E402
from spherehand_torch.infer import load_params_npz  # noqa: E402
from spherehand_torch.models import estimator  # noqa: E402
from spherehand_torch.models.hourglass import HourglassNet  # noqa: E402
from spherehand_torch.models.pose_denoiser import PoseDenoiser, load_pose_denoiser  # noqa: E402
from spherehand_torch.ops.softargmax import recover_xyz  # noqa: E402

PARAMS = os.path.join(os.path.dirname(__file__), "..", "assets", "pretrained",
                      "synthetic_params.npz")
DENOISER = os.path.join(os.path.dirname(__file__), "..", "assets", "pose_denoiser.npz")


def test_hourglass_matches_torch_golden(goldens):
    """Two stacks, the reference's random-weight golden, carried into the
    port through the JAX package's flax layout (as the shipped weights are)."""
    g = goldens("hourglass")
    flax_params = convert_torch_state({k: g[k] for k in g.files if "/" in k}, num_stacks=2)
    net = load_hourglass(HourglassNet(num_stacks=2), flax_params).eval()
    with torch.no_grad():
        scores, latents = net(torch.from_numpy(g["x"]))
    np.testing.assert_allclose(scores[0].numpy(), g["out0"], atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(scores[1].numpy(), g["out1"], atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(latents[0].numpy(), g["latent0"], atol=2e-3, rtol=1e-3)


def test_hourglass_matches_jax_with_shipped_weights():
    """One stack, ``synthetic_params.npz`` through both packages."""
    params = load_params_npz(PARAMS)
    net = load_hourglass(HourglassNet(num_stacks=1), params).eval()
    x = np.random.RandomState(0).uniform(0.2, 1.0, (2, 64, 64)).astype(np.float32)
    with torch.no_grad():
        scores, latents = net(torch.from_numpy(x))
    ref_s, ref_l = JHourglassNet(num_stacks=1).apply({"params": jload_params(PARAMS)}, jnp.asarray(x))
    np.testing.assert_allclose(
        scores[0].numpy(), np.asarray(ref_s[0]).transpose(0, 3, 1, 2), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        latents[0].numpy(), np.asarray(ref_l[0]).transpose(0, 3, 1, 2), atol=1e-4, rtol=1e-4)


def test_conversion_consumes_every_key_and_sets_every_parameter():
    params = load_params_npz(PARAMS)
    flat = flatten_params(params)
    assert len(flat) == 146
    state = hourglass_state_dict(params)
    net = HourglassNet(num_stacks=1)
    assert set(state) == set(net.state_dict())
    assert len(state) == len(flat)
    # a stray source array or a missing module parameter is refused
    params["stray"] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(ValueError, match="unused"):
        load_hourglass(HourglassNet(num_stacks=1), params)
    del params["stray"]
    with pytest.raises(ValueError, match="missing"):
        load_hourglass(HourglassNet(num_stacks=2), params)
    arrays = dict(np.load(DENOISER))
    arrays.pop("network/6/bias")
    with pytest.raises(ValueError, match="missing"):
        load_denoiser(PoseDenoiser(), arrays)


def test_recover_xyz_matches_golden(goldens):
    g = goldens("softargmax")
    xyz = recover_xyz(torch.from_numpy(g["uv_hms"]), torch.from_numpy(g["d_hms"])).numpy()
    np.testing.assert_allclose(xyz, g["xyz"], atol=2e-3, rtol=1e-4)


def test_denoiser_matches_golden(goldens):
    g = goldens("pose_denoiser")
    den = load_pose_denoiser(device="cpu")
    with torch.no_grad():
        out = den(torch.from_numpy(g["joints"])).numpy()
    np.testing.assert_allclose(out, g["denoised"], atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(out[:, 11:], g["joints"][:, 11:])
    raw = np.load(DENOISER)
    np.testing.assert_array_equal(den.input_indices.numpy(), raw["input_indices"])
    np.testing.assert_array_equal(den.output_indices.numpy(), raw["output_indices"])


def test_estimator_forward_matches_jax():
    """Both branches of the eval forward: a synthetic batch and a real
    multi-view batch share one hourglass pass."""
    params = load_params_npz(PARAMS)
    rng = np.random.RandomState(4)
    crops = np.ones((5, 64, 64), np.float32)  # scaled depth, background 1.0
    crops[:, 20:44, 20:44] = rng.uniform(0.2, 0.6, (5, 24, 24))
    synt, real = crops[:2], crops[2:].reshape(1, 3, 64, 64)
    net = load_hourglass(estimator.make_network(1), params).eval()
    with torch.no_grad():
        ours = estimator.forward(net, torch.from_numpy(synt), torch.from_numpy(real))
    ref = jestimator.forward(jestimator.make_network(1), jload_params(PARAMS),
                             synt_dms=jnp.asarray(synt), real_dms=jnp.asarray(real))
    for name in ("synt_uv_hms", "synt_d_hms", "synt_xyz", "real_uv_hms", "real_d_hms",
                 "real_xyz"):
        a, b = getattr(ours, name)[-1].numpy(), np.asarray(getattr(ref, name)[-1])
        assert a.shape == b.shape, name
        # Heatmaps: f32 summation order. Joints (mm): flax's GroupNorm takes
        # the one-pass variance E[x^2] - E[x]^2, PyTorch's the two-pass one;
        # on these hand-less blobs soft-argmax magnifies that to ~2e-2 mm
        # (rendered hands hold 1e-2 mm, tests/test_torch_slice.py).
        atol = 5e-2 if name.endswith("xyz") else 1e-3
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-4, err_msg=name)
    assert ours.synt_latent[0].shape == (2, 256, 4, 4)
    assert ours.real_latent[0].shape == (3, 256, 4, 4)


def test_metrics_match_jax():
    rng = np.random.RandomState(6)
    gt = rng.uniform(-80, 80, (5, 36, 3)).astype(np.float32)
    est = rng.uniform(-80, 80, (5, 41, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(metrics.average_joint_error(torch.from_numpy(gt), torch.from_numpy(est))),
        float(jmetrics.average_joint_error(jnp.asarray(gt), jnp.asarray(est))), rtol=1e-6)
    per = metrics.per_joint_error(torch.from_numpy(gt), torch.from_numpy(est)).numpy()
    np.testing.assert_allclose(
        per, np.asarray(jmetrics.per_joint_error(jnp.asarray(gt), jnp.asarray(est))), rtol=1e-6)
    for a, b in zip(metrics.max_error_curve(per), jmetrics.max_error_curve(per)):
        np.testing.assert_array_equal(a, b)
