"""Step 507 of ``test_torch_trajectory.py``'s 600-step case, the second step
where the port's teacher-forced update departs from JAX's (CPU).

Step 507 is epoch 1, iteration 206: outside the ``is_mv`` window (the first
150 iterations of an epoch), so the mutual projection takes its own-view
branch and the consistency term's weight is 0. The state before it, its
inputs and every term of the objective are in
``goldens/torch_mv_step507.npz``, written by ``tests/torch_mv_step132.py
--step 507 --every_term``. Held here:

- the terms of the joints (bone length, collision, consistency, mutual
  projection, pose prior, synthetic depth) of the port against jitted
  JAX's on the same joints, JAX's network's and the port network's, as the
  writer computed them: value within 1e-5 relative, gradient to the joints
  within 2e-5 of its largest entry (``test_torch_mv_rounding.py``'s bars);
  the mutual projection, the geometric terms, the pose prior and the
  synthetic depth computed again here;
- the departure: the two packages' updates 0.0636 apart, 25x JAX's own
  jitted-against-op-by-op distance;
- where it sits: JAX's step with the mutual projection's joints moved to
  the port network's values gives the port's update, and no other term's
  move does; 97.6 % of that term's gradient gap is one joint (sample 0,
  view 1, sphere 15), and the networks' joints, 0.0055 mm apart, flip the
  silhouette of sphere 15 in view 1's own camera at one pixel, (27, 22).

Not a fault of the port: a silhouette flip, as at step 132 (ROADMAP Queue 3
item 8).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_torch.losses import geometric, multiview  # noqa: E402
from spherehand_torch.losses.multitask import LOSS_WEIGHTS  # noqa: E402
from spherehand_torch.models.pose_vae import load_pose_vae_model, prior_loss  # noqa: E402
from spherehand_torch.ops.reduce import bmean  # noqa: E402
from spherehand_torch.render.sphere import render_spheres  # noqa: E402
from spherehand_tpu.losses import geometric as jgeometric  # noqa: E402
from spherehand_tpu.models import pose_vae as jpose_vae  # noqa: E402
from spherehand_tpu.ops.reduce import bmean as jbmean  # noqa: E402
from test_torch_mv_rounding import _jax_mv, _port_mv  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "torch_mv_step507.npz")
ITERS, MV_ITERS = 300, 150  # the slow case's epoch and is_mv window
VALUE_REL, GRAD_REL = 1e-5, 2e-5
JOINT_TERMS = ("bone_length", "collision", "mv_consistency", "mv_projection", "pose_prior",
               "synt_d")
CONTROL_FACTOR = 10.0  # test_torch_trajectory.py's departure rule


@pytest.fixture(scope="module")
def step507():
    return dict(np.load(GOLDEN))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grad(g, name: str, evaluator: str, at: str) -> np.ndarray:
    return np.concatenate([g[f"term_grad_{side}_{name}_{evaluator}_on_{at}"].ravel()
                           for side in ("real", "synt")])


def test_step507_is_outside_the_is_mv_window(step507):
    epoch, it = divmod(int(step507["step"]) - 1, ITERS)
    assert (int(step507["step"]), epoch, it) == (507, 1, 206) and it >= MV_ITERS
    assert not step507["is_mv"]
    assert sorted(step507["term_names"]) == sorted(
        [*JOINT_TERMS, "domain_loss", "synt_uv", "uv_hm_mean"])
    for tag in ("jax", "port"):  # the joints the two spies saw are the same
        assert np.array_equal(step507[f"joints_{tag}"], step507[f"real_joints_{tag}"])


@pytest.mark.parametrize("at", ["jax", "port"])
@pytest.mark.parametrize("name", JOINT_TERMS)
def test_step507_term_is_jax_on_the_same_joints(step507, name, at):
    """The writer's values: the port's term and its gradient to the real
    and synthetic joints against jitted JAX's on the same joints; op-by-op
    JAX within the same bars."""
    want_value, want = step507[f"term_{name}_jax_on_{at}"], _grad(step507, name, "jax", at)
    for evaluator in ("port", "jax_eager"):
        value, got = step507[f"term_{name}_{evaluator}_on_{at}"], _grad(step507, name,
                                                                         evaluator, at)
        assert abs(value - want_value) <= VALUE_REL * abs(want_value), (evaluator, value,
                                                                        want_value)
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * np.abs(want).max(),
                                   err_msg=evaluator)


@pytest.mark.parametrize("joints", ["joints_jax", "joints_port"])
def test_step507_mv_term_computed_again_is_jax(step507, joints):
    """The mutual projection (own-view branch, is_mv off) and its gradient to
    the joints, computed here by both packages on the same joints: as
    ``test_torch_mv_rounding.py`` holds step 132's, and equal to the
    writer's record of each."""
    want_value, want = _jax_mv(step507[joints], step507)
    got_value, got = _port_mv(step507[joints], step507)
    assert abs(got_value - want_value) <= VALUE_REL * abs(want_value), (got_value, want_value)
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * np.abs(want).max())
    at = joints.split("_")[1]
    assert got_value == step507[f"term_mv_projection_port_on_{at}"]


@pytest.mark.parametrize("joints", ["real_joints_jax", "real_joints_port"])
@pytest.mark.parametrize("name", ["collision", "bone_length"])
def test_step507_geometric_term_computed_again_is_jax(step507, name, joints):
    """The view-0 geometric terms on the same joints: the port's value and
    gradient against jitted JAX's."""
    flat = step507[joints].reshape(step507[joints].shape[0], -1, 3)
    jfn = getattr(jgeometric, f"{name}_loss")
    want_value, want = jax.jit(jax.value_and_grad(lambda j: jfn(j)))(jnp.asarray(flat))
    leaf = torch.from_numpy(flat.copy()).requires_grad_(True)
    value = getattr(geometric, f"{name}_loss")(leaf)
    value.backward()
    value = float(value.detach())
    assert abs(value - float(want_value)) <= VALUE_REL * max(abs(float(want_value)), 1e-30)
    want = np.asarray(want)
    np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0,
                               atol=GRAD_REL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("at", ["jax", "port"])
def test_step507_prior_and_synthetic_depth_computed_again_are_jax(step507, at):
    """The pose prior (JAX's VAE on the step's key, the port's on the noise
    its draws took from that key) and the synthetic depth term on the same
    joints, computed here: the port's value and gradient against jitted
    JAX's, and the port's value equal to the writer's record."""
    real, synt = step507[f"real_joints_{at}"], step507[f"synt_joints_{at}"]
    assert np.array_equal(step507["synt_target_xyz"], step507["synt_target_xyz_jax"])
    key = jax.random.split(jax.random.wrap_key_data(step507["prior_key_data"]), 1)[0]
    params = jpose_vae.load_pose_vae_params()
    w_prior, w_pt = LOSS_WEIGHTS["prior"], LOSS_WEIGHTS["synt_pt"]
    target_z = step507["synt_target_xyz"][..., 2]
    jax_terms = {
        "pose_prior": (lambda x: w_prior * jpose_vae.prior_loss(params, x / 100.0, key), real),
        "synt_d": (lambda x: w_pt * jbmean((x[..., 2] - target_z) ** 2, None), synt)}
    vae = load_pose_vae_model(device="cpu")
    noise = torch.from_numpy(step507["vae_noise"])
    port_terms = {
        "pose_prior": lambda x: w_prior * prior_loss(vae, x / 100.0, noise),
        "synt_d": lambda x: w_pt * bmean((x[..., 2] - torch.from_numpy(target_z)) ** 2, None)}
    for name, (jfn, joints) in jax_terms.items():
        want_value, want = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(joints))
        leaf = torch.from_numpy(joints.copy()).requires_grad_(True)
        value = port_terms[name](leaf)
        value.backward()
        value, want = float(value.detach()), np.asarray(want)
        assert abs(value - float(want_value)) <= VALUE_REL * abs(float(want_value)), name
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0,
                                   atol=GRAD_REL * np.abs(want).max(), err_msg=name)
        assert value == np.float32(step507[f"term_{name}_port_on_{at}"]), name


def test_step507_departs_and_the_mv_joints_give_the_port_update(step507):
    """The two packages' updates from JAX's state, 25x JAX's own
    jitted-against-op-by-op distance apart (the slow case's rule: over
    10x). JAX's step with the mutual projection's joints moved to the port
    network's gives the port's update within 1e-2 (4.2e-4), and its own
    does not; moving any other term's joints leaves the gap as it was."""
    forced, port_vs_moved_mv, moved_mv_vs_jax = step507["update_distances"]
    control = float(step507["control_distance"])
    assert forced > CONTROL_FACTOR * control, (forced, control)
    assert port_vs_moved_mv < 1e-2 < moved_mv_vs_jax
    moved = dict(zip(step507["moved_names"], step507["moved_distances"]))
    assert moved["mv_projection"][0] < 1e-2 and moved["all"][0] < 1e-2
    for name, (to_port, _) in moved.items():
        if name not in ("mv_projection", "all"):
            assert abs(to_port - forced) <= 1e-3 * forced, (name, to_port, forced)
    # the term diag agrees: JAX's on the port's joints gives the port's mv
    # gradient norm to the weights (14,493), where its own gives 13,721
    port, jax_own, control_diag = (step507[k] for k in ("diag_port", "diag_jax",
                                                        "diag_jax_on_port_joints"))
    assert abs(port[1] - jax_own[1]) > 0.05 * jax_own[1]
    assert abs(control_diag[1] - port[1]) <= 1e-3 * port[1], (control_diag, port)


def test_step507_gap_is_one_silhouette_pixel(step507):
    """Each package's mv gradient on its own network's joints differs by
    5.5 % in norm, 97.6 % of it at one joint (sample 0, view 1, sphere 15);
    the two sets of joints, 0.0055 mm apart, change the depth field's
    silhouette at two pixels, of which the own-view branch reads one: sphere
    15 of sample 0's view 1 in its own camera at (v, u) = (27, 22). (The
    other, sphere 14 in view 0's camera at (32, 22), is a cross-view pixel
    that only the is_mv branch reads.)"""
    assert np.abs(step507["joints_port"] - step507["joints_jax"]).max() < 0.006
    gap = step507["mv_grad_port"] - step507["mv_grad_jax"]
    assert 0.05 < np.linalg.norm(gap) / np.linalg.norm(step507["mv_grad_jax"]) < 0.06
    assert np.linalg.norm(gap[0, 1, 15]) > 0.97 * np.linalg.norm(gap)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    mats = multiview.mutual_transforms(t(step507["poses"]), t(step507["inv_poses"]))
    inside = [render_spheres(multiview.apply_rigid(mats, t(step507[j])[:, :, None]),
                             t(step507["radii"]), 64) != 100.0
              for j in ("joints_jax", "joints_port")]
    flips = (inside[0] != inside[1]).nonzero().tolist()
    assert flips == [[0, 1, 0, 14, 32, 22], [0, 1, 1, 15, 27, 22]], flips
    assert [f for f in flips if f[1] == f[2]] == [[0, 1, 1, 15, 27, 22]]
