"""The port's view transforms and mutual projection against the JAX package's
at the level of single roundings (CPU).

- ``mutual_transforms`` and ``apply_rigid`` give op-by-op JAX's bits in
  float32 on the CPU: XLA sums a transform entry's four products pairwise,
  (p0 + p1) + (p2 + p3), and rotates a point by a chain of fused
  multiply-adds, fma(x2, r2, fma(x1, r1, x0 r0)), then adds the
  translation; jitted JAX gives the same bits at these shapes. Held on
  seeded inputs at the trajectory test's shapes (2 x 3 views) and the
  engine's (25 x 3), and on the inputs of the mutual projection at step 132
  of ``test_torch_trajectory.py``'s 600-step case
  (``goldens/torch_mv_step132.npz``, written by ``tests/torch_mv_step132.py``).
- At those inputs, the port's mv term and its gradient with respect to the
  joints against jitted JAX's on the same joints (JAX's network's, the
  port network's); the one joint and the one pixel that carry the gap
  between the packages on their own joints; the record's control (JAX on
  the port's joints gives the port's gradient and update).
- The depth field's silhouette rule ``sq > 1e-2``: a pixel whose ``sq`` is
  one float32 step above or below 1e-2 falls on the same side in both
  packages, with the same gradient.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_torch.losses import multiview  # noqa: E402
from spherehand_torch.losses.multitask import LOSS_WEIGHTS  # noqa: E402
from spherehand_torch.render.sphere import render_spheres  # noqa: E402
from spherehand_tpu.losses import multiview as jmv  # noqa: E402
from spherehand_tpu.render.sphere import render_spheres as jrender_spheres  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "torch_mv_step132.npz")
W_MV = LOSS_WEIGHTS["mv_projection"]


def _poses(rng, batch: int, views: int = 3):
    """Camera poses as the pseudo-NYU writer leaves them: a rotation, the
    translation in row [3, :3] and a small one in column [:3, 3]; and their
    float32 inverses."""
    angles = rng.normal(size=(batch, views, 3))
    poses = np.zeros((batch, views, 4, 4), np.float32)
    for idx in np.ndindex(batch, views):
        theta = np.linalg.norm(angles[idx])
        k = angles[idx] / theta
        cross = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        poses[idx][:3, :3] = np.eye(3) + np.sin(theta) * cross + (1 - np.cos(theta)) * cross @ cross
    poses[..., 3, :3] = rng.normal(size=(batch, views, 3)) * 50
    poses[..., :3, 3] = rng.normal(size=(batch, views, 3)) * 1e-3
    poses[..., 3, 3] = 1
    return poses, np.linalg.inv(poses).astype(np.float32)


def _jax_transforms(poses, inv, joints):
    """Op-by-op JAX: the transforms, the projected joints and the canonical
    joints (``apply_rigid`` of the poses, as the consistency loss takes)."""
    with jax.disable_jit():
        mats = jmv.mutual_transforms(jnp.asarray(poses), jnp.asarray(inv))
        projected = jmv.apply_rigid(mats, jnp.asarray(joints)[:, :, None])
        canonical = jmv.apply_rigid(jnp.asarray(poses), jnp.asarray(joints))
    return np.asarray(mats), np.asarray(projected), np.asarray(canonical)


def _port_transforms(poses, inv, joints):
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    mats = multiview.mutual_transforms(t(poses), t(inv))
    return (mats.numpy(), multiview.apply_rigid(mats, t(joints)[:, :, None]).numpy(),
            multiview.apply_rigid(t(poses), t(joints)).numpy())


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and np.array_equal(np.asarray(a).view(np.uint32),
                                                 np.asarray(b).view(np.uint32))


@pytest.mark.parametrize("batch,seed", [(2, 0), (2, 1), (2, 2), (2, 3), (25, 4)])
def test_view_transforms_are_op_by_op_jax_bits(batch, seed):
    rng = np.random.default_rng(seed)
    poses, inv = _poses(rng, batch)
    joints = (rng.normal(size=(batch, 3, 41, 3)) * 60).astype(np.float32)
    want, got = _jax_transforms(poses, inv, joints), _port_transforms(poses, inv, joints)
    for name, w, g in zip(("mutual_transforms", "apply_rigid (projected)",
                           "apply_rigid (canonical)"), want, got):
        assert _same_bits(g, w), (name, int((g != w).sum()), g.size)


def test_fma_rounds_once():
    """``multiview._fma`` against the exact product and sum, rounded to
    float32 with numpy from exact rationals, on cancelling sums (the hard
    case for a product and a sum rounded in float64 before float32)."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    a = rng.normal(size=4000).astype(np.float32)
    b = rng.normal(size=4000).astype(np.float32)
    c = (-(a.astype(np.float64) * b).astype(np.float32)
         + (rng.normal(size=4000) * 1e-7).astype(np.float32))
    got = multiview._fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf))]
        # nearest, ties to the even significand
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.uint32)) & 1))
        assert got[i] == best, (i, a[i], b[i], c[i], got[i], best)


@pytest.fixture(scope="module")
def step132():
    return dict(np.load(GOLDEN))


def _inputs(g):
    weights = None if np.isnan(g["weights"]).any() else g["weights"]
    return g["poses"], g["inv_poses"], g["real_dms"], g["radii"], bool(g["is_mv"]), weights


def test_step132_transforms_are_op_by_op_jax_bits(step132):
    poses, inv = step132["poses"], step132["inv_poses"]
    for joints in ("joints_jax", "joints_port"):
        want = _jax_transforms(poses, inv, step132[joints])
        got = _port_transforms(poses, inv, step132[joints])
        for w, g in zip(want, got):
            assert _same_bits(g, w), (joints, int((g != w).sum()), g.size)


def _jax_mv(joints, g):
    poses, inv, real, radii, is_mv, weights = _inputs(g)

    def term(j):
        return W_MV * jmv.mutual_projection_loss(
            jnp.asarray(poses), jnp.asarray(inv), j, jnp.asarray(real), jnp.asarray(radii),
            is_mv=is_mv, weights=None if weights is None else jnp.asarray(weights))[0]

    value, grad = jax.jit(jax.value_and_grad(term))(jnp.asarray(joints))
    return float(value), np.asarray(grad)


def _port_mv(joints, g):
    poses, inv, real, radii, is_mv, weights = _inputs(g)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    leaf = t(joints).requires_grad_(True)
    value = W_MV * multiview.mutual_projection_loss(
        t(poses), t(inv), leaf, t(real), t(radii), is_mv=is_mv,
        weights=None if weights is None else t(weights))[0]
    value.backward()
    return float(value.detach()), leaf.grad.numpy()


@pytest.mark.parametrize("joints", ["joints_jax", "joints_port"])
def test_step132_mv_gradient_is_jax_on_the_same_joints(step132, joints):
    """The mv term and its gradient to the joints at step 132's inputs, on
    JAX's network's joints and on the port network's: the port against
    jitted JAX on the same joints, value within 1e-5 relative and the
    gradient within 2e-5 of its largest element (the bounds of
    ``test_torch_losses.py``'s mutual projection case; measured 1.8e-6 and
    3.2e-6 of the gradient's norm, against 3.1e-6 between jitted and op-by-op
    JAX on JAX's joints: the square root's gradient and the sums round in
    other orders)."""
    want_value, want = _jax_mv(step132[joints], step132)
    got_value, got = _port_mv(step132[joints], step132)
    assert abs(got_value - want_value) <= 1e-5 * abs(want_value), (got_value, want_value)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_step132_gap_is_one_silhouette_pixel(step132):
    """Each package's mv gradient on its own network's joints (the record)
    differs by 13.8 % in norm; 99.99 % of that gap sits at one joint
    (sample 0, view 1, sphere 13), and the two sets of joints, 0.00226 mm
    apart, change the depth field's silhouette at one pixel only: sphere 13
    of sample 0's view 1 in its own camera at (v, u) = (44, 38)."""
    gap = step132["mv_grad_port"] - step132["mv_grad_jax"]
    assert 0.1 < np.linalg.norm(gap) / np.linalg.norm(step132["mv_grad_jax"]) < 0.2
    assert np.linalg.norm(gap[0, 1, 13]) > 0.999 * np.linalg.norm(gap)
    poses, inv, _, radii, _, _ = _inputs(step132)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    mats = multiview.mutual_transforms(t(poses), t(inv))
    inside = [render_spheres(multiview.apply_rigid(mats, t(step132[j])[:, :, None]), t(radii),
                             64) != 100.0 for j in ("joints_jax", "joints_port")]
    flips = (inside[0] != inside[1]).nonzero().tolist()
    assert flips == [[0, 1, 1, 13, 44, 38]], flips


def test_step132_control_jax_on_the_port_joints_gives_the_port_gradient(step132):
    """The record's control (``tests/torch_mv_step132.py``): JAX's term diag
    with the mv term's joints moved to the port network's values gives the
    port's mv gradient norm to the weights (20,573, where JAX's own is
    15,071) within 1e-3, and JAX's step on them the port's update within 1e-2
    (the teacher-forced distance of the two packages is 0.19)."""
    port, jax_own = step132["diag_port"], step132["diag_jax"]
    control = step132["diag_jax_on_port_joints"]
    assert abs(port[1] - jax_own[1]) > 0.3 * jax_own[1]
    assert abs(control[1] - port[1]) <= 1e-3 * port[1], (control, port)
    forced, port_vs_control, control_vs_jax = step132["update_distances"]
    assert forced > 0.1 and port_vs_control < 1e-2 < control_vs_jax, step132["update_distances"]


# The silhouette rule at one pixel: sq = (r*r - dx*dx) - dy*dy at pixel (v, u)
# = (32, 40) of a 64 x 64 map (x_grid 37.5 mm, y_grid 0), r = 8 mm; the
# centres' (x, y) that put sq one float32 step above and one below 1e-2.
SILHOUETTE = {"above": (29.501251, -0.100097604), "below": (29.501253, -0.10024994)}


@pytest.mark.parametrize("side", ["above", "below"])
def test_silhouette_pixel_takes_the_same_side_with_the_same_gradient(side):
    x, y = (np.float32(v) for v in SILHOUETTE[side])
    f32 = np.float32
    dx, dy = f32(f32(37.5) - x), f32(f32(0.0) - y)
    sq = f32(f32(f32(64.0) - f32(dx * dx)) - f32(dy * dy))
    assert sq == np.nextafter(f32(1e-2), f32(1.0 if side == "above" else 0.0))
    center = np.array([[x, y, 40.0]], np.float32)
    radius = np.array([8.0], np.float32)
    pick = np.zeros((1, 64, 64), np.float32)
    pick[0, 32, 40] = 1.0
    with jax.disable_jit():
        depth, vjp = jax.vjp(lambda c: jrender_spheres(c, jnp.asarray(radius), 64),
                             jnp.asarray(center))
        (jgrad,) = vjp(jnp.asarray(pick))
    leaf = torch.from_numpy(center).requires_grad_(True)
    ours = render_spheres(leaf, torch.from_numpy(radius), 64)
    ours.backward(torch.from_numpy(pick))
    assert _same_bits(ours.detach().numpy(), np.asarray(depth))
    inside = float(ours.detach()[0, 32, 40]) != 100.0
    assert inside == (side == "above")
    grad = leaf.grad.numpy()
    np.testing.assert_allclose(grad, np.asarray(jgrad), rtol=1e-6, atol=0)
    # inside, the pixel moves the centre by about (x_grid - x) / sqrt(sq)
    assert (abs(grad[0, 0]) > 70.0) == inside
