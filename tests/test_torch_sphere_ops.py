"""The port's per-field sphere ops and the loss functions built on them vs the
JAX package.

``sphere_min_depth`` and ``d2m_nearest`` (render/sphere_cuda.py) take their
plain versions on the CPU. They are held against:

- the JAX package's XLA fields op by op (``jax.disable_jit``): bit for bit;
- its Pallas kernels in interpret mode (as tests/test_sphere_pallas.py runs
  them on the CPU, compiled by XLA with contracted FMAs and its own
  ``rsqrt``): at the tolerances stated in each test;
- the gradient of the JAX XLA fields (``jax.grad``): 1e-5 of the largest
  entry, and the VJP of the Pallas ops: 1e-4 of the largest entry, the bound
  test_sphere_pallas.py holds those ops to against the XLA fields.

``data_to_model_distance``, ``mutual_projection`` and the unfused
``mutual_projection_loss`` (the branch the CPU now runs, as the JAX package
does) are held against JAX and the goldens ``sphere_render.npz`` and
``multiview.npz``; the fused and unfused branches against each other.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_tpu.losses import multiview as jmv  # noqa: E402
from spherehand_tpu.render import sphere as jsphere  # noqa: E402
from spherehand_tpu.render import sphere_pallas as jpallas  # noqa: E402
from spherehand_torch.losses import multiview  # noqa: E402
from spherehand_torch.render import sphere as tsphere  # noqa: E402
from spherehand_torch.render import sphere_cuda as sc  # noqa: E402
from spherehand_torch.render.adversarial import (  # noqa: E402
    sphere_adversarial_case,
    sphere_edge_case,
)

N, J, S = 3, 41, 64


def _fixture(seed=7, n=N):
    """Centres, radii, observed maps and two cotangents at the scales of
    tests/test_sphere_pallas.py."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-80, 80, (n, J, 3)).astype(np.float32)
    radii = rng.uniform(4, 12, (J,)).astype(np.float32)
    z = np.full((n, S, S), 100.0, np.float32)
    z[:, 16:48, 16:48] = rng.uniform(-60, 60, (n, 32, 32))
    w = rng.uniform(-1, 1, (2, n, S, S)).astype(np.float32)
    return centers, radii, z, w


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_depth_field(centers, radii):
    return jnp.min(jsphere.render_spheres(
        centers, jnp.broadcast_to(radii, centers.shape[:-1]), S), axis=-3)


def _jax_d2m_field(centers, radii, z):
    """The nearest-surface field of JAX ``data_to_model_distance`` (its XLA
    path, without the clip-and-mean epilogue)."""
    xg, yg = jsphere._mm_grid(S, S, jnp.float32)
    p_sq = xg * xg + yg * yg + z * z
    cx, cy, cz = (centers[..., k, None, None] for k in range(3))
    pdc = xg * cx + yg * cy + z[..., None, :, :] * cz
    c_sq = jnp.sum(centers * centers, axis=-1)[..., None, None]
    sq = jnp.maximum(p_sq[..., None, :, :] - 2.0 * pdc + c_sq, 1e-6)
    dist = jnp.abs(jnp.sqrt(sq) - radii[..., None, None])
    return jnp.min(jnp.where((z > 99.0)[..., None, :, :], 0.0, dist), axis=-3)


def _grad(fn, centers, cotangent):
    leaf = torch.from_numpy(centers).requires_grad_(True)
    (fn(leaf) * torch.from_numpy(cotangent)).sum().backward()
    return leaf.grad.numpy()


def _assert_plain_fields_equal_jax(centers, radii, z):
    """The plain fields against the XLA fields op by op (jax.disable_jit):
    bit for bit, NaN at the same pixels. Returns the distance field."""
    tc, tr, tz = _t(centers, radii, z)
    with jax.disable_jit():
        ref_d = _jax_depth_field(jnp.asarray(centers), jnp.asarray(radii))
        ref_m = _jax_d2m_field(jnp.asarray(centers), jnp.asarray(radii), jnp.asarray(z))
    np.testing.assert_array_equal(sc.min_depth_primal_plain(tc, tr, S).numpy(), np.asarray(ref_d))
    ours_m = sc.d2m_primal_plain(tz, tc, tr, S).numpy()
    np.testing.assert_array_equal(ours_m, np.asarray(ref_m))
    return ours_m


def test_plain_fields_bit_identical_to_op_by_op_jax():
    centers, radii, z, _ = _fixture()
    _assert_plain_fields_equal_jax(centers, radii, z)


def test_edge_case_plain_fields_equal_op_by_op_jax():
    """The same on the edge inputs (``adversarial.sphere_edge_case``: discs
    at a tile's edge, depth >= 100 behind an uncovered sphere, observations
    of 99.0 and NaN, an all-foreground view), each view pair against its
    gathered observation."""
    centers, target, radii = sphere_edge_case()
    z = sc.gathered_target(torch.from_numpy(target), centers.shape[0], 3).numpy()
    ours_m = _assert_plain_fields_equal_jax(centers, radii, z)
    assert np.isnan(ours_m).sum() == np.isnan(z).sum() > 0


def test_plain_planes_match_pallas_interpret():
    """The residual planes against ``_min_depth_fwd`` / ``_d2m_fwd`` in
    interpret mode. Fields within the atol test_sphere_pallas.py holds the
    kernels to (1e-4 depth, 1e-3 distance); argmins equal on all but 1e-4 of
    the pixels (a contracted FMA can flip a near-tie); weights where the
    argmins agree within rtol 1e-4 (depth: XLA's rsqrt against 1/sqrt) and
    1e-3 (distance: the contracted raw), the distance weight compared off
    background only (the TPU kernel leaves it there, the port zeroes it)."""
    centers, radii, z, _ = _fixture()
    tc, tr, tz = _t(centers, radii, z)
    jd, (_, jamin_d, jw_d) = jpallas._min_depth_fwd(jnp.asarray(centers), jnp.asarray(radii), S,
                                                    True)
    jm, (_, _, jamin_m, jw_m) = jpallas._d2m_fwd(jnp.asarray(z), jnp.asarray(centers),
                                                 jnp.asarray(radii), S, True)
    depth, amind, wd = sc.min_depth_fwd_plain(tc, tr, S)
    dist, aminm, wm = sc.d2m_fwd_plain(tz, tc, tr, S)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jm), atol=1e-3)
    foreground = z <= 99.0
    for ours, ref, w_ours, w_ref, rtol, where in ((amind, jamin_d, wd, jw_d, 1e-4, True),
                                                  (aminm, jamin_m, wm, jw_m, 1e-3, foreground)):
        ref = np.asarray(ref).reshape(N, S, S)
        same = ours.numpy() == ref
        assert 1.0 - same.mean() <= 1e-4
        keep = same & where
        np.testing.assert_allclose(w_ours.numpy()[keep], np.asarray(w_ref).reshape(N, S, S)[keep],
                                   rtol=rtol, atol=1e-12)
    assert float(wm.numpy()[~foreground].max()) == 0.0 == float(wm.numpy()[~foreground].min())


@pytest.mark.parametrize("field", ["depth", "distance"])
def test_gradients_match_jax(field):
    """The op's backward (the plain backward on the CPU) against jax.grad of
    the XLA field (1e-5 of the largest entry), the Pallas op's VJP in
    interpret mode (1e-4; measured 1.7e-5 for depth, the XLA rsqrt of its
    weight plane) and torch autograd through the plain primal field (1e-5)."""
    centers, radii, z, w = _fixture()
    tr, tz = _t(radii, z)
    jr, jz = jnp.asarray(radii), jnp.asarray(z)
    if field == "depth":
        port, primal = (lambda c: sc.sphere_min_depth(c, tr, S),
                        lambda c: sc.min_depth_primal_plain(c, tr, S))
        xla, pallas = (lambda c: _jax_depth_field(c, jr),
                       lambda c: jpallas.sphere_min_depth(c, jr, S, True))
    else:
        port, primal = (lambda c: sc.d2m_nearest(tz, c, tr, S),
                        lambda c: sc.d2m_primal_plain(tz, c, tr, S))
        xla, pallas = (lambda c: _jax_d2m_field(c, jr, jz),
                       lambda c: jpallas.d2m_nearest(jz, c, jr, S, True))
    g = _grad(port, centers, w[0])
    for ref_fn, bound in ((xla, 1e-5), (pallas, 1e-4)):
        ref = np.asarray(jax.grad(lambda c, f=ref_fn: jnp.sum(w[0] * f(c)))(jnp.asarray(centers)))
        np.testing.assert_allclose(g, ref, atol=bound * np.abs(ref).max())
    auto = _grad(primal, centers, w[0])
    np.testing.assert_allclose(g, auto, atol=1e-5 * np.abs(auto).max())


def test_primal_route_equals_residual_route_and_no_gradient_to_data():
    """Without autograd the primal plain versions run; their fields equal the
    residual route's bit for bit. Depth maps and radii get no gradient."""
    centers, radii, z, _ = _fixture()
    tc, tr, tz = _t(centers, radii, z)
    with torch.no_grad():
        d0 = sc.sphere_min_depth(tc.clone().requires_grad_(True), tr, S)
        m0 = sc.d2m_nearest(tz, tc.clone().requires_grad_(True), tr, S)
    leaf = tc.clone().requires_grad_(True)
    tz.requires_grad_(True)
    tr.requires_grad_(True)
    d1 = sc.sphere_min_depth(leaf, tr, S)
    m1 = sc.d2m_nearest(tz, leaf, tr, S)
    assert d0.grad_fn is None and m0.grad_fn is None
    assert d1.grad_fn is not None and m1.grad_fn is not None
    np.testing.assert_array_equal(d0.numpy(), d1.detach().numpy())
    np.testing.assert_array_equal(m0.numpy(), m1.detach().numpy())
    (d1.sum() + m1.sum()).backward()
    assert tz.grad is None and tr.grad is None and leaf.grad is not None


@pytest.mark.parametrize("case", ["random", "adversarial"])
def test_fused_op_equals_per_field_ops(case):
    """The counterpart of test_sphere_pallas.py:161-189: the fused op's planes
    equal the per-field ops' bit for bit (fields, argmins and weights, with
    the (B, V, V) target read in place), and its summed gradient matches
    the sum of theirs within 2e-5 of the largest entry."""
    if case == "random":
        centers, radii, z, w = _fixture()
        target, views = z, 1
    else:
        centers, target, radii = sphere_adversarial_case()
        views = 3
        w = np.random.RandomState(1).uniform(-1, 1, (2, centers.shape[0], S, S)).astype(np.float32)
    tc, tt, tr = _t(centers, target, radii)
    z = sc.gathered_target(tt, tc.shape[0], views)
    fused = sc.fused_fwd_plain(tc, tt, tr, S, views)
    depth = sc.min_depth_fwd_plain(tc, tr, S)
    dist = sc.d2m_fwd_plain(z, tc, tr, S)
    for ours, ref in zip(fused, (depth[0], dist[0], depth[1], depth[2], dist[1], dist[2])):
        assert torch.equal(ours, ref)
    w1, w2 = w[0], np.roll(w[1], 1, axis=-1)
    g_sep = (_grad(lambda c: sc.sphere_min_depth(c, tr, S), centers, w1)
             + _grad(lambda c: sc.d2m_nearest(z, c, tr, S), centers, w2))
    leaf = tc.clone().requires_grad_(True)
    d, m = sc.sphere_min_depth_and_d2m(leaf, tt, tr, S, views)
    ((d * torch.from_numpy(w1)).sum() + (m * torch.from_numpy(w2)).sum()).backward()
    np.testing.assert_allclose(leaf.grad.numpy(), g_sep, atol=2e-5 * np.abs(g_sep).max())


def test_tie_rule_gives_lowest_j_per_field():
    """On the adversarial set the duplicate spheres (1, 3) win no argmin and
    get no gradient in either per-field op."""
    centers, target, radii = sphere_adversarial_case()
    tc, tt, tr = _t(centers, target, radii)
    z = sc.gathered_target(tt, tc.shape[0], 3)
    _, amind, _ = sc.min_depth_fwd_plain(tc, tr, S)
    _, aminm, _ = sc.d2m_fwd_plain(z, tc, tr, S)
    for dup in (1, 3):
        assert not (amind == dup).any() and not (aminm == dup).any()
    leaf = tc.clone().requires_grad_(True)
    (sc.sphere_min_depth(leaf, tr, S).sum() + sc.d2m_nearest(z, leaf, tr, S).sum()).backward()
    assert float(leaf.grad[:, [1, 3]].abs().max()) == 0.0
    assert float(leaf.grad[:, [0, 2]].abs().max()) > 0.0


@pytest.mark.parametrize("fields", [sc.DEPTH, sc.DIST, sc.BOTH])
def test_kernel_launchers_refuse_cpu_tensors(fields):
    centers, radii, z, _ = _fixture()
    tc, tr, tz = _t(centers, radii, z)
    planes = sc.fields_plain(fields, tc, tz, tr, S, residuals=True)
    k = sc.num_fields(fields)
    with pytest.raises(ValueError, match="CUDA"):
        sc.launch_fields(fields, tc, tz, tr, S, residuals=True)
    with pytest.raises(ValueError, match="CUDA"):
        sc.launch_fields_bwd(fields, tc, tz, 1, planes[:k], planes[k:])
    assert all(n == 0 for n in sc.LAUNCHES.values())


def test_data_to_model_distance_matches_golden_and_jax(goldens):
    """The golden's bounds (tests/test_render_losses.py: atol 2e-3, rtol
    1e-4); against JAX, weighted, value rtol 1e-6 and gradient 1e-5 of the
    largest entry (the same float32 arithmetic; min and mean in another
    order)."""
    g = goldens("sphere_render")
    loss = tsphere.data_to_model_distance(*_t(g["dms"], g["query"], g["radii_41"]))
    np.testing.assert_allclose(float(loss), float(g["d2m_loss"]), atol=2e-3, rtol=1e-4)
    centers, radii, z, _ = _fixture()
    weights = np.asarray([1.0, 0.0, 1.0], np.float32)
    ref, g_ref = jax.value_and_grad(lambda c: jsphere.data_to_model_distance(
        jnp.asarray(z), c, jnp.asarray(radii), jnp.asarray(weights)))(jnp.asarray(centers))
    tz, tr, tw = _t(z, radii, weights)
    leaf = torch.from_numpy(centers).requires_grad_(True)
    ours = tsphere.data_to_model_distance(tz, leaf, tr, tw)
    ours.backward()
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-6)
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(leaf.grad.numpy(), g_ref, atol=1e-5 * np.abs(g_ref).max())


def test_mutual_projection_matches_jax(goldens):
    """Projected joints and depth maps against JAX ``mutual_projection`` (its
    XLA path, op by op). The view transforms are einsums that round in
    another order (measured: one ulp, 7.6e-6 mm, on a tenth of the
    coordinates), so joints within 2e-5 mm and depth maps with identical
    silhouettes within 1e-3 mm (measured 1.4e-4); the depth maps bit for bit
    against the plain field of JAX's own projected joints; the joint
    gradient under a random cotangent within 2e-4 of the largest entry of the
    compiled JAX gradient (measured 9.4e-5: the one-ulp centre differences
    move a few argmins at near-ties between sphere surfaces)."""
    g = goldens("multiview")
    radii = goldens("sphere_render")["radii_41"]
    args = [g["poses"], g["inv_poses"], g["joints"]]
    with jax.disable_jit():
        ref_dms, ref_proj = jmv.mutual_projection(*map(jnp.asarray, args), jnp.asarray(radii), S)
    ref_dms, ref_proj = np.asarray(ref_dms), np.asarray(ref_proj)
    tp, ti, tj, tr = _t(*args, radii)
    dms, proj = multiview.mutual_projection(tp, ti, tj, tr, S)
    np.testing.assert_allclose(proj.numpy(), ref_proj, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(dms.numpy() < 99.0, ref_dms < 99.0)
    np.testing.assert_allclose(dms.numpy(), ref_dms, rtol=0, atol=1e-3)
    same_centres = sc.min_depth_primal_plain(torch.from_numpy(np.array(ref_proj).reshape(-1, J, 3)),
                                            tr, S)
    np.testing.assert_array_equal(same_centres.numpy().reshape(ref_dms.shape), ref_dms)
    w = np.random.RandomState(2).uniform(-1, 1, dms.shape).astype(np.float32)
    g_ref = np.asarray(jax.grad(lambda j: jnp.sum(w * jmv.mutual_projection(
        jnp.asarray(g["poses"]), jnp.asarray(g["inv_poses"]), j, jnp.asarray(radii), S)[0]))(
        jnp.asarray(g["joints"])))
    leaf = tj.clone().requires_grad_(True)
    (multiview.mutual_projection(tp, ti, leaf, tr, S)[0] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), g_ref, atol=2e-4 * np.abs(g_ref).max())


@pytest.mark.parametrize("is_mv", [True, False])
def test_unfused_loss_equals_fused_loss(is_mv):
    """The counterpart of test_sphere_pallas.py:192-235 on the whole loss:
    the unfused branch (the CPU default) against the fused one, value within
    1e-6 relative and joint gradient within 2e-5 of the largest entry."""
    rng = np.random.RandomState(3)
    b, v = 2, 3
    joints = rng.uniform(-70, 70, (b, v, J, 3)).astype(np.float32)
    radii = rng.uniform(4, 12, (J,)).astype(np.float32)
    real = np.full((b, v, S, S), 100.0, np.float32)
    real[:, :, 16:48, 16:48] = rng.uniform(-60, 60, (b, v, 32, 32))
    angles = rng.uniform(-0.7, 0.7, (v,))
    poses = np.zeros((b, v, 4, 4), np.float32)
    poses[:, :, 3, 3] = 1.0
    for k, a in enumerate(angles):
        c, s = np.cos(a), np.sin(a)
        poses[:, k, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    tp, ti, tj, td, tr = _t(poses, np.swapaxes(poses, -1, -2), joints, real, radii)
    out = {}
    for fused in (False, True):
        leaf = tj.clone().requires_grad_(True)
        loss, dms = multiview.mutual_projection_loss(tp, ti, leaf, td, tr, is_mv=is_mv,
                                                     fused=fused)
        loss.backward()
        out[fused] = (float(loss.detach()), leaf.grad.numpy(), dms.detach())
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    scale = np.abs(out[False][1]).max()
    np.testing.assert_allclose(out[True][1], out[False][1], atol=2e-5 * scale)
    assert torch.equal(out[True][2], out[False][2])


def test_kernel_parity_runs_on_the_cpu_at_a_small_size():
    """``python -m spherehand_torch.kernel_parity`` with ``--device cpu``
    holds the plain versions against themselves: every statistic at its
    ideal value, the fused and unfused stack losses equal (the unfused form
    is the CPU default)."""
    from spherehand_torch import kernel_parity

    stats = kernel_parity.run(torch.device("cpu"), raster_batch=1, sphere_n=4, sphere_batch=1)
    assert stats["exact_coverage_match"] == 1.0 and stats["exact_median_diff"] == 0.0
    assert stats["fast_iou"] > 0.999 and stats["fast_p99_diff"] < 0.5
    assert stats["fastpool_median"] < 0.05
    for key in ("min_depth_fwd_rel", "d2m_fwd_rel", "fused_val_rel"):
        assert stats[key] == 0.0, key
    for key in ("min_depth_grad_rel", "d2m_grad_rel", "fused_grad_rel"):
        assert stats[key] <= 1e-5, (key, stats[key])
    assert stats["stack_loss"] == stats["stack_unfused_loss"]
    assert np.isfinite(stats["stack_grad_norm"]) and stats["stack_grad_norm"] > 0.0
