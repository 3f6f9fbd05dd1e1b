"""The port's sphere render and fused sphere-field op vs the JAX package.

The plain versions of the three sphere kernels (render/sphere_cuda.py) are
held against the JAX package's oracle fields, its Pallas kernels in
interpret mode (as tests/test_sphere_pallas.py runs them on the CPU) and the
goldens ``sphere_render.npz`` and ``tpu_sphere_parity.npz``.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_tpu.render import sphere as jsphere  # noqa: E402
from spherehand_tpu.render import sphere_pallas as jpallas  # noqa: E402
from spherehand_torch.render import sphere_cuda  # noqa: E402
from spherehand_torch.render.adversarial import sphere_adversarial_case  # noqa: E402
from spherehand_torch.render.sphere import render_sphere_hand, render_spheres  # noqa: E402

N, J, S = 6, 41, 64


def _fixture(seed=7, n=N):
    """Centres and observed maps at the scales of tests/test_sphere_pallas.py."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-80, 80, (n, J, 3)).astype(np.float32)
    radii = rng.uniform(4, 12, (J,)).astype(np.float32)
    z = np.full((n, S, S), 100.0, np.float32)
    z[:, 16:48, 16:48] = rng.uniform(-60, 60, (n, 32, 32))
    w = rng.uniform(-1, 1, (2, n, S, S)).astype(np.float32)
    return centers, radii, z, w


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_d2m_field(centers, radii, z):
    """The JAX package's XLA nearest-surface field (data_to_model_distance
    without its clip-and-mean epilogue)."""
    xg, yg = jsphere._mm_grid(S, S, jnp.float32)
    p_sq = xg * xg + yg * yg + z * z
    cx, cy, cz = (centers[..., k, None, None] for k in range(3))
    pdc = xg * cx + yg * cy + z[..., None, :, :] * cz
    c_sq = jnp.sum(centers * centers, axis=-1)[..., None, None]
    sq = jnp.maximum(p_sq[..., None, :, :] - 2.0 * pdc + c_sq, 1e-6)
    dist = jnp.abs(jnp.sqrt(sq) - radii[..., None, None])
    return jnp.min(jnp.where((z > 99.0)[..., None, :, :], 0.0, dist), axis=-3)


def test_render_spheres_match_golden(goldens):
    g = goldens("sphere_render")
    maps = render_spheres(*_t(g["centers"], g["radii"]), 64)
    np.testing.assert_allclose(maps.numpy(), g["maps"], atol=1e-3, rtol=1e-5)
    part, dm = render_sphere_hand(*_t(g["joints"], g["radii_41"]), 64)
    assert part.shape == (3, 41, 64, 64)
    np.testing.assert_allclose(dm.numpy(), g["dms"], atol=1e-3, rtol=1e-5)


def test_plain_fields_match_jax_oracle():
    """Both plain fields against the JAX package's XLA fields; op by op
    (jax.disable_jit) they are bit-identical, the compiled oracle differs
    by FMA contraction only (atol 1e-4 mm as test_sphere_pallas.py)."""
    centers, radii, z, _ = _fixture()
    depth, dist = sphere_cuda.fused_primal_plain(*_t(centers, z, radii), S)
    jr = jnp.asarray(np.broadcast_to(radii, (N, J)))
    with jax.disable_jit():
        ref_d = jnp.min(jsphere.render_spheres(jnp.asarray(centers), jr, S), axis=-3)
    np.testing.assert_array_equal(depth.numpy(), np.asarray(ref_d))
    ref_m = _jax_d2m_field(jnp.asarray(centers), jnp.asarray(radii), jnp.asarray(z))
    np.testing.assert_allclose(dist.numpy(), np.asarray(ref_m), atol=1e-4)
    compiled_d = jnp.min(jsphere.render_spheres(jnp.asarray(centers), jr, S), axis=-3)
    np.testing.assert_allclose(depth.numpy(), np.asarray(compiled_d), atol=1e-4)


def test_residual_planes_match_pallas_interpret():
    """fused_fwd_plain's six planes against ``_fused_fwd_rule`` (Pallas in
    interpret mode, which XLA compiles with FMA contraction and its own
    rsqrt). Argmins equal on this fixture (a near-tie could flip, so up to
    1e-4 of the pixels); fields within the atol test_sphere_pallas.py holds
    the kernels to (1e-4 depth, 1e-3 distance; measured 7.6e-6 and 3.5e-4);
    weights relative 1e-4 (depth, measured 3.2e-5: XLA's rsqrt against the
    port's 1/sqrt) and 1e-3 (distance, measured 1.7e-4: the contracted raw)
    where the argmins agree."""
    centers, radii, z, _ = _fixture()
    (jd, jm), (_, _, jamind, jwd, jaminm, jwm) = jpallas._fused_fwd_rule(
        jnp.asarray(centers), jnp.asarray(z), jnp.asarray(radii), S, True)
    depth, dist, amind, wd, aminm, wm = sphere_cuda.fused_fwd_plain(*_t(centers, z, radii), S)
    shape = (N, S, S)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jm), atol=1e-3)
    for ours, ref, w_ours, w_ref, rtol in ((amind, jamind, wd, jwd, 1e-4),
                                           (aminm, jaminm, wm, jwm, 1e-3)):
        ref = np.asarray(ref).reshape(shape)
        same = ours.numpy() == ref
        assert 1.0 - same.mean() <= 1e-4
        np.testing.assert_allclose(w_ours.numpy()[same], np.asarray(w_ref).reshape(shape)[same],
                                   rtol=rtol, atol=1e-12)


def _grad_setup(seed=7):
    centers, radii, z, w = _fixture(seed)
    return centers, radii, z, w[0], np.roll(w[1], 1, axis=-1)


def test_backward_matches_jax_and_autograd():
    """The op's gradient (fused_bwd_plain on CPU) against jax.grad through
    the Pallas op in interpret mode and against torch autograd through
    fused_primal_plain: 2e-5 of the largest entry, the bound
    test_sphere_pallas.py holds the Pallas op to (summation order)."""
    centers, radii, z, w1, w2 = _grad_setup()

    def f_jax(c):
        d, m = jpallas.sphere_min_depth_and_d2m(c, jnp.asarray(z), jnp.asarray(radii), S, True)
        return jnp.sum(w1 * d) + jnp.sum(w2 * m)

    g_ref = np.asarray(jax.grad(f_jax)(jnp.asarray(centers)))
    tc, tz, tr, tw1, tw2 = _t(centers, z, radii, w1, w2)
    leaf = tc.clone().requires_grad_(True)
    d, m = sphere_cuda.sphere_min_depth_and_d2m(leaf, tz, tr, S)
    ((tw1 * d).sum() + (tw2 * m).sum()).backward()
    scale = np.abs(g_ref).max()
    np.testing.assert_allclose(leaf.grad.numpy(), g_ref, atol=2e-5 * scale)

    auto = tc.clone().requires_grad_(True)
    d, m = sphere_cuda.fused_primal_plain(auto, tz, tr, S)
    ((tw1 * d).sum() + (tw2 * m).sum()).backward()
    np.testing.assert_allclose(leaf.grad.numpy(), auto.grad.numpy(), atol=1e-5 * scale)


def test_op_routes_primal_without_grad():
    """No autograd: the primal path, equal to the forward with residuals;
    target and radii get no gradient."""
    centers, radii, z, _ = _fixture()
    tc, tz, tr = _t(centers, z, radii)
    with torch.no_grad():
        d0, m0 = sphere_cuda.sphere_min_depth_and_d2m(tc.clone().requires_grad_(True), tz, tr, S)
    leaf = tc.clone().requires_grad_(True)
    tz.requires_grad_(True)
    d1, m1 = sphere_cuda.sphere_min_depth_and_d2m(leaf, tz, tr, S)
    assert d0.grad_fn is None and d1.grad_fn is not None
    np.testing.assert_array_equal(d0.numpy(), d1.detach().numpy())
    np.testing.assert_array_equal(m0.numpy(), m1.detach().numpy())
    (d1.sum() + m1.sum()).backward()
    assert tz.grad is None and leaf.grad is not None


def test_views_index_the_target_in_place():
    """views=V reads target plane b*V + j for image (b, i, j): the same as a
    materialised (B, V, V) broadcast with views=1."""
    centers, target, radii = sphere_adversarial_case()
    tc, tt, tr = _t(centers, target, radii)
    full = tt.reshape(2, 1, 3, S, S).expand(2, 3, 3, S, S).reshape(18, S, S).contiguous()
    a = sphere_cuda.fused_fwd_plain(tc, tt, tr, S, views=3)
    b = sphere_cuda.fused_fwd_plain(tc, full, tr, S, views=1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_tie_rule_gives_lowest_j():
    """Duplicated spheres tie exactly: argmins and gradient go to the lower
    j (the JAX kernels' rule), and the duplicate gets zero gradient."""
    centers, target, radii = sphere_adversarial_case()
    tc, tt, tr = _t(centers, target, radii)
    _, _, amind, _, aminm, _ = sphere_cuda.fused_fwd_plain(tc, tt, tr, S, views=3)
    for dup in (1, 3):
        assert not (amind == dup).any() and not (aminm == dup).any()
    assert (amind == 0).any() and (amind == 2).any()
    leaf = tc.clone().requires_grad_(True)
    d, m = sphere_cuda.sphere_min_depth_and_d2m(leaf, tt, tr, S, views=3)
    (d.sum() + m.sum()).backward()
    assert float(leaf.grad[:, [1, 3]].abs().max()) == 0.0
    assert float(leaf.grad[:, [0, 2]].abs().max()) > 0.0
    # all-background targets (batch row 0): the distance field is 0
    assert float(m[:9].detach().abs().max()) == 0.0


def test_stack_loss_matches_tpu_artifact(goldens):
    """The loss-stack fixture of tools/tpu_sphere_parity.py (N = 225, J = 41)
    through the port: value and joint gradient against the artifact the
    TPU captured, with the bounds test_sphere_pallas.py holds the CPU JAX
    oracle to (value 2e-4, gradient norm 1e-3, slice 1e-4 of the max)."""
    from spherehand_torch.losses.geometric import bone_length_loss, collision_loss
    from spherehand_torch.losses.multiview import (
        multiview_consistency_loss,
        mutual_projection_loss,
    )

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from tpu_sphere_parity import B, V, fixture, loss_fixture

    art = goldens("tpu_sphere_parity")
    _, radii, _, _, _ = fixture()
    joints, dms, poses, inv = (np.asarray(a) for a in loss_fixture())
    tj, td, tp, ti, tr = _t(joints, dms, poses, inv, np.asarray(radii))
    leaf = tj.clone().requires_grad_(True)
    mv, _ = mutual_projection_loss(tp, ti, leaf, td, tr, is_mv=True)
    flat = leaf.reshape(B * V, J, 3)
    loss = (mv + 1e-3 * multiview_consistency_loss(tp, leaf) + collision_loss(flat)
            + bone_length_loss(flat))
    loss.backward()
    tpu_loss, tpu_gn = float(art["stack_loss"]), float(art["stack_grad_norm"])
    assert abs(float(loss) - tpu_loss) / tpu_loss < 2e-4, (float(loss), tpu_loss)
    gn = float(leaf.grad.norm())
    assert abs(gn - tpu_gn) / tpu_gn < 1e-3, (gn, tpu_gn)
    scale = np.abs(art["stack_grad"]).max()
    np.testing.assert_allclose(leaf.grad.numpy()[:2], art["stack_grad"], atol=1e-4 * scale)
