"""The port's prior side on the CPU against the JAX package: skeleton FK,
the PCA prior (loss, reconstruction, ``build_pca_prior``), the segmentation op, the VAE
and denoiser training paths (one step each from the same parameters and
draws), the offline trainers, the flax parameter files they write, and the
denoiser's default index tables. Tolerances: rtol 1e-5 for float32
products whose order differs, atol 1e-4 mm on keypoints (as
tests/test_torch_hand.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from spherehand_tpu.data.sampler import sample_poses as jsample_poses  # noqa: E402
from spherehand_tpu.hand.assets import load_pose_prior_pca as jload_pca  # noqa: E402
from spherehand_tpu.hand.skeleton import skeleton_fk as jskeleton_fk  # noqa: E402
from spherehand_tpu.losses import pca_prior as jpca  # noqa: E402
from spherehand_tpu.models import pose_denoiser as jden  # noqa: E402
from spherehand_tpu.models.pose_vae import PoseVae as JPoseVae  # noqa: E402
from spherehand_tpu.ops.segmentation import segment_depth as jsegment  # noqa: E402
from spherehand_tpu.train import priors as jpriors  # noqa: E402
from spherehand_torch.convert import flax_params, load_flax_params  # noqa: E402
from spherehand_torch.hand import load_hand_model, load_pose_prior_pca, skeleton_fk  # noqa: E402
from spherehand_torch.losses.pca_prior import pca_prior_loss, pca_reconstruct  # noqa: E402
from spherehand_torch.models.pose_denoiser import (  # noqa: E402
    PoseDenoiser,
    denoiser_loss,
    draw_denoiser_noise,
    load_pose_denoiser,
)
from spherehand_torch.models.pose_vae import PoseVae  # noqa: E402
from spherehand_torch.ops.segmentation import segment_depth  # noqa: E402
from spherehand_torch.train import priors  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: these tests run many small
    CPU ops, which a parallel region slows down when the suite's workers
    share the cores; the previous count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_hand():
    return load_hand_model(device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jax_poses(key, n):
    return np.array(jax.jit(jsample_poses, static_argnums=1)(key, n))


def _jax_skeletons(hand_model, key, n):
    return np.array(jax.jit(jskeleton_fk)(hand_model, jnp.asarray(_jax_poses(key, n))))


def test_denoiser_default_tables_equal_jax():
    """A fresh ``PoseDenoiser`` holds JAX's default index tables (the
    reference source's layout), not zeros; the released checkpoint's own
    tables still load over them, and loading them leaves the defaults of
    the next fresh module as they were."""
    ref = jden.PoseDenoiser()
    ours = PoseDenoiser()
    np.testing.assert_array_equal(ours.input_indices.numpy(), np.asarray(ref.input_indices))
    np.testing.assert_array_equal(ours.output_indices.numpy(), np.asarray(ref.output_indices))
    released, _ = jden.load_pose_denoiser()

    np.testing.assert_array_equal(load_pose_denoiser(device="cpu").input_indices.numpy(),
                                  np.asarray(released.input_indices))
    assert not np.array_equal(np.asarray(released.input_indices), np.asarray(ref.input_indices))
    np.testing.assert_array_equal(PoseDenoiser().input_indices.numpy(),
                                  np.asarray(ref.input_indices))


def test_skeleton_fk_and_pca_prior_match_jax(hand_model, port_hand):
    """``skeleton_fk`` with and without the RandScale jitter (its draws taken
    from the JAX key) within 1e-4 mm; the shipped PCA asset equal bit for
    bit; ``pca_prior_loss`` within rtol 1e-5 and ``pca_reconstruct`` within
    1e-4 mm on those skeletons and on random point clouds."""
    key = jax.random.key(3)
    poses = _jax_poses(jax.random.key(2), 8)
    u = np.asarray(jax.random.uniform(key, (8, 3), jnp.float32))
    plain = skeleton_fk(port_hand, _t(poses)).numpy()
    scaled = skeleton_fk(port_hand, _t(poses), _t(u)).numpy()
    fk = jax.jit(jskeleton_fk)
    np.testing.assert_allclose(plain, np.asarray(fk(hand_model, jnp.asarray(poses))),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(scaled, np.asarray(fk(hand_model, jnp.asarray(poses), key)),
                               atol=1e-4, rtol=1e-5)
    assert plain.shape == (8, 41, 3) and not np.allclose(plain, scaled)

    jmean, jcomp = jload_pca()
    mean, comp = load_pose_prior_pca(device="cpu")
    np.testing.assert_array_equal(mean.numpy(), np.asarray(jmean))
    np.testing.assert_array_equal(comp.numpy(), np.asarray(jcomp))
    cloud = np.random.RandomState(0).uniform(-80, 80, (8, 41, 3)).astype(np.float32)
    for joints in (scaled, cloud):
        np.testing.assert_allclose(
            float(pca_prior_loss(mean, comp, _t(joints))),
            float(jpca.pca_prior_loss(jmean, jcomp, jnp.asarray(joints))), rtol=1e-5)
        np.testing.assert_allclose(
            pca_reconstruct(mean, comp, _t(joints)).numpy(),
            np.asarray(jpca.pca_reconstruct(jmean, jcomp, jnp.asarray(joints))), atol=1e-4)
    assert float(pca_prior_loss(mean, comp, _t(scaled))) < float(pca_prior_loss(mean, comp,
                                                                                _t(cloud)))


def test_segment_depth_matches_jax(port_hand):
    """``segment_depth`` equals JAX's on rendered-like crops (background 100
    mm outside 7 px of every joint), with no gradient."""
    rng = np.random.RandomState(4)
    dms = rng.uniform(20, 60, (2, 3, 64, 64)).astype(np.float32)
    joints = rng.uniform(-60, 60, (2, 3, 41, 3)).astype(np.float32)
    ours = segment_depth(_t(dms).requires_grad_(), _t(joints))
    ref = np.asarray(jsegment(jnp.asarray(dms), jnp.asarray(joints)))
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert not ours.requires_grad and 0.05 < float((ours == 100.0).float().mean()) < 0.95


def _row_normals(key, rows, width):
    keys = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(rows))
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (width,), jnp.float32))(keys))


def _adam_step_check(module, step, jax_loss, params, joints, noise):
    """One port step and one optax ``adam(1e-3)`` step from ``params``: the
    losses within rtol 1e-5 and the new parameters within 1e-6 of each
    other, but where a small gradient element (|g| below 1e-3 of its
    tensor's largest, whose float32 rounding in either order is a large
    share of it) takes its sign-like first Adam step: there within 2 lr."""
    loss_ref, grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    tx = optax.adam(1e-3)
    updates, _ = tx.update(grads, tx.init(params))
    new_ref = optax.apply_updates(params, updates)
    module = load_flax_params(module, jax.tree.map(np.asarray, params))
    opt = torch.optim.Adam(module.parameters(), lr=1e-3)
    loss = step(module, opt, _t(joints), _t(noise))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    ours = flax_params(module)
    flat_ref = jax.tree_util.tree_flatten_with_path(new_ref)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    for path, ref in flat_ref:
        got = ours
        for p in path:
            got = got[p.key]
        ref, g = np.asarray(ref), np.abs(np.asarray(flat_g[path]))
        d = np.abs(got - ref)
        small = g < 1e-3 * g.max()
        assert d[~small].max(initial=0.0) <= 1e-6, path
        assert d.max() <= 2e-3, path


def test_vae_step_matches_jax(hand_model):
    """One VAE step (skeletons / 100, per-row reparameterisation noise from
    JAX's keys) from JAX's init: the loss and the Adam-updated parameters."""
    batch = 16
    joints = _jax_skeletons(hand_model, jax.random.key(5), batch)
    k_rep = jax.random.key(6)
    vae = JPoseVae()
    params = vae.init(jax.random.key(1), jnp.zeros((1, 123)), rng=jax.random.key(0))["params"]
    x = jnp.asarray(joints / 100.0).reshape(batch, -1)

    def jax_loss(p):
        return vae.apply({"params": p}, x, rng=k_rep, reparameterize=True)[3]

    _adam_step_check(PoseVae(), priors.vae_step, jax_loss, params, joints,
                     _row_normals(k_rep, batch, 32))


def test_denoiser_step_matches_jax(hand_model):
    """One denoiser step (input noise x 0.1 from JAX's draw) from JAX's
    init: ``denoiser_loss``, the loss and the Adam-updated parameters."""
    batch = 16
    joints = _jax_skeletons(hand_model, jax.random.key(7), batch)
    k_noise = jax.random.key(8)
    den = jden.PoseDenoiser()
    params = den.init(jax.random.key(1), jnp.zeros((1, 41, 3)), rng=jax.random.key(0),
                      train=True)["params"]
    noise = np.asarray(jax.random.normal(k_noise, (batch, 112), jnp.float32))

    def jax_loss(p):
        out = den.apply({"params": p}, jnp.asarray(joints), rng=k_noise, train=True)
        return jden.denoiser_loss(jnp.asarray(joints), out)

    est = np.random.RandomState(1).normal(0, 30, joints.shape).astype(np.float32)
    np.testing.assert_allclose(float(denoiser_loss(_t(joints), _t(est))),
                               float(jden.denoiser_loss(jnp.asarray(joints), jnp.asarray(est))),
                               rtol=1e-5)
    _adam_step_check(PoseDenoiser(), priors.denoiser_step, jax_loss, params, joints, noise)
    draws = draw_denoiser_noise(torch.Generator().manual_seed(0), 256)
    assert draws.shape == (256, 112) and abs(float(draws.std()) - 1.0) < 0.02


def test_build_pca_prior_matches_jax(hand_model, port_hand):
    """The PCA core on JAX's pose batches against JAX's ``build_pca_prior``
    (4 x 512 samples, 16 components): the mean within 1e-3 mm and the top 10
    components with |cos| >= 0.999 (the sign is free); the components are
    orthonormal and ``build_pca_prior`` runs from its own draws."""
    mean_j, comp_j = jpriors.build_pca_prior(hand_model, num_samples=2048, num_components=16,
                                             batch=512)
    batches = [_t(_jax_poses(jax.random.fold_in(jax.random.key(0), i), 512)) for i in range(4)]
    mean, comp = priors.pca_prior_from_poses(port_hand, batches, num_components=16)
    np.testing.assert_allclose(mean, mean_j, atol=1e-3)
    cos = np.abs(np.sum(comp[:10] * comp_j[:10], axis=1))
    assert cos.min() >= 0.999, cos
    np.testing.assert_allclose(comp @ comp.T, np.eye(16), atol=1e-5)
    mean2, comp2 = priors.build_pca_prior(port_hand, num_samples=1024, num_components=4, batch=512)
    assert mean2.shape == (123,) and comp2.shape == (4, 123) and np.isfinite(comp2).all()


def test_flax_params_round_trip_and_npz_equal_jax(tmp_path):
    """flax -> port -> flax gives JAX's init arrays back bit for bit, for
    the VAE and the denoiser; the port's ``save_flax_params_npz`` file has
    the keys and arrays of the JAX function's for the same parameters."""
    trees = {
        "vae": (PoseVae(), JPoseVae().init(jax.random.key(2), jnp.zeros((1, 123)),
                                           rng=jax.random.key(0))["params"]),
        "denoiser": (PoseDenoiser(), jden.PoseDenoiser().init(
            jax.random.key(3), jnp.zeros((1, 41, 3)), rng=jax.random.key(0), train=True)["params"]),
    }
    for name, (module, params) in trees.items():
        params = jax.tree.map(np.asarray, params)
        back = flax_params(load_flax_params(module, params))
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        ours, ref = tmp_path / f"{name}_port.npz", tmp_path / f"{name}_jax.npz"
        priors.save_flax_params_npz(str(ours), back)
        jpriors.save_flax_params_npz(str(ref), params)
        with np.load(ours) as a, np.load(ref) as b:
            assert sorted(a.files) == sorted(b.files)
            assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a.files)


def test_trainers_run_and_learn(port_hand):
    """The two trainers on the CPU, 3 steps at batch 16: a loss a step, all
    finite, and modules that read as JAX's prior networks do."""
    vae, vae_losses = priors.train_pose_vae(port_hand, steps=3, batch=16, log_every=0)
    den, den_losses = priors.train_pose_denoiser(port_hand, steps=3, batch=16, log_every=0)
    assert vae_losses.shape == den_losses.shape == (3,)
    assert bool(torch.isfinite(vae_losses).all() and torch.isfinite(den_losses).all())
    with torch.no_grad():
        recon, _, _, like = vae(torch.zeros(2, 123))
        out = den(torch.zeros(2, 41, 3))
    assert recon.shape == (2, 123) and bool(torch.isfinite(like))
    assert out.shape == (2, 41, 3) and bool(torch.equal(out[:, 11:], torch.zeros(2, 30, 3)))
