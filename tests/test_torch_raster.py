"""PyTorch port vs the JAX package: the plain rasterizers and the render.

The plain exact version is held against the JAX oracle ``rasterize_depth``
run op by op (``jax.disable_jit``): compiled, XLA's CPU back end contracts
a*b+c into FMAs inside its fused loops, and on faces that straddle z = 0
(where the 1/z interpolation cancels) that moves a depth by up to several mm.
Op by op, both round every operation alike and agree bit for bit. The
compiled oracle is held to the statistical contract instead.

The raw fast rule (``raster_cuda.rasterize_fast``, the plain version of the
``raster_fast`` kernel on the CPU) is held to the fast contract against the
JAX fast path without a sample-grid shortcut (interpret mode) and against
the TPU's recorded raw fast buffers.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` and the
``cuda``-marked tests of ``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_tpu.data.sampler import sample_poses  # noqa: E402
from spherehand_tpu.hand.kinematics import forward_kinematics  # noqa: E402
from spherehand_tpu.hand.skinning import lbs_faces, orthographic_project_xyz  # noqa: E402
from spherehand_tpu.render import raster as jraster  # noqa: E402
from spherehand_tpu.render import raster_pallas  # noqa: E402
from spherehand_torch.hand.assets import load_hand_model  # noqa: E402
from spherehand_torch.render import raster as traster  # noqa: E402
from spherehand_torch.render import contracts, raster_cuda  # noqa: E402
from spherehand_torch.render.adversarial import adversarial_cases  # noqa: E402

SAMPLES = jraster.bilinear_sample_positions(64, 10)
CASES = adversarial_cases()


@pytest.fixture(scope="module")
def hand_setup(hand_model):
    """Two sampler hands: (params, transforms, face vertices (2, F, 3, 3))."""
    @jax.jit
    def geometry(key):
        tr = forward_kinematics(hand_model, sample_poses(key, 2))
        return tr, orthographic_project_xyz(lbs_faces(hand_model, tr), 640.0)

    tr, fv = geometry(jax.random.key(11))
    return np.asarray(tr), np.asarray(fv).reshape(2, -1, 3, 3)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _exact_contract(ours, ref):
    """Coverage identical, median 0, 99.9th percentile <= 1e-3 mm."""
    assert ((ours < 999) == (ref < 999)).all()
    d = np.abs(ours - ref)
    assert np.median(d) == 0.0
    assert np.percentile(d, 99.9) <= 1e-3, np.percentile(d, 99.9)


def _fast_contract(fast_pooled, exact_pooled, fast_raw=None, exact_raw=None):
    """The shipped fast-mode contract (raster_pallas.py:81-96)."""
    stats = contracts.fast_stats(fast_pooled, exact_pooled, fast_raw, exact_raw)
    assert contracts.fast_ok(stats), stats


def test_plain_exact_matches_jax_oracle_on_hand(hand_setup):
    """Bit parity with the op-by-op oracle, on every fourth bilinear sample
    (32 x 32 samples spanning the whole canvas)."""
    _, fv = hand_setup
    s = SAMPLES[::4]
    with jax.disable_jit():
        ref = np.asarray(jraster.rasterize_depth(
            jnp.asarray(fv), jnp.asarray(s), jnp.asarray(s), face_chunk=1024))
    ours = traster.rasterize_depth(_t(fv), _t(s), _t(s)).numpy()
    assert (ref < 999).mean() > 0.05
    _exact_contract(ours, ref)


def test_plain_exact_vs_compiled_jax_on_hand(hand_setup):
    """Against the compiled oracle on the full 128 x 128 grid: identical
    coverage, median 0, a rare FMA-moved ill-conditioned depth."""
    _, fv = hand_setup
    ref = np.asarray(jraster.rasterize_depth(
        jnp.asarray(fv), jnp.asarray(SAMPLES), jnp.asarray(SAMPLES)))
    ours = traster.rasterize_depth(_t(fv), _t(SAMPLES), _t(SAMPLES)).numpy()
    assert ((ours < 999) == (ref < 999)).all()
    d = np.abs(ours - ref)
    assert np.median(d) == 0.0
    assert (d > 1.0).mean() < 1e-3


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_plain_exact_adversarial(case):
    name, faces, size = CASES[case]
    s = SAMPLES if size == 640 else np.arange(size, dtype=np.float32)
    with jax.disable_jit():
        ref = np.asarray(jraster.rasterize_depth(
            jnp.asarray(faces), jnp.asarray(s), jnp.asarray(s), width=size, height=size,
            face_chunk=8))
    ours = traster.rasterize_depth(_t(faces), _t(s), _t(s), width=size, height=size).numpy()
    assert (ref < 999).any(), name
    _exact_contract(ours, ref)
    # the kernel's pre-pass boxes hold every painted exact sample
    _, box = raster_cuda.prepass_exact(_t(faces), width=size)
    box = box.numpy()[0]
    per_face = traster.rasterize_depth(_t(faces[0, :, None]), _t(s), _t(s), size, size).numpy()
    f, rows, cols = np.nonzero(per_face < 999)  # one image per face
    assert (s[cols] >= box[f, 0]).all() and (s[cols] <= box[f, 1]).all(), name
    assert (s[rows] >= box[f, 2]).all() and (s[rows] <= box[f, 3]).all(), name


def test_records_match_jax_layouts(hand_setup):
    """The pre-pass records carry the JAX field layouts, value for value."""
    _, fv = hand_setup
    xc, yc, zc = raster_pallas._face_columns(jnp.asarray(fv))
    px, py, pz, _ = raster_pallas._face_setup_cols(xc, yc, zc)
    fast, _ = raster_cuda.prepass_fast(_t(fv))
    exact, _ = raster_cuda.prepass_exact(_t(fv))
    np.testing.assert_array_equal(
        fast.numpy(), np.asarray(raster_pallas._build_records_fast(px, py, pz)))
    np.testing.assert_array_equal(
        exact.numpy(), np.asarray(raster_pallas._build_records_exact(px, py, pz, 640)))


def test_plain_fast_matches_jax_fast(hand_setup):
    """Plain fast vs the production Pallas fast path (interpret mode, packed
    16-bit sort payloads, truncation): the fast contract."""
    _, fv = hand_setup
    ref = np.asarray(raster_pallas.rasterize_depth_binned(
        jnp.asarray(fv), jnp.asarray(SAMPLES), jnp.asarray(SAMPLES), interpret=True,
        exact=False, pool_clamp=100.0, bilinear_grid=(64, 10), valid_frac=0.62))
    ours = raster_cuda.rasterize_fast_pooled(_t(SAMPLES), _t(SAMPLES), face_vertices=_t(fv)).numpy()
    _fast_contract(ours, ref)
    fg_a, fg_b = ours < 99.9, ref < 99.9
    assert (fg_a & fg_b).sum() / (fg_a | fg_b).sum() > 0.999


def test_plain_fast_vs_plain_exact(hand_setup):
    """The fast-vs-exact contract, on the port's two plain versions."""
    _, fv = hand_setup
    s = _t(SAMPLES)
    records, box = raster_cuda.prepass_fast(_t(fv))
    fast_raw = raster_cuda.raster_fast_plain(records, box, s, s, None).numpy()
    fast = raster_cuda.raster_fast_plain(records, box, s, s, 100.0).numpy()
    exact_raw = traster.rasterize_depth(_t(fv), s, s).numpy()
    exact = traster.pool_2x2(torch.clamp(torch.from_numpy(exact_raw), max=100.0)).numpy()
    np.testing.assert_allclose(
        fast, traster.pool_2x2(torch.clamp(torch.from_numpy(fast_raw), max=100.0)).numpy())
    _fast_contract(fast, exact, fast_raw, exact_raw)


def test_render_depth_64_matches_jax(hand_model, hand_setup):
    """CPU render (plain exact, whatever ``exact`` says) vs JAX's xla backend."""
    tr, _ = hand_setup
    rand_f = np.asarray([0.95, 1.07], np.float32)
    ref = np.asarray(jraster.render_depth_64(
        hand_model, jnp.asarray(tr), jnp.asarray(rand_f), backend="xla"))
    port = load_hand_model(device="cpu")
    raster_cuda.reset_launch_counts()
    ours = traster.render_depth_64(port, _t(tr), _t(rand_f)).numpy()
    again = traster.render_depth_64(port, _t(tr), _t(rand_f), exact=True).numpy()
    np.testing.assert_array_equal(ours, again)
    assert ours.shape == (2, 64, 64) and ours.max() <= 100.0
    assert ((ours < 100.0) == (ref < 100.0)).all()
    d = np.abs(ours - ref)
    assert np.median(d) == 0.0 and (d > 1.0).mean() < 1e-3
    assert raster_cuda.LAUNCHES == {"raster_fast_pooled": 0, "raster_fast": 0, "raster_exact": 0}


def test_cpu_wrappers_take_plain_versions_and_kernels_refuse_cpu(hand_setup):
    """A CPU tensor takes the plain version (no launch is counted); the
    kernel entry points refuse a CPU tensor rather than falling back."""
    _, fv = hand_setup
    s = _t(SAMPLES)
    raster_cuda.reset_launch_counts()
    exact = raster_cuda.rasterize_exact(s, s, face_vertices=_t(fv[:1]))
    np.testing.assert_array_equal(
        exact.numpy(), traster.rasterize_depth(_t(fv[:1]), s, s).numpy())
    planes = tuple(_t(fv[:1, :, :, c].reshape(1, -1)) for c in range(3))
    np.testing.assert_array_equal(
        raster_cuda.rasterize_exact(s, s, planes=planes).numpy(), exact.numpy())
    np.testing.assert_array_equal(
        raster_cuda.rasterize_fast_pooled(s, s, planes=planes).numpy(),
        raster_cuda.rasterize_fast_pooled(s, s, face_vertices=_t(fv[:1])).numpy())
    assert raster_cuda.LAUNCHES == {"raster_fast_pooled": 0, "raster_fast": 0, "raster_exact": 0}
    with pytest.raises(ValueError, match="CUDA"):
        raster_cuda.launch_raster_exact(planes, s, s, 640, 640)
    with pytest.raises(ValueError, match="CUDA"):
        raster_cuda.launch_raster_fast_pooled(planes, s, s, 100.0)


def test_plain_raw_fast_matches_jax_fast_without_grid(hand_setup):
    """``rasterize_fast`` vs JAX ``rasterize_depth_binned(exact=False)``
    without ``bilinear_grid`` (Pallas ``_raster_kernel_fast`` in interpret
    mode): the raw fast contract, IoU > 0.999 and p99 < 0.5 mm on jointly
    covered samples (measured 1.0 and 0.37 mm: the JAX kernel's approximate
    reciprocal and its tile-granular bins against the port's exact division
    and face boxes)."""
    _, fv = hand_setup
    ref = np.asarray(raster_pallas.rasterize_depth_binned(
        jnp.asarray(fv), jnp.asarray(SAMPLES), jnp.asarray(SAMPLES), interpret=True, exact=False))
    ours = raster_cuda.rasterize_fast(_t(SAMPLES), _t(SAMPLES), face_vertices=_t(fv)).numpy()
    assert ours.shape == ref.shape == (2, 128, 128)
    stats = contracts.fast_stats(np.zeros(1), np.zeros(1), ours, ref)
    assert stats["raw_iou"] > 0.999 and stats["raw_p99"] < 0.5, stats


def test_plain_raw_fast_matches_tpu_fast_buffers(goldens, hand_model):
    """Against the four raw fast buffers a TPU v5e recorded
    (tests/goldens/tpu_kernel_parity.npz, tools/tpu_kernel_parity.py): the
    same hands (JAX sampler, key 77, batch 32, the first 4) by the raw fast
    contract, IoU > 0.999 and p99 < 0.5 mm. Measured 0.99974 and 0.462 mm:
    the TPU skinned the mesh at its default matmul precision, so its
    vertices, not the rule, carry most of the difference."""
    from spherehand_tpu.hand.skinning import lbs_mesh, orthographic_project

    art = goldens("tpu_kernel_parity")
    tr = forward_kinematics(hand_model, sample_poses(jax.random.key(77), 32))
    proj = orthographic_project(lbs_mesh(hand_model, tr), 640.0)
    faces = np.asarray(hand_model.faces).reshape(-1)
    fv = np.asarray(proj[:4][:, faces, :3]).reshape(4, -1, 3, 3)
    ours = raster_cuda.rasterize_fast(_t(SAMPLES), _t(SAMPLES), face_vertices=_t(fv)).numpy()
    stats = contracts.fast_stats(np.zeros(1), np.zeros(1), ours, art["fast"])
    assert stats["raw_iou"] > 0.999 and stats["raw_p99"] < 0.5, stats


def test_rasterize_fast_takes_the_plain_version_and_its_kernel_refuses_cpu(hand_setup):
    """On the CPU ``rasterize_fast`` is ``raster_fast_plain`` with no launch
    counted, at a grid whose sizes are no multiple of 8; ``launch_raster_fast``
    refuses a CPU tensor."""
    _, fv = hand_setup
    sx = _t(np.sort(np.random.RandomState(4).uniform(0.0, 640.0, 37)))
    sy = _t(np.linspace(0.0, 1.0, 21) ** 2 * 639.0)
    raster_cuda.reset_launch_counts()
    raw = raster_cuda.rasterize_fast(sx, sy, face_vertices=_t(fv[:1]))
    records, box = raster_cuda.prepass_fast(_t(fv[:1]))
    np.testing.assert_array_equal(raw.numpy(), raster_cuda.raster_fast_plain(records, box, sx, sy).numpy())
    assert raw.shape == (1, 21, 37) and (raw.numpy() < 999).any()
    assert all(n == 0 for n in raster_cuda.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        raster_cuda.launch_raster_fast(raster_cuda.planes_of(_t(fv[:1])), sx, sy)


def test_planes_of_is_the_face_vertex_order(hand_setup):
    """The kernels' planes from (B, F, 3, 3) face vertices: (u, v, z), each
    (B, 3F), contiguous, vertex k of face f at 3f + k."""
    _, fv = hand_setup
    planes = raster_cuda.planes_of(_t(fv))
    for c, plane in enumerate(planes):
        assert plane.shape == (2, 3 * fv.shape[1]) and plane.is_contiguous()
        np.testing.assert_array_equal(plane.numpy(), fv[..., c].reshape(2, -1))


SPECIAL_DEPTHS = np.array(
    [-np.inf, -3.4e38, -1000.0, -1.5, -1e-38, -1e-45, -0.0, 0.0, 1e-45, 1e-40, 1.17e-38,
     0.5, 1.0, 99.99, 100.0, 999.9999, 1000.0, 1000.0001, 3.4e38, np.inf], np.float32)


def test_depth_key_is_monotone_and_round_trips():
    """The plain mirror of the kernels' depth key: strictly increasing over
    sorted float32 values (negatives, -0 below +0, subnormals, infinities,
    the background 1000), unsigned 32-bit, and its inverse gives back every
    bit."""
    rng = np.random.RandomState(5)
    rand = np.concatenate([rng.standard_normal(2000) * 10.0 ** rng.randint(-40, 38, 2000),
                           rng.uniform(-200, 1200, 2000)]).astype(np.float32)
    values = np.unique(np.concatenate([SPECIAL_DEPTHS, rand[np.isfinite(rand)]]))
    values = np.concatenate([values[values < 0], np.float32([-0.0, 0.0]), values[values > 0]])
    keys = raster_cuda.depth_key(torch.from_numpy(values))
    assert keys.dtype == torch.int64
    assert int(keys.min()) >= 0 and int(keys.max()) < 1 << 32
    assert bool((keys[1:] > keys[:-1]).all())
    back = raster_cuda.key_depth(keys).numpy()
    np.testing.assert_array_equal(back.view(np.int32), values.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_min_of_depth_keys_is_torch_minimum(seed):
    """A z-min taken on keys, as the kernels' atomic min does, equals
    torch.minimum over the same float32 sets (background 1000, negatives,
    infinities, signed zeros)."""
    rng = np.random.RandomState(seed)
    sets = rng.uniform(-150, 150, (64, 9)).astype(np.float32)
    sets[rng.rand(*sets.shape) < 0.3] = 1000.0
    sets[rng.rand(*sets.shape) < 0.05] = rng.choice(SPECIAL_DEPTHS, int((sets.size * 0.05) + 1))[0]
    depth = torch.from_numpy(sets)
    ref = depth[:, 0]
    for k in range(1, depth.shape[1]):
        ref = torch.minimum(ref, depth[:, k])
    ours = raster_cuda.key_depth(raster_cuda.depth_key(depth).amin(dim=1))
    assert torch.equal(ours, ref)


def test_render_sample_grid_is_built_once_per_device():
    """``render_depth_64``'s sample grid is cached by (out_size, scale,
    device): no host-to-device copy per render."""
    grid = traster.sample_grid(64, 10, torch.device("cpu"))
    assert traster.sample_grid(64, 10, torch.device("cpu")) is grid
    np.testing.assert_array_equal(grid.numpy(), traster.bilinear_sample_positions(64, 10))


def test_plain_exact_refuses_unordered_samples():
    """The plain exact version bounds each face chunk's samples with a
    sorted search, so it takes ascending sample positions only."""
    faces = _t(CASES[0][1])
    s = _t(SAMPLES)
    with pytest.raises(ValueError, match="ascending"):
        traster.rasterize_depth(faces, s.flip(0), s)
    with pytest.raises(ValueError, match="ascending"):
        traster.rasterize_depth(faces, s, s.flip(0))
