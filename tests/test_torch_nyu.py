"""The port's NYU data path (``spherehand_torch.data.nyu`` and ``.native``)
against the JAX package's: shard bytes, gathers, index plans, the crop,
projection and Kabsch helpers, the whole generator and the native
binding."""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from spherehand_tpu.data import nyu as jnyu  # noqa: E402
from spherehand_torch.data import native  # noqa: E402
from spherehand_torch.data import nyu  # noqa: E402

SHARD_FILES = ("_shape.pkl", "_dms.bat", "_joint_poses.npy", "_camera_poses.npy")


def _arrays(rng, n):
    dms = np.full((n, 3, 64, 64), 100.0, np.float32)
    dms[:, :, 20:44, 18:40] = rng.uniform(20, 80, (n, 3, 24, 22))
    joints = rng.uniform(-80, 80, (n, 3, 36, 3)).astype(np.float32)
    poses = np.stack([np.stack([np.eye(4)] + [
        nyu.kabsch_transform(joints[k, v], joints[k, 0]) for v in (1, 2)]) for k in range(n)])
    return dms, joints, poses.astype(np.float32)


def _jax_writer(npy_dir):
    gen = object.__new__(jnyu.NyuDatasetGenerator)  # use only _write_shard
    gen.npy_dir = npy_dir
    return gen._write_shard


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The same arrays as two shards (3 + 4 samples), written by the JAX
    package and by the port (its function and its generator method)."""
    rng = np.random.RandomState(0)
    parts = [_arrays(rng, 3), _arrays(rng, 4)]
    root = tmp_path_factory.mktemp("nyu")
    dirs = {k: str(root / k) for k in ("jax", "port", "port_method")}
    for d in dirs.values():
        os.makedirs(d)
    port_method = object.__new__(nyu.NyuDatasetGenerator)
    port_method.npy_dir = dirs["port_method"]
    for i, arrays in enumerate(parts):
        _jax_writer(dirs["jax"])(f"mv_data_{i}", *arrays)
        nyu.write_shard(dirs["port"], f"mv_data_{i}", *arrays)
        port_method._write_shard(f"mv_data_{i}", *arrays)
    return dirs, parts


def test_write_shard_is_byte_equal_to_jax(shards):
    dirs, parts = shards
    for i in range(len(parts)):
        for suffix in SHARD_FILES:
            ref = _read(os.path.join(dirs["jax"], f"mv_data_{i}{suffix}"))
            for key in ("port", "port_method"):
                assert _read(os.path.join(dirs[key], f"mv_data_{i}{suffix}")) == ref, (key, suffix)


@pytest.mark.parametrize("gather", ["gather", "gather_joints", "gather_dms"])
def test_dataset_reads_jax_shards_and_gathers_like_jax(shards, gather):
    """The port reads the JAX package's shards; every gather equals JAX's bit
    for bit across the shard boundary (``inv_poses`` included)."""
    dirs, parts = shards
    ours, ref = nyu.NyuDataset(dirs["jax"]), jnyu.NyuDataset(dirs["jax"])
    assert len(ours) == len(ref) == 7
    np.testing.assert_array_equal(ours.offsets, ref.offsets)
    for idx in (np.asarray([0, 3, 6]), np.asarray([6, 2, 3, 2]), np.arange(7)):
        a, b = getattr(ours, gather)(idx), getattr(ref, gather)(idx)
        for x, y in zip(a if gather == "gather" else [a], b if gather == "gather" else [b]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    dms = ours.gather(np.asarray([4]))[0]
    np.testing.assert_array_equal(dms[0], parts[1][0][1])


@pytest.mark.parametrize("seed,epoch,shuffle,batch", [
    (0, 0, True, 2), (0, 1, True, 2), (7, 3, True, 3), (0, 5, False, 2), (-1, 2, True, 1),
    (2**31 + 5, 0, True, 4),
])
def test_loader_index_plans_equal_jax(shards, seed, epoch, shuffle, batch):
    dirs, _ = shards
    ours = nyu.NyuLoader(nyu.NyuDataset(dirs["port"]), batch, shuffle, seed=seed, epoch=epoch)
    ref = jnyu.NyuLoader(jnyu.NyuDataset(dirs["port"]), batch, shuffle, seed=seed, epoch=epoch)
    assert len(ours) == len(ref)
    plans = list(ours.iter_index_batches()), list(ref.iter_index_batches())
    assert len(plans[0]) == 7 // batch
    for a, b in zip(*plans):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_crop_projection_and_kabsch_equal_jax(goldens):
    g = goldens("nyu_crop")
    cam, jcam = nyu.CameraIntrinsics(), jnyu.CameraIntrinsics()
    assert tuple(cam) == tuple(jcam)
    np.testing.assert_array_equal(nyu.crop_depth_map(g["dm"], g["center"], cam),
                                  jnyu.crop_depth_map(g["dm"], g["center"], jcam))
    np.testing.assert_allclose(nyu.crop_depth_map(g["dm"], g["center"], cam), g["cropped"],
                               atol=1e-4)
    np.testing.assert_array_equal(nyu.kabsch_transform(g["pts1"], g["pts2"]),
                                  jnyu.kabsch_transform(g["pts1"], g["pts2"]))
    rng = np.random.RandomState(3)
    xyz = rng.uniform([-100, -100, 500], [100, 100, 900], (5, 7, 3))
    for fn in ("perspective_project", "orthographic_project_np"):
        np.testing.assert_array_equal(getattr(nyu, fn)(xyz, cam), getattr(jnyu, fn)(xyz, jcam))
    uvd = nyu.perspective_project(xyz, cam)
    np.testing.assert_array_equal(nyu.perspective_backproject(uvd, cam),
                                  jnyu.perspective_backproject(uvd, jcam))
    np.testing.assert_allclose(nyu.perspective_backproject(uvd, cam), xyz, rtol=1e-12)


def _write_depth_png(path, depth):
    """Encode uint16 depth into the NYU RGB scheme (G << 8 | B)."""
    from PIL import Image

    d = depth.astype(np.uint16)
    rgb = np.zeros(d.shape + (3,), np.uint8)
    rgb[..., 1] = (d >> 8).astype(np.uint8)
    rgb[..., 2] = (d & 0xFF).astype(np.uint8)
    Image.fromarray(rgb).save(path)


@pytest.fixture(scope="module")
def raw_nyu(tmp_path_factory):
    """A raw NYU-layout subset: ``joint_data.mat`` and the depth PNGs of 3
    samples x 3 views, hands near 800 mm."""
    import scipy.io as sio

    rng = np.random.RandomState(1)
    root = tmp_path_factory.mktemp("raw")
    src = root / "train"
    src.mkdir()
    n = 3
    joints = rng.uniform(-60, 60, (3, n, 36, 3)).astype(np.float32)
    joints[..., 2] += 800.0
    sio.savemat(str(src / "joint_data.mat"), {"joint_xyz": joints})
    for i in range(n):
        for v in range(3):
            depth = rng.randint(400, 1500, (480, 640)).astype(np.float32)
            depth[180:300, 260:380] = rng.randint(760, 860, (120, 120))
            _write_depth_png(str(src / f"depth_{v + 1}_{i + 1:07d}.png"), depth)
    return str(root)


def test_generator_writes_the_jax_shards(raw_nyu, tmp_path):
    """The whole offline pipeline (numpy path): decode, crop, Kabsch, two
    shards, byte for byte as the JAX package writes them."""
    import shutil

    roots = {}
    for key in ("port", "jax"):
        roots[key] = str(tmp_path / key)
        shutil.copytree(raw_nyu, roots[key])
    nyu.NyuDatasetGenerator(roots["port"], "train").generate(
        samples_per_shard=2, workers=1, use_native=False)
    jnyu.NyuDatasetGenerator(roots["jax"], "train").generate(
        samples_per_shard=2, workers=1, use_native=False)
    out = {k: os.path.join(r, "npy-64", "train") for k, r in roots.items()}
    assert sorted(os.listdir(out["port"])) == sorted(os.listdir(out["jax"]))
    assert len(os.listdir(out["port"])) == 8
    for name in os.listdir(out["jax"]):
        assert _read(os.path.join(out["port"], name)) == _read(os.path.join(out["jax"], name)), name


@pytest.mark.skipif(not native.available(), reason="native loader not buildable here")
def test_native_binding_equals_the_numpy_path(raw_nyu):
    src = os.path.join(raw_nyu, "train")
    path = os.path.join(src, "depth_1_0000001.png")
    np.testing.assert_array_equal(native.decode_depth_png(path), nyu.decode_nyu_depth_png(path))
    gen = nyu.NyuDatasetGenerator(raw_nyu, "train")
    dms_native, jp_native, cp_native = gen._prepare_range_native(0, 3)
    dms_py, jp_py, cp_py = gen._prepare_range_python(0, 3, workers=1)
    np.testing.assert_allclose(dms_native, dms_py, atol=1e-4)
    assert float((dms_py < 99).mean()) > 0.05
    np.testing.assert_array_equal(jp_native, jp_py)
    # the same float32 Kabsch on the same joints; the numpy path runs it in
    # a pool process, whose LAPACK rounds the float32 SVD differently (1e-5
    # relative on the mm translations)
    np.testing.assert_allclose(cp_native, cp_py, rtol=1e-4, atol=1e-5)
    # built into the port's build directory, never into native/
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR
    assert os.path.basename(native.BUILD_DIR) == "build"
