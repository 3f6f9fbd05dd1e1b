"""The port's JAX-side tools against the JAX package's (CPU): make_lite_mesh
with _qem_decimate, inspect_model, interactive_viewer, and a tiny
measure_wobble run."""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_tpu.data.sampler import sample_poses as jsample_poses  # noqa: E402
from spherehand_tpu.hand.kinematics import forward_kinematics as jfk  # noqa: E402
from spherehand_tpu.hand.skinning import lbs_keypoints as jlbs_keypoints  # noqa: E402
from spherehand_tpu.render.raster import render_depth_64 as jrender_depth_64  # noqa: E402
from spherehand_tpu.render.sphere import render_sphere_hand as jrender_sphere_hand  # noqa: E402
from spherehand_torch.data.nyu import write_shard  # noqa: E402
from spherehand_torch.hand.assets import load_hand_model  # noqa: E402
from spherehand_torch.render import raster_cuda, sphere_cuda  # noqa: E402
from spherehand_torch.tools import (  # noqa: E402
    inspect_model,
    interactive_viewer,
    make_lite_mesh,
    measure_wobble,
)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))

import inspect_model as jinspect_model  # noqa: E402
import make_lite_mesh as jmake_lite_mesh  # noqa: E402
from _qem_decimate import qem_decimate as jqem_decimate  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the plain renders are small, and six workers share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_hand():
    return load_hand_model(device="cpu")


def test_rebuilt_lite_mesh_equals_the_asset_and_the_jax_tool():
    """Weld + QEM at 1,700 faces: the committed asset bit for bit (every
    array, dtype and shape), and the JAX tool's weld + qem_decimate on the
    same source."""
    ours = make_lite_mesh.build(1700)
    with np.load(make_lite_mesh.SHIPPED) as shipped:
        assert sorted(ours) == sorted(shipped.files)
        for k in shipped.files:
            assert ours[k].dtype == shipped[k].dtype and ours[k].shape == shipped[k].shape, k
            np.testing.assert_array_equal(ours[k], shipped[k], err_msg=k)
    with np.load(make_lite_mesh.FULL) as src:
        v, f, w = jmake_lite_mesh.weld(src["vertices"], src["faces"], src["skin_weights"])
    faces, used = jqem_decimate(v, f, w, 1700)
    np.testing.assert_array_equal(ours["vertices"], v[used])
    np.testing.assert_array_equal(ours["skin_weights"], w[:, used])
    remap = np.full(v.shape[0], -1, np.int64)
    remap[used] = np.arange(used.shape[0])
    np.testing.assert_array_equal(ours["faces"], remap[faces].astype(f.dtype))


def test_make_lite_mesh_refuses_the_assets_and_validates(tmp_path):
    arrays = make_lite_mesh.build(3000)
    for asset in (make_lite_mesh.SHIPPED, make_lite_mesh.FULL):
        with pytest.raises(ValueError, match="committed asset"):
            make_lite_mesh.write(arrays, asset)
    out = str(tmp_path / "lite.npz")
    make_lite_mesh.write(arrays, out)
    lite = load_hand_model(path=out, device="cpu")
    assert lite.num_faces == arrays["faces"].shape[0]
    assert lite.raster_valid_frac == float(make_lite_mesh.LITE_VALID_FRAC)
    v = make_lite_mesh.validate(2, out, "cpu")
    assert v["iou"] > 0.95 and np.isfinite([v["p50_mm"], v["p99_mm"], v["max_mm"]]).all()


def test_order_table_equals_the_jax_tool(port_hand, capsys):
    jinspect_model.print_order()
    jax_out = capsys.readouterr().out
    inspect_model.main(["order", "--device", "cpu"])
    assert capsys.readouterr().out == jax_out
    assert "\n".join(inspect_model.order_lines(port_hand)) + "\n" == jax_out


def test_scatter_and_align_write_figures(port_hand, tmp_path):
    """Under Agg: a scatter of the rest pose (points equal to JAX's rest
    pose within 1e-4 mm) and the overlay of a shard of two samples."""
    verts, kps = inspect_model.scatter_points(port_hand)
    assert verts.shape == (port_hand.num_vertices, 3) and kps.shape == (41, 3)
    from spherehand_tpu.hand.assets import load_hand_model as jload_hand_model

    jmodel = jload_hand_model()
    jkps = np.asarray(jlbs_keypoints(jmodel, jfk(jmodel, jnp.zeros((1, 26)))))[0, :, :3]
    np.testing.assert_allclose(kps, jkps, atol=1e-4)
    png = tmp_path / "scatter.png"
    inspect_model.main(["scatter", "--out", str(png), "--device", "cpu"])
    assert png.stat().st_size > 0

    rng = np.random.RandomState(0)
    shard = tmp_path / "shards"
    shard.mkdir()
    write_shard(str(shard), "mv_data_0",
                rng.uniform(-100, 100, (2, 3, 64, 64)).astype(np.float32),
                rng.uniform(-100, 100, (2, 3, 36, 3)).astype(np.float32),
                np.tile(np.eye(4, dtype=np.float32), (2, 3, 1, 1)))
    pts = inspect_model.align_points(str(shard), port_hand)
    assert pts["depth"].shape == (64, 64)
    assert pts["real_px"].shape == pts["synt_px"].shape == (14, 2)
    png = tmp_path / "align.png"
    inspect_model.main(["align", str(shard), "--out", str(png), "--device", "cpu"])
    assert png.stat().st_size > 0


def test_viewer_renders_equal_the_jax_viewer_calls(port_hand, hand_model):
    """The rest pose and two sampled poses through render_views against the
    calls the JAX viewer makes, held as tests/test_torch_sphere.py and
    tests/test_torch_raster.py hold those renders; no kernel launch here."""
    params = np.concatenate([np.zeros((1, 26), np.float32),
                             np.asarray(jsample_poses(jax.random.key(5), 2))])
    @jax.jit
    def jax_render(p):  # the JAX viewer's jitted render, over a batch
        tr = jfk(hand_model, p)
        centers = jlbs_keypoints(hand_model, tr)[..., :3]
        _, sphere_dm = jrender_sphere_hand(centers, hand_model.kp_radius, 64)
        return sphere_dm, jrender_depth_64(hand_model, tr)

    j_sphere, j_mesh = (np.asarray(a) for a in jax_render(jnp.asarray(params)))
    raster_cuda.reset_launch_counts()
    sphere_cuda.reset_launch_counts()
    sphere, mesh = (v.numpy() for v in interactive_viewer.render_views(port_hand, params))
    np.testing.assert_allclose(sphere, np.asarray(j_sphere), atol=1e-3, rtol=1e-5)
    assert mesh.shape == (3, 64, 64) and ((mesh < 100.0) == (j_mesh < 100.0)).all()
    d = np.abs(mesh - j_mesh)
    assert np.median(d) == 0.0 and (d > 1.0).mean() < 1e-3
    small = [v.numpy() for v in interactive_viewer.render_views(port_hand, params[0], 0.8)]
    assert small[0].shape == small[1].shape == (64, 64)
    assert (small[1] < 100.0).sum() < (mesh[0] < 100.0).sum()
    assert not any(raster_cuda.LAUNCHES.values()) and not any(sphere_cuda.LAUNCHES.values())


def test_measure_wobble_tiny_cpu_run(tmp_path):
    """16 crops served as one batch and as 2 x 8, both modes; no device
    times on the CPU; the JAX record's keys; a JAX record is refused."""
    art = tmp_path / "torch_wobble.json"
    out = measure_wobble.run(16, 8, 2, str(art), "cpu")
    with open(art) as f:
        assert json.load(f) == out
    with open(os.path.join(ROOT, "tests", "goldens", "precision_wobble.json")) as f:
        assert set(json.load(f)) <= set(out)
    assert out["batches"] == [16, 8] and out["backend"] == "cpu"
    for mode in ("default", "highest"):
        r = out[mode]
        assert np.isfinite([r["max_mm"], r["mean_mm"], r["p99_mm"]]).all()
        assert r["b128_ms_device"] is None and r["b1024_ms_device"] is None
    assert out["highest_cost_ratio_b128"] is None
    with pytest.raises(ValueError, match="JAX"):
        measure_wobble.run(16, 8, 2, os.path.join(ROOT, "tests", "goldens",
                                                  "precision_wobble.json"), "cpu")
