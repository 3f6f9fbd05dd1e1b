"""The CUDA rasterizers and sphere kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
file imports neither JAX nor the JAX package, so on a machine without JAX it
runs without the repository's conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spherehand_torch.data.sampler import sample_poses  # noqa: E402
from spherehand_torch.data.synthesizer import draw_synthesis, synthesize  # noqa: E402
from spherehand_torch.hand.assets import load_hand_model  # noqa: E402
from spherehand_torch.hand.kinematics import forward_kinematics  # noqa: E402
from spherehand_torch.hand.skinning import apply_scale, project_faces_planes  # noqa: E402
from spherehand_torch.render import contracts, raster_cuda  # noqa: E402
from spherehand_torch.render.adversarial import adversarial_cases  # noqa: E402
from spherehand_torch.render.raster import (  # noqa: E402
    bilinear_sample_positions,
    rasterize_depth,
    render_depth_64,
)

pytestmark = pytest.mark.cuda
CASES = adversarial_cases()


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    raster_cuda.build()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def hand_planes(cuda):
    model = load_hand_model(device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    poses = sample_poses(gen, 8)
    draws = draw_synthesis(gen, 8)
    tr = apply_scale(forward_kinematics(model, poses), draws.scale_u, 0.1)
    return model, project_faces_planes(model, tr, 640.0, draws.rand_f)


def _face_vertices(planes):
    u, v, z = planes
    return torch.stack([u, v, z], dim=-1).reshape(u.shape[0], -1, 3, 3)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _reversed(planes):
    """The same faces in reverse order."""
    batch = planes[0].shape[0]
    return tuple(p.reshape(batch, -1, 3).flip(1).reshape(batch, -1).contiguous() for p in planes)


def _check_pair(fv, s, size):
    """The three raster kernels, from planes, against their plain versions
    on one geometry; the raw fast kernel bit for bit, scanning and binned."""
    planes = raster_cuda.planes_of(fv)
    kernel = raster_cuda.launch_raster_exact(planes, s, s, size, size)
    plain = rasterize_depth(fv, s, s, size, size)
    stats = contracts.exact_stats(kernel, plain)
    assert contracts.exact_ok(stats), stats
    records, box = raster_cuda.prepass_fast(fv)
    kernel = raster_cuda.launch_raster_fast_pooled(planes, s, s, 100.0)
    plain = raster_cuda.raster_fast_plain(records, box, s, s, 100.0)
    torch.cuda.synchronize()
    assert float((kernel - plain).abs().max()) <= 1e-3
    plain = raster_cuda.raster_fast_plain(records, box, s, s)
    for binned in (False, True):
        kernel = raster_cuda._raster_fast(planes, s, s, binned)
        torch.cuda.synchronize()
        assert torch.equal(_bits(kernel), _bits(plain))


def test_kernels_match_plain_on_hands(hand_planes):
    _, planes = hand_planes
    s = torch.as_tensor(bilinear_sample_positions(64, 10), device="cuda")
    _check_pair(_face_vertices(planes), s, 640)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_kernels_match_plain_adversarial(cuda, case):
    _, faces, size = CASES[case]
    s = (torch.as_tensor(bilinear_sample_positions(64, 10), device=cuda) if size == 640
         else torch.arange(size, dtype=torch.float32, device=cuda))
    _check_pair(torch.as_tensor(faces, device=cuda), s, size)


@pytest.mark.parametrize("kernel", ["raster_fast_pooled", "raster_exact", "raster_fast"])
def test_ztile_kernels_are_order_free(hand_planes, kernel):
    """Two launches give the same bits, so does the reversed face order
    (the z-tile takes an atomic min on order-preserving keys), and one face
    covering the whole canvas (offscreen_tiny_giant) equals the plain
    version."""
    _, planes = hand_planes
    s = torch.as_tensor(bilinear_sample_positions(64, 10), device="cuda")

    def launch(p):
        if kernel == "raster_exact":
            return raster_cuda.launch_raster_exact(p, s, s, 640, 640)
        if kernel == "raster_fast":
            return raster_cuda.launch_raster_fast(p, s, s)
        return raster_cuda.launch_raster_fast_pooled(p, s, s, 100.0)

    first, again, flipped = launch(planes), launch(planes), launch(_reversed(planes))
    torch.cuda.synchronize()
    assert torch.equal(_bits(first), _bits(again))
    assert torch.equal(_bits(first), _bits(flipped))
    name, faces, size = CASES[0]
    assert name == "offscreen_tiny_giant" and size == 640
    fv = torch.as_tensor(faces, device="cuda")
    giant = launch(raster_cuda.planes_of(fv))
    if kernel == "raster_exact":
        plain = rasterize_depth(fv, s, s)
    else:
        clamp = 100.0 if kernel == "raster_fast_pooled" else None
        plain = raster_cuda.raster_fast_plain(*raster_cuda.prepass_fast(fv), s, s, clamp)
    torch.cuda.synchronize()
    assert (plain < 99).float().mean() > 0.3
    assert torch.equal(_bits(giant), _bits(plain))


def test_render_counts_launches(hand_planes):
    model, _ = hand_planes
    gen = torch.Generator(device="cuda").manual_seed(1)
    poses = sample_poses(gen, 4)
    raster_cuda.reset_launch_counts()
    fast = synthesize(model, torch.Generator(device="cuda").manual_seed(2), poses)
    exact = synthesize(model, torch.Generator(device="cuda").manual_seed(2), poses, exact=True)
    assert raster_cuda.LAUNCHES == {"raster_fast_pooled": 1, "raster_fast": 0, "raster_exact": 1}
    stats = contracts.fast_stats(fast.dms * 100.0, exact.dms * 100.0)
    assert np.isfinite(stats["pooled_median"])
    tr = forward_kinematics(model, poses)
    assert render_depth_64(model, tr).shape == (4, 64, 64)


# ------------------------------------------------------------ sphere kernels


def _sphere_inputs(case: str, device):
    from spherehand_torch.render.adversarial import sphere_adversarial_case, sphere_edge_case

    if case in ("adversarial", "edge"):
        arrays = sphere_adversarial_case() if case == "adversarial" else sphere_edge_case()
        views = 3
    else:  # the loss-stack scale of tools/tpu_sphere_parity.py: N = 225, J = 41
        rng = np.random.RandomState(77)
        views = 3
        centers = rng.uniform(-80, 80, (225, 41, 3)).astype(np.float32)
        radii = rng.uniform(4, 12, (41,)).astype(np.float32)
        target = np.full((75, 64, 64), 100.0, np.float32)
        target[:, 16:48, 16:48] = rng.uniform(-60, 60, (75, 32, 32))
        arrays = (centers, target, radii)
    return (*(torch.as_tensor(a, device=device) for a in arrays), views)


@pytest.mark.parametrize("case", ["random_225", "adversarial", "edge"])
def test_sphere_kernels_match_plain(cuda, case):
    from spherehand_torch.render import sphere_cuda

    sphere_cuda.build()
    centers, target, radii, views = _sphere_inputs(case, cuda)
    stats = contracts.sphere_kernel_stats(centers, target, radii, 64, views,
                                          torch.Generator(device=cuda).manual_seed(0))
    if case == "adversarial":
        assert contracts.sphere_tie_violations(stats) == 0
    stats.pop("kernel")
    assert contracts.sphere_ok(stats), stats


def test_sphere_op_counts_launches(cuda):
    from spherehand_torch.render import sphere_cuda

    centers, target, radii, views = _sphere_inputs("random_225", cuda)
    sphere_cuda.reset_launch_counts()
    leaf = centers.clone().requires_grad_(True)
    depth, dist = sphere_cuda.sphere_min_depth_and_d2m(leaf, target, radii, 64, views)
    (depth.sum() + dist.sum()).backward()
    with torch.no_grad():
        sphere_cuda.sphere_min_depth_and_d2m(centers, target, radii, 64, views)
    fused = ("sphere_fused_primal", "sphere_fused_fwd", "sphere_fused_bwd")
    assert sphere_cuda.LAUNCHES == {k: int(k in fused) for k in sphere_cuda.LAUNCHES}
    assert leaf.grad.shape == centers.shape and torch.isfinite(leaf.grad).all()


def test_train_steps_on_card(cuda):
    """A small synthetic, combined and eval step on the card: finite
    metrics, and every kernel of the path launched."""
    from spherehand_torch.data.pseudo_real import render_multiview_batch
    from spherehand_torch.render import sphere_cuda
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.steps import RealBatch, build_steps

    model = load_hand_model(device=cuda)
    fns = build_steps(EngineConfig(synt_batch=4, real_batch=2), hand=model)
    gen = torch.Generator(device=cuda).manual_seed(3)
    state = fns.init_state(gen)
    raster_cuda.reset_launch_counts()
    sphere_cuda.reset_launch_counts()
    batch = RealBatch(*render_multiview_batch(model, gen, 2)[:4])
    state, synt_metrics = fns.synt_step(state, 1e-3, fns.draw(gen, real=False))
    state, comb_metrics, _ = fns.combined_step(state, 1e-3, fns.draw(gen), batch, True)
    eval_metrics, denoised = fns.eval_step(state, fns.draw(gen, synt=False), batch)
    for metrics in (synt_metrics, comb_metrics, eval_metrics):
        assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
    assert denoised.shape == (2, 41, 3)
    assert all(raster_cuda.LAUNCHES[k] >= 1 for k in ("raster_fast_pooled", "raster_exact")), \
        raster_cuda.LAUNCHES
    assert all(sphere_cuda.LAUNCHES[f"sphere_fused_{k}"] >= 1 for k in ("primal", "fwd", "bwd")), \
        sphere_cuda.LAUNCHES


def test_raster_fast_on_a_non_uniform_grid(hand_planes):
    """Sample counts that are no multiple of 8, unevenly spaced: bit for
    bit, scanning and binned."""
    _, planes = hand_planes
    sx = torch.sort(torch.rand(100, generator=torch.Generator(device="cuda").manual_seed(4),
                               device="cuda") * 640.0).values
    sy = (torch.linspace(0.0, 1.0, 77, device="cuda") ** 2) * 639.0
    plain = raster_cuda.raster_fast_plain(*raster_cuda.prepass_fast(planes=planes), sx, sy)
    for binned in (False, True):
        kernel = raster_cuda._raster_fast(planes, sx, sy, binned)
        torch.cuda.synchronize()
        assert kernel.shape == (8, 77, 100)
        assert torch.equal(_bits(kernel), _bits(plain))


@pytest.mark.parametrize("case", ["random_225", "adversarial", "edge"])
@pytest.mark.parametrize("field", ["depth", "distance"])
def test_per_field_sphere_kernels_match_plain_and_fused(cuda, case, field):
    """The one-field kernels against their plain versions (the phase 6
    contract) and their planes equal to the fused kernel's bit for bit."""
    from spherehand_torch.render import sphere_cuda as sc

    centers, target, radii, views = _sphere_inputs(case, cuda)
    fields = sc.DEPTH if field == "depth" else sc.DIST
    stats = contracts.sphere_kernel_stats(centers, target, radii, 64, views,
                                          torch.Generator(device=cuda).manual_seed(0), fields)
    if case == "adversarial":
        assert contracts.sphere_tie_violations(stats) == 0
    fused = contracts.split_fused_planes(
        sc.launch_fields(sc.BOTH, centers, target, radii, 64, views, residuals=True))
    for ours, ref in zip(stats.pop("kernel")["fwd"], fused[fields]):
        assert contracts.same_bits(ours, ref)
    assert contracts.sphere_ok(stats), stats


def test_per_field_ops_launch_their_kernels(cuda):
    """sphere_min_depth, d2m_nearest, data_to_model_distance,
    mutual_projection and rasterize_fast on CUDA tensors launch kernels:
    forward + backward under autograd, the primal kernel without it."""
    from spherehand_torch.losses.multiview import mutual_projection
    from spherehand_torch.render import sphere_cuda as sc
    from spherehand_torch.render.sphere import data_to_model_distance

    centers, target, radii, _ = _sphere_inputs("random_225", cuda)
    z = target[:25].repeat(9, 1, 1)
    sc.reset_launch_counts()
    leaf = centers.clone().requires_grad_(True)
    (sc.sphere_min_depth(leaf, radii, 64).sum() + sc.d2m_nearest(z, leaf, radii, 64).sum()).backward()
    with torch.no_grad():
        sc.sphere_min_depth(centers, radii, 64)
        sc.d2m_nearest(z, centers, radii, 64)
    per_field = {f"{p}_{k}" for p in ("min_depth", "d2m") for k in ("primal", "fwd", "bwd")}
    assert sc.LAUNCHES == {k: int(k in per_field) for k in sc.LAUNCHES}
    sc.reset_launch_counts()
    poses = torch.eye(4, device=cuda).expand(2, 3, 4, 4)
    joints = centers[:6].reshape(2, 3, 41, 3).clone().requires_grad_(True)
    dms, projected = mutual_projection(poses, poses, joints, radii, 64)
    (dms.sum() + data_to_model_distance(target[:6].reshape(2, 3, 64, 64), joints, radii)).backward()
    assert dms.shape == (2, 3, 3, 64, 64) and projected.shape == (2, 3, 3, 41, 3)
    assert {k: v for k, v in sc.LAUNCHES.items() if v} == {
        "min_depth_fwd": 1, "min_depth_bwd": 1, "d2m_fwd": 1, "d2m_bwd": 1}
    with pytest.raises(ValueError, match="S\\*S"):
        data_to_model_distance(torch.full((1, 80, 80), 100.0, device=cuda), centers[:1], radii)
    raster_cuda.reset_launch_counts()
    s = torch.as_tensor(bilinear_sample_positions(64, 10), device=cuda)
    faces = torch.as_tensor(CASES[0][1], device=cuda)
    assert raster_cuda.rasterize_fast(s, s, face_vertices=faces).shape == (1, 128, 128)
    assert raster_cuda.LAUNCHES["raster_fast"] == 1
