"""The CUDA rasterizers against their plain versions, on the card.

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


def _check_pair(fv, s, size):
    """Both kernels against their plain versions on one geometry."""
    records, box = raster_cuda.prepass_exact(fv, width=size)
    kernel = raster_cuda.launch_raster_exact(records, box, s, s, size)
    plain = rasterize_depth(fv, s, s, size, size)
    stats = contracts.exact_stats(kernel, plain)
    assert contracts.exact_ok(stats), stats
    records, box = raster_cuda.prepass_fast(fv)
    kernel = raster_cuda.launch_raster_fast_pooled(records, box, s, s, 100.0)
    plain = raster_cuda.raster_fast_pooled_plain(records, box, s, s, 100.0)
    torch.cuda.synchronize()
    assert float((kernel - plain).abs().max()) <= 1e-3


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


def test_render_counts_launches(hand_planes):
    model, _ = hand_planes
    gen = torch.Generator(device="cuda").manual_seed(1)
    poses = sample_poses(gen, 4)
    raster_cuda.reset_launch_counts()
    fast = synthesize(model, torch.Generator(device="cuda").manual_seed(2), poses)
    exact = synthesize(model, torch.Generator(device="cuda").manual_seed(2), poses, exact=True)
    assert raster_cuda.LAUNCHES == {"raster_fast_pooled": 1, "raster_exact": 1}
    stats = contracts.fast_stats(fast.dms * 100.0, exact.dms * 100.0)
    assert np.isfinite(stats["pooled_median"])
    tr = forward_kinematics(model, poses)
    assert render_depth_64(model, tr).shape == (4, 64, 64)


# ------------------------------------------------------------ sphere kernels


def _sphere_inputs(case: str, device):
    from spherehand_torch.render.adversarial import sphere_adversarial_case

    if case == "adversarial":
        arrays = sphere_adversarial_case()
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


@pytest.mark.parametrize("case", ["random_225", "adversarial"])
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
    assert sphere_cuda.LAUNCHES == {
        "sphere_fused_primal": 1, "sphere_fused_fwd": 1, "sphere_fused_bwd": 1}
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
    assert all(n >= 1 for n in raster_cuda.LAUNCHES.values()), raster_cuda.LAUNCHES
    assert all(n >= 1 for n in sphere_cuda.LAUNCHES.values()), sphere_cuda.LAUNCHES
