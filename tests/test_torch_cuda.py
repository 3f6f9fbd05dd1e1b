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
