"""Guards of the PyTorch port: no JAX code, and no silent CPU fallback."""
import ast
import os

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "spherehand_tpu"}


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "spherehand_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")
            if name in ("__import__", "import_module") and isinstance(node.args[0].value, str):
                yield node.args[0].value.split(".")[0]


def test_port_imports_no_jax():
    sources = _port_sources()
    assert len(sources) > 15
    for path in sources:
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        bad = FORBIDDEN & set(_imported_roots(tree))
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"


def test_entry_points_refuse_to_fall_back_to_cpu():
    """Without a GPU the default device raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.infer import PoseEstimator, load_params_npz
    from spherehand_torch.models.pose_denoiser import load_pose_denoiser

    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_hand_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_pose_denoiser()
    params = load_params_npz(os.path.join(ROOT, "assets", "pretrained", "synthetic_params.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PoseEstimator(params)
    assert load_hand_model(device="cpu").device.type == "cpu"
