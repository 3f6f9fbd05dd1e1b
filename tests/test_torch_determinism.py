"""Deterministic settings of the evidence runs (``utils.determinism``) and
the evidence tools that switch them on before any work."""
import importlib
import os

import pytest

torch = pytest.importorskip("torch")

from spherehand_torch.utils import determinism  # noqa: E402

# Each evidence tool and the argument list its main() gets.
TOOLS = {
    "selfsup_demo": ["--device", "cpu"],
    "lite_mesh_e2e": ["--device", "cpu"],
    "train_synthetic_full": ["--device", "cpu"],
    "eval_synthetic": ["--device", "cpu"],
    "pole_study": ["--device", "cpu"],
    "measure_wobble": ["--device", "cpu"],
    "reference_recipe": ["--device", "cpu"],
    "recipe_artifact": [],
    "divergence_study": ["--device", "cpu"],
}


@pytest.fixture
def settings(monkeypatch):
    """Put back every global that enable() touches."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    saved = {"algorithms": torch.are_deterministic_algorithms_enabled(),
             "cudnn_deterministic": torch.backends.cudnn.deterministic,
             "cudnn_benchmark": torch.backends.cudnn.benchmark}
    yield
    determinism.restore(saved)


def test_enable_sets_every_flag_and_the_cublas_workspace(settings):
    torch.backends.cudnn.benchmark = True
    saved = determinism.enable()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert torch.are_deterministic_algorithms_enabled()
    assert not torch.is_deterministic_algorithms_warn_only_enabled()
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert saved["cudnn_benchmark"] is True
    determinism.restore(saved)
    assert torch.backends.cudnn.benchmark is True
    assert torch.are_deterministic_algorithms_enabled() == saved["algorithms"]


def test_enable_refuses_once_cuda_is_initialised(settings, monkeypatch):
    """Without the variable, an initialised CUDA may already hold a cuBLAS
    handle: enable() raises and changes nothing."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    before = torch.are_deterministic_algorithms_enabled()
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        determinism.enable()
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    assert torch.are_deterministic_algorithms_enabled() == before
    # with the variable already set, an initialised CUDA is fine
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    determinism.enable()
    assert torch.are_deterministic_algorithms_enabled()


class _Enabled(Exception):
    pass


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_each_evidence_tool_enables_determinism_first(name, monkeypatch):
    """A spy in place of enable() stops main() where it is called; nothing
    the tool does (devices, data, training) has happened before it."""
    tool = importlib.import_module(f"spherehand_torch.tools.{name}")
    calls = []

    def spy():
        calls.append(name)
        raise _Enabled

    def too_early(*_args, **_kwargs):
        raise AssertionError(f"{name} reached its device before enabling determinism")

    monkeypatch.setattr(determinism, "enable", spy)
    monkeypatch.setattr(tool, "resolve_device", too_early, raising=False)
    with pytest.raises(_Enabled):
        tool.main(TOOLS[name])
    assert calls == [name]
