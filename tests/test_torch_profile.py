"""The profiler breakdown script's host-side pieces, on the CPU."""
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from spherehand_torch import profile_path  # noqa: E402


@pytest.mark.parametrize(
    "intervals, expected",
    [
        ([], 0.0),
        ([(0.0, 2.0)], 2.0),
        ([(0.0, 2.0), (5.0, 6.0)], 3.0),
        ([(5.0, 6.0), (0.0, 2.0), (1.0, 3.0)], 4.0),
        ([(0.0, 10.0), (2.0, 3.0), (4.0, 5.0)], 10.0),
        ([(0.0, 1.0), (1.0, 2.0)], 2.0),
    ],
)
def test_union_us(intervals, expected):
    assert profile_path.union_us(intervals) == expected


def test_main_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_path.main() == 2


def test_device_events_drop_user_annotations():
    from types import SimpleNamespace as NS

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [NS(device_type=cuda, is_user_annotation=False, name="kernel"),
              NS(device_type=cuda, is_user_annotation=True, name="Optimizer.step#Adam.step"),
              NS(device_type=cpu, is_user_annotation=False, name="aten::add")]
    prof = NS(events=lambda: events)
    assert [e.name for e in profile_path.device_events(prof)] == ["kernel"]



def test_issued_activities_count_the_runtime_calls_that_issue_device_work():
    from types import SimpleNamespace as NS

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    names = [(cpu, "cudaLaunchKernel"), (cpu, "cudaLaunchKernelExC"), (cpu, "cuLaunchKernel"),
             (cpu, "cudaMemcpyAsync"), (cpu, "cudaMemsetAsync"), (cpu, "cudaStreamSynchronize"),
             (cpu, "aten::add"), (cuda, "cudaLaunchKernel")]
    prof = NS(events=lambda: [NS(device_type=d, name=n) for d, n in names])
    assert profile_path.issued_activities(prof) == 5


@pytest.mark.parametrize(
    "recorded, issued, expected",
    [(10, 10, 1.0), (9, 10, 0.9), (1345, 1359, 1345 / 1359), (12, 10, 1.0), (3, 0, 1.0)],
)
def test_recorded_share(recorded, issued, expected):
    assert profile_path.recorded_share(recorded, issued) == expected
