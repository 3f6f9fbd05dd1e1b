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
    assert profile_path.issued_activities(prof, profile_path.STREAM_SYNC_CALLS) == 1


@pytest.mark.parametrize(
    "recorded, issued, expected",
    [(10, 10, 1.0), (9, 10, 0.9), (1345, 1359, 1345 / 1359), (12, 10, 1.0), (3, 0, 1.0)],
)
def test_recorded_share(recorded, issued, expected):
    assert profile_path.recorded_share(recorded, issued) == expected


@pytest.mark.parametrize("tile, threads", [(32, 256), (64, 512), (64, 1024)])
def test_raster_sweep_variants_replace_the_z_tile_sizes(tile, threads):
    """The sweep's variants of csrc/raster.cu change kZTile, kZThreads and
    kPerThread (a scan round stays 1,024 faces) and nothing else."""
    import os

    from spherehand_torch import cuda_build, raster_sweep

    with open(os.path.join(cuda_build.CSRC_DIR, "raster.cu")) as fh:
        source = fh.read()
    assert raster_sweep.shipped_sizes(source) == (64, 512)
    variant = raster_sweep.variant_source(source, tile, threads)
    assert raster_sweep.shipped_sizes(variant) == (tile, threads)
    assert f"constexpr int kPerThread = {1024 // threads};" in variant
    changed = [a for a, b in zip(source.splitlines(), variant.splitlines()) if a != b]
    assert len(variant.splitlines()) == len(source.splitlines())
    assert all(ln.startswith(("constexpr int kZTile", "constexpr int kZThreads",
                              "constexpr int kPerThread")) for ln in changed)


def test_raster_sweep_refuses_without_cuda(monkeypatch):
    from spherehand_torch import raster_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert raster_sweep.main() == 2
