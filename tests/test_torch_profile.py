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
