"""Tracing and step timing.

Counterpart of ``spherehand_tpu/utils/profiling.py``:

- :func:`trace_steps` wraps a window of training steps in a
  ``torch.profiler`` trace (host and, on a GPU, device activity) and writes
  it as a Chrome / Perfetto trace into a directory;
- :class:`StepTimer` measures steps per second with one device sync a
  window, so timing never adds a sync to a step.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace_steps(log_dir: str):
    """Profile everything inside the context into ``log_dir/trace.json``
    (open it in Perfetto or chrome://tracing). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(value) -> None:
    """Wait until ``value`` (a tensor of the step, or None) is computed."""
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        torch.cuda.synchronize(value.device)


class StepTimer:
    """Windowed steps/sec: sync the device once per window, not per step."""

    def __init__(self, window: int = 100):
        self.window = window
        self._count = 0
        self._t0: float | None = None
        self.steps_per_sec = 0.0

    def tick(self, sync_value=None) -> bool:
        """Call once per step; returns True when a window just closed.

        ``sync_value``: any device tensor from this step; waited on at
        window edges so the measurement covers the device's work. The first
        tick starts the clock, so the first step (warm-up) is not counted.
        """
        if self._t0 is None:
            _sync(sync_value)
            self._t0 = time.perf_counter()
            self._count = 0
            return False
        self._count += 1
        if self._count >= self.window:
            self._close(sync_value)
            return True
        return False

    def finish(self, sync_value=None) -> float:
        """Close a partial window (the end of an epoch shorter than a
        window) and return its rate; 0.0 when it counted no step."""
        if self._t0 is not None and self._count > 0:
            self._close(sync_value)
        return self.steps_per_sec

    def _close(self, sync_value) -> None:
        _sync(sync_value)
        dt = time.perf_counter() - self._t0
        self.steps_per_sec = self._count / dt
        self._t0 = time.perf_counter()
        self._count = 0
