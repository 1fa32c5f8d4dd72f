"""Tracing a window under ``torch.profiler`` and reducing the trace.

``profiled`` is a frozen copy of rpg_open_remode_tpu_torch/utils/profiling.
profiled: the profiler can lose a session's last device records, so a
session ends in a marker kernel of its own name and then a PyTorch op; only
device work that started before the marker counts, and only a session whose
marker was recorded is read. ``Trace`` holds the reduced records.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from benchmark import stats

END_MARKER = "spin_kernel"   # torch.cuda._sleep's kernel
PROFILE_ATTEMPTS = 3
WINDOW = "bench.window"      # the traced frames' host range


@dataclasses.dataclass
class Trace:
    """A traced window: device operations ``(name, start_us, end_us)`` and
    host ranges ``(name, start_us, end_us)`` on the profiler's clock, the
    window ``(start_us, end_us)`` and the frames it fed."""
    device: list
    host: list
    window: tuple
    frames: int

    def busy_us(self) -> float:
        return stats.union_length([(s, e) for _, s, e in self.device], *self.window)


def profiled(run: Callable[[], object]):
    """``run()`` under ``torch.profiler``, then a device sync and the end
    marker. Returns ``(prof, marker_us)``; repeated, up to PROFILE_ATTEMPTS
    sessions, until the profiler recorded the marker. Raises if it never
    did."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.ones(1, device="cuda").sum()
            torch.cuda.synchronize()
        marks = [e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and END_MARKER in e.name]
        if marks:
            return prof, min(marks)
    raise RuntimeError(f"the profiler lost the end of {PROFILE_ATTEMPTS} sessions in a row")


def reduce(prof, marker_us: float, frames: int, labels: set) -> Trace:
    """The trace of a ``profiled`` session: device operations that started
    inside the ``WINDOW`` range and before the marker (the harness's own
    ``labels``, which the profiler also shows on the device, left out), and
    every host range."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host, window = [], [], None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if e.name not in labels and END_MARKER not in e.name:
                device.append((e.name, s, t))
        else:
            host.append((e.name, s, t))
            if e.name == WINDOW:
                window = (s, marker_us)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} range")
    device = [d for d in device if window[0] <= d[1] < window[1]]
    return Trace(device=device, host=host, window=window, frames=frames)
