"""Timing and tracing harness (counterpart of
``rpg_open_remode_tpu/utils/profiling.py``; the reference's StopWatch,
include/cuda_toolkit/helper_timer.h:28-60, and the per-update wall clocks of
test/dataset_main.cpp:101-135).

PyTorch launches CUDA work asynchronously, so a host clock around a launch
measures the enqueue: ``force`` fetches a scalar (which waits for the
device), and ``Timer.amortized`` times a chain of calls between CUDA events
when they run on the GPU. ``trace`` wraps ``torch.profiler``;
``MetricsLog`` writes the per-frame stats as newline-delimited JSON (the
structured analog of src/depthmap_node.cpp:119-123).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable

import torch


def force(x) -> float:
    """Wait for the device through a scalar fetch; returns the scalar."""
    return float(torch.sum(torch.as_tensor(x)))


class Timer:
    """Wall-clock statistics (mean/var as dataset_main reports them), with
    an amortized mode for asynchronous devices."""

    def __init__(self):
        self.samples: list[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    @property
    def mean(self) -> float:
        return sum(self.samples) / max(len(self.samples), 1)

    @property
    def var(self) -> float:
        m = self.mean
        return sum((s - m) ** 2 for s in self.samples) / max(len(self.samples), 1)

    def report(self) -> dict:
        return {"n": len(self.samples), "mean_s": self.mean, "var_s": self.var}

    @staticmethod
    def amortized(fn: Callable[[int], torch.Tensor], n: int = 16, repeats: int = 2) -> float:
        """Marginal seconds per call of ``fn(i)`` (a call that returns a
        tensor): a chain of n calls less a chain of one, over n - 1. When
        ``fn`` returns a CUDA tensor the chains are timed between CUDA
        events, else by the host clock around a scalar fetch."""
        on_cuda = torch.as_tensor(fn(0)).is_cuda   # also the warm-up call

        def run(k):
            if on_cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for i in range(k):
                    fn(i)
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3
            t0 = time.perf_counter()
            acc = None
            for i in range(k):
                r = fn(i)
                acc = r if acc is None else acc + r
            force(acc)
            return time.perf_counter() - t0

        t1 = min(run(1) for _ in range(repeats + 1))
        tn = min(run(n) for _ in range(repeats))
        return max((tn - t1) / (n - 1), 0.0)


@contextlib.contextmanager
def trace(path: str | None = None):
    """``torch.profiler`` over a block (CPU activity, and CUDA activity when
    a GPU is present); yields the profiler. With ``path`` the trace is
    written there as a Chrome trace (open in Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        prof.export_chrome_trace(path)


class MetricsLog:
    """Append-only NDJSON log of per-frame metric dicts."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.rows: list[dict] = []
        self._fh = open(path, "a") if path else None

    def log(self, frame: int, stats: dict) -> dict:
        row = {"frame": frame}
        for k, v in stats.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        self.rows.append(row)
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        return row

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
