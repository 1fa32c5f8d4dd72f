"""Timing and tracing harness (counterpart of
``rpg_open_remode_tpu/utils/profiling.py``; the reference's StopWatch,
include/cuda_toolkit/helper_timer.h:28-60, and the per-update wall clocks of
test/dataset_main.cpp:101-135).

PyTorch launches CUDA work asynchronously, so a host clock around a launch
measures the enqueue: ``force`` fetches a scalar (which waits for the
device), and ``Timer.amortized`` times a chain of calls between CUDA events
when they run on the GPU. ``FrameClock`` times each call of a loop between
CUDA events; ``graph_ms`` times a kernel wrapper replayed from a CUDA graph
(no host launch cost); ``trace`` wraps ``torch.profiler`` and
``device_busy_ms`` reads the device's busy time from it; ``profiled``
runs a block under it and checks that the session's end was recorded;
``phase_ms`` puts a phase's wall, device-span and device-busy time side by
side; ``MetricsLog``
writes the per-frame stats as newline-delimited JSON (the structured analog
of src/depthmap_node.cpp:119-123).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable

import numpy as np
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
        tensor). When ``fn`` returns a CUDA tensor: a chain of n calls less
        a chain of one, over n - 1, each chain timed between CUDA events.
        On the CPU the calls run synchronously, so there is no fixed cost
        to subtract, and the difference of two chains would only add their
        noise (enough on a loaded host to reach zero): the best chain of n
        by the host clock around a scalar fetch, over n."""
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

        tn = min(run(n) for _ in range(repeats))
        if not on_cuda:
            return tn / n
        t1 = min(run(1) for _ in range(repeats + 1))
        return max((tn - t1) / (n - 1), 0.0)


class FrameClock:
    """Milliseconds of each timed call: CUDA events around it on a CUDA
    device (read once, at the end), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spans = []

    def __call__(self, fn):
        if self.cuda:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn()
            e.record()
            self.spans.append((s, e))
            return out
        t0 = time.perf_counter()
        out = fn()
        self.spans.append(1e3 * (time.perf_counter() - t0))
        return out

    def ms(self) -> np.ndarray:
        if self.cuda:
            torch.cuda.synchronize()
            return np.array([s.elapsed_time(e) for s, e in self.spans])
        return np.array(self.spans)


def graph_ms(fn, n: int = 20, reps: int = 7) -> float:
    """Device milliseconds per call of a CUDA kernel wrapper ``fn()``: ``n``
    calls captured in one CUDA graph, replayed ``reps`` times between CUDA
    events; the median replay over ``n``. The graph keeps the host's launch
    cost out of the time; the inputs stay in L2 from one call to the next."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


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


def device_busy_ms(prof, before: float | None = None) -> float | None:
    """Milliseconds in which the device ran anything, over a
    ``torch.profiler`` run: the union of its CUDA activity intervals (only
    those that start before ``before``, in the profiler's microseconds,
    when given); None when the profiler recorded no device activity."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and (before is None or e.time_range.start < before))
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


# The profiler can lose the last device records of a session, the more of
# them the longer the process has run (a session of kernel launches alone in
# a process some minutes old may keep none), while a session that ends in a
# PyTorch kernel keeps them. So a profiled session ends in a marker kernel
# of its own name and then a PyTorch op; only device work that started
# before the marker counts, and only a session whose marker was recorded is
# read.
END_MARKER = "spin_kernel"   # torch.cuda._sleep's kernel
PROFILE_ATTEMPTS = 3


def profiled(run: Callable[[], object]):
    """``run()`` (CUDA work on the current device) under ``torch.profiler``,
    then a device sync and the end marker. Returns ``(prof, marker)``,
    ``marker`` the marker kernel's start in the profiler's microseconds;
    repeated, up to PROFILE_ATTEMPTS sessions in all, until the profiler
    recorded the marker. Raises if it never did."""
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


def phase_ms(call: Callable[[int], object], k: int, device) -> dict:
    """Milliseconds a call of ``call(i)``, i = 0 .. k - 1, after one warm-up
    call. ``wall``: the host clock from the first enqueue to the end of a
    device sync. On a CUDA device also ``device``: CUDA events around the k
    calls (the device's span, idle gaps included), and ``busy``: the union
    of the device's activity over the k calls run again under
    ``torch.profiler`` (``profiled``). Both None on the CPU."""
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    call(0)
    sync()
    start = end = None
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    if cuda:
        start.record()
    for i in range(k):
        call(i)
    if cuda:
        end.record()
    sync()
    out = {"wall": 1e3 * (time.perf_counter() - t0) / k, "device": None, "busy": None}
    if cuda:
        out["device"] = start.elapsed_time(end) / k

        def run():
            for i in range(k):
                call(i)

        prof, marker = profiled(run)
        out["busy"] = (device_busy_ms(prof, before=marker) or 0.0) / k
    return out


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
