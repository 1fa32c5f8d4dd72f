"""Timing and tracing harness (counterpart of
``rpg_open_remode_tpu/utils/profiling.py``; the reference's StopWatch,
include/cuda_toolkit/helper_timer.h:28-60, and the per-update wall clocks of
test/dataset_main.cpp:101-135).

PyTorch launches CUDA work asynchronously, so a host clock around a launch
measures the enqueue: ``force`` fetches a scalar (which waits for the
device), and ``Timer.amortized`` times a chain of calls between CUDA events
when they run on the GPU. ``FrameClock`` times each call of a loop between
CUDA events; ``graph_ms`` times a kernel wrapper replayed from a CUDA graph
(no host launch cost); ``device_busy_ms`` reads the device's busy time
from a ``torch.profiler`` run; ``profiled`` runs a block under the profiler
and checks that the session's end was recorded; ``phase_ms`` puts a
phase's wall, device-span and device-busy time side by side; ``MetricsLog``
writes the per-frame stats as newline-delimited JSON (the structured analog
of src/depthmap_node.cpp:119-123).

These clocks time the program from outside. ``TRACER`` records spans from
inside it: the node, the facade's staging and the programs open ``span``s
at their boundaries, which cost one flag read while the tracer is off (the
default) and are switched on and off by ``enable`` / ``disable`` alone;
``take`` returns what they recorded (``Records``, which writes itself out as
a Chrome trace).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
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


# -- the program's tracer ---------------------------------------------------------


ANCHOR_TRIES = 16   # anchor events recorded at an enable with device events


class _NoSpan:
    """What ``span`` returns while the tracer is off: one shared object whose
    entry and exit do nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


@dataclasses.dataclass
class Span:
    """A span as ``Records`` holds it: host times from ``time.perf_counter_ns``;
    ``device``, where the span timed the device, its interval from CUDA
    events put on the same clock by the enable's anchor."""

    name: str
    thread: int
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    frame: int | None
    label: str | None = None
    device: tuple[int, int] | None = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


@dataclasses.dataclass
class Records:
    """What the tracer recorded between ``enable`` and ``take``: its spans in
    the order they ended, each counter's samples ``(time_ns, value)``, the
    window ``(enable, disable)`` on the host clock, the anchor's error
    (the most by which a device time can read early or late, ns; None
    without device events) and the device spans that found the event pool
    spent."""

    spans: list[Span]
    counters: dict[str, list[tuple[int, float]]]
    window: tuple[int, int]
    anchor_error_ns: int | None = None
    dropped: int = 0

    def write_chrome_trace(self, path: str) -> None:
        """The records as a Chrome trace (Perfetto reads it): the spans by
        thread in process 0, their device intervals in process 1, the
        counters as counter tracks; times in microseconds."""
        t0 = self.window[0]
        events = [{"name": "process_name", "ph": "M", "pid": 0, "args": {"name": "host"}},
                  {"name": "process_name", "ph": "M", "pid": 1, "args": {"name": "device"}}]
        for s in self.spans:
            args = {"id": s.id, "parent": s.parent, "frame": s.frame, "label": s.label}
            events.append({"name": s.name, "ph": "X", "pid": 0, "tid": s.thread,
                           "ts": (s.start_ns - t0) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                           "args": args})
            if s.device is not None:
                events.append({"name": s.name, "ph": "X", "pid": 1, "tid": 0,
                               "ts": (s.device[0] - t0) / 1e3,
                               "dur": (s.device[1] - s.device[0]) / 1e3, "args": args})
        for name, samples in self.counters.items():
            events += [{"name": name, "ph": "C", "pid": 0, "ts": (t - t0) / 1e3,
                        "args": {name: v}} for t, v in samples]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


class _Thread(threading.local):
    """A thread's open spans, innermost last, and the frame number its root
    spans take (``carried``)."""

    def __init__(self):
        self.stack = []
        self.frame = None


class _OpenSpan:
    __slots__ = ("tracer", "name", "label", "frame", "device", "id", "parent", "stack",
                 "t0", "pair", "range")

    def __init__(self, tracer, name, label, frame, device):
        self.tracer, self.name, self.label = tracer, name, label
        self.frame, self.device = frame, device

    def __enter__(self):
        tr = self.tracer
        local = tr._thread
        stack = self.stack = local.stack
        if stack:
            self.parent = stack[-1].id
            if self.frame is None:
                self.frame = stack[-1].frame
        else:
            self.parent = None
            if self.frame is None:
                self.frame = local.frame
        self.id = next(tr._ids)
        stack.append(self)
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.pair = None
        if self.device and tr._events:
            i = 2 * next(tr._cursor)
            if i + 1 < len(tr._events):
                tr._events[i].record()
                self.pair = i
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self.tracer
        if self.pair is not None:
            tr._events[self.pair + 1].record()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.stack.pop()
        tr._spans.append((self.name, threading.get_ident(), self.t0, t1, self.id, self.parent,
                          self.frame, self.label, self.pair))
        return False


class Tracer:
    """Spans and counters recorded inside the program. Off until ``enable``;
    while off, ``span`` returns ``NO_SPAN`` after one read of ``on``, and
    ``gauge`` records nothing. While on, each span records its name, label,
    thread, start and end on ``time.perf_counter_ns``, its parent (the span
    open on its thread when it began) and a frame number (given, else its
    parent's, else the thread's ``carried`` one); while ``torch.profiler`` is
    active it also opens a ``record_function`` range of its name, so that
    the profiler's trace shows it. A span opened with ``device=True`` also
    records a CUDA event on the current stream at its entry and at its
    exit, from a pool allocated by ``enable``; the events are read only in
    ``take``."""

    def __init__(self):
        self.on = False
        self._thread = _Thread()
        self._reset()

    def _reset(self):
        self._spans: list = []
        self._counters: dict = {}
        self._ids = itertools.count()
        self._cursor = itertools.count()
        self._events: list = []
        self._anchor = None
        self._window = [0, 0]

    def enable(self, events: int = 0) -> None:
        """Start recording, dropping what was recorded before. ``events``:
        device spans that get CUDA events (a pool of ``2 * events``, on the
        current device); with any, an anchor event is recorded and waited on
        between two reads of the host clock, ``ANCHOR_TRIES`` times, and the
        tightest of them puts every event's time on the host clock."""
        self.on = False
        self._reset()
        if events > 0:
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(2 * events)]
            torch.cuda.synchronize()
            for _ in range(ANCHOR_TRIES):
                anchor = torch.cuda.Event(enable_timing=True)
                before = time.perf_counter_ns()
                anchor.record()
                anchor.synchronize()
                after = time.perf_counter_ns()
                # the anchor completed between the two reads: put at their
                # midpoint, device times are off by at most half their
                # distance; the closest pair is kept
                if self._anchor is None or after - before < 2 * self._anchor[2]:
                    self._anchor = (anchor, (before + after) // 2, (after - before + 1) // 2)
        self._window[0] = time.perf_counter_ns()
        self.on = True

    def disable(self) -> None:
        """Stop recording; what was recorded stays for ``take``."""
        if self.on:
            self._window[1] = time.perf_counter_ns()
        self.on = False

    def span(self, name: str, label: str | None = None, *, frame: int | None = None,
             device: bool = False):
        if not self.on:
            return NO_SPAN
        return _OpenSpan(self, name, label, frame, device)

    def gauge(self, name: str, value: float) -> None:
        """A counter's value now."""
        if self.on:
            self._counters.setdefault(name, []).append((time.perf_counter_ns(), value))

    def frame(self) -> int | None:
        """The frame number this thread's spans take now."""
        local = self._thread
        return local.stack[-1].frame if local.stack else local.frame

    def carried(self, fn: Callable) -> Callable:
        """``fn``, to be run on another thread, with this thread's frame
        number for the spans it opens there (``fn`` itself while off)."""
        if not self.on:
            return fn
        frame = self.frame()
        local = self._thread

        def run(*args, **kwargs):
            saved, local.frame = local.frame, frame
            try:
                return fn(*args, **kwargs)
            finally:
                local.frame = saved
        return run

    def take(self) -> Records:
        """What was recorded since ``enable`` (and clears it). With device
        events this waits for the device once, then reads each span's pair
        against the anchor."""
        spans, counters = self._spans, self._counters
        self._spans, self._counters = [], {}
        end = self._window[1] if not self.on else time.perf_counter_ns()
        error, dropped, out = None, 0, []
        if self._anchor is not None:
            torch.cuda.synchronize()
            anchor, at, error = self._anchor
            dropped = max(0, next(self._cursor) - len(self._events) // 2)

        def on_host(ev):
            return at + round(anchor.elapsed_time(ev) * 1e6)

        for name, thread, t0, t1, sid, parent, frame, label, pair in spans:
            dev = None
            if pair is not None:
                dev = (on_host(self._events[pair]), on_host(self._events[pair + 1]))
            out.append(Span(name, thread, t0, t1, sid, parent, frame, label, dev))
        return Records(out, counters, (self._window[0], end), error, dropped)


TRACER = Tracer()
enable = TRACER.enable
disable = TRACER.disable
take = TRACER.take
span = TRACER.span
gauge = TRACER.gauge
carried = TRACER.carried
