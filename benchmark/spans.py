"""The program-traced window that the readers of the program's spans read.

The harness's windows time the program from outside. With ``--trace 1`` the
first reader of a program span runs one more window, after the harness's
windows and the check: a fresh engine and node over the cell's stream,
warmed up as the harness warms its own, fed for ``SECONDS`` with the
program's tracer on (``rpg_open_remode_tpu_torch.utils.profiling``: spans,
the device intervals of its CUDA events, the keyframe bytes counter), then
for the traffic's ``trace_frames`` under ``torch.profiler`` with the tracer
still on, so that the profiler's trace holds the program's spans as ranges.
It prints to standard error the window's device idle time by the innermost
loop span open in each gap, and the profiler window's idle gaps by range.
A program without the tracer gives None, and so does every reader of it.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import sys
import threading

import torch

from benchmark import harness, stats
from benchmark import profiling as bprof

SECONDS = 10.0          # the program-traced window
EVENTS = 16384          # device spans that get CUDA events in it
TIMED = ("programs.replay", "node.denoise")    # the spans that time the device
WAITS = ("node.stats_wait", "programs.staging_wait", "programs.refs_wait")
OTHER = "host: other"


@dataclasses.dataclass
class Traced:
    """The program-traced window: the program's spans (``name``, ``thread``,
    ``start_ns``, ``end_ns``, ``id``, ``parent``, ``frame``, ``label``,
    ``device``), its counters' samples ``(time_ns, value)``, the window on
    the host clock (ns), the loop's thread, the frames fed, the anchor's
    error (ns) and the device spans that found no event; from the profiler
    window, its device busy time a frame (ms)."""
    spans: list
    counters: dict
    window: tuple
    loop: int
    frames: int
    anchor_error_ns: int | None = None
    dropped: int = 0
    busy_ms_per_frame: float | None = None


def window(ctx: dict) -> Traced | None:
    """The cell's program-traced window, run once a context."""
    if "program_trace" not in ctx:
        ctx["program_trace"] = _run(ctx)
    return ctx["program_trace"]


def tracer():
    """The program's tracer module, None where the program has none."""
    from rpg_open_remode_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "TRACER") else None


# -- what the readers compute ---------------------------------------------------------

def named(tw: Traced, *names) -> list:
    return [s for s in tw.spans if s.name in names]


def host_ms(tw: Traced, name: str) -> list:
    """Host duration of each ``name`` span, ms."""
    return [(s.end_ns - s.start_ns) / 1e6 for s in named(tw, name)]


def _children_ns(tw: Traced) -> dict:
    """Each span's children's host time, ns, by the span's id."""
    children = {}
    for s in tw.spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0) + s.end_ns - s.start_ns
    return children


def self_ms(tw: Traced, name: str) -> list:
    """Each ``name`` span's duration less its children's, ms."""
    children = _children_ns(tw)
    return [(s.end_ns - s.start_ns - children.get(s.id, 0)) / 1e6 for s in named(tw, name)]


def per_frame_ms(tw: Traced, *names, own: bool = False) -> list:
    """Each frame's total host time in ``names`` spans, ms, over the frames
    that opened any; with ``own``, less the time of their children."""
    children = _children_ns(tw) if own else {}
    by = {}
    for s in named(tw, *names):
        by[s.frame] = by.get(s.frame, 0) + s.end_ns - s.start_ns - children.get(s.id, 0)
    return [v / 1e6 for k, v in by.items() if k is not None]


def device_intervals(tw: Traced) -> list:
    return [s.device for s in named(tw, *TIMED) if s.device is not None]


def device_idle_pct(tw: Traced) -> float:
    lo, hi = tw.window
    return 100.0 * (1.0 - stats.union_length(device_intervals(tw), lo, hi) / (hi - lo))


def frame_cover_pct(tw: Traced) -> float:
    """The share of the window that the loop's ``node.frame`` spans cover."""
    lo, hi = tw.window
    frames = [(s.start_ns, s.end_ns) for s in named(tw, "node.frame") if s.thread == tw.loop]
    return 100.0 * stats.union_length(frames, lo, hi) / (hi - lo)


def idle_by_span(tw: Traced) -> dict:
    """The device's idle time (ns) by the innermost loop span open at each
    gap's midpoint (``OTHER`` where none was)."""
    loop = sorted((s for s in tw.spans if s.thread == tw.loop), key=lambda s: s.start_ns)
    starts = [s.start_ns for s in loop]
    by = {}
    for a, b in stats.gaps(device_intervals(tw), *tw.window):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        open_ = [s for s in loop[max(0, i - 100):i] if mid < s.end_ns]
        name = min(open_, key=lambda s: s.end_ns - s.start_ns).name if open_ else OTHER
        by[name] = by.get(name, 0) + b - a
    return by


# -- the window ---------------------------------------------------------------------------

def _warm_engine(ctx: dict):
    """A fresh engine with every program the stream reaches captured (the
    harness's warm-up); returns it and the next stream position."""
    from rpg_open_remode_tpu_torch import Depthmap
    from rpg_open_remode_tpu_torch.config import RemodeConfig
    from rpg_open_remode_tpu_torch.models.node import DepthmapNode

    from benchmark.reference import match as ref_match
    from benchmark.reference.config import Config

    cell, stream = ctx["cell"], ctx["stream"]
    cam, tr = cell.config["camera"], cell.traffic
    engine = Depthmap(cam["width"], cam["height"], cam["fx"], cam["cx"], cam["fy"], cam["cy"],
                      cfg=RemodeConfig(**cell.config["remode"]), device=ctx["device"])
    node = DepthmapNode(engine, policy_stride=cell.config["policy_stride"])
    t = 0
    while t < tr["warmup_frames"] or not node.keyframes:
        stream.feed(node, t)
        t += 1
        if t >= tr["warmup_frames"] and not node.keyframes:
            node.flush()
        if t > 10 * tr["warmup_frames"]:
            raise RuntimeError("the warm-up finalized no keyframe")
    node.close()
    regimes = harness.reachable_regimes(stream.bank, Config(**cell.config["remode"]), cam)
    for regime, (r, j) in sorted(regimes.items()):
        if regime != ref_match.RECTIFIED:
            engine.set_reference_image(stream.bank.images[r], stream.bank.poses[r],
                                       *stream.bounds[r])
            engine.update(stream.bank.images[j], stream.bank.poses[j])
    return engine, t


def _run(ctx: dict) -> Traced | None:
    prog = tracer()
    if prog is None:
        return None
    from torch.profiler import record_function

    from rpg_open_remode_tpu_torch.models.node import DepthmapNode

    cell, stream = ctx["cell"], ctx["stream"]
    cuda = torch.device(ctx["device"]).type == "cuda"
    engine, t = _warm_engine(ctx)
    node = DepthmapNode(engine, policy_stride=cell.config["policy_stride"])
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    gaps = None
    try:
        prog.enable(events=EVENTS if cuda else 0)
        try:
            w = harness.drive(node, stream, t, cell.traffic, cuda, seconds=SECONDS)
            node.flush()
            if cuda:
                torch.cuda.synchronize()
        finally:
            prog.disable()
        rec = prog.take()
        tw = Traced(spans=rec.spans, counters=rec.counters, window=rec.window,
                    loop=threading.get_ident(), frames=w.fed,
                    anchor_error_ns=rec.anchor_error_ns, dropped=rec.dropped)
        if cuda:
            box = {"next": t + w.fed}

            def run():
                with record_function(bprof.WINDOW):
                    box["w"] = harness.drive(node, stream, box["next"], cell.traffic, cuda,
                                             frames=cell.traffic["trace_frames"], labelled=True)
                box["next"] += box["w"].fed

            prog.enable()
            try:
                prof, marker = bprof.profiled(run)
            finally:
                prog.disable()
                prog.take()
            # the spans' ranges, which the profiler also shows on the device,
            # are no device work
            labels = harness.LABELS | {s.name for s in tw.spans}
            trace = bprof.reduce(prof, marker, box["w"].fed, labels)
            tw.busy_ms_per_frame = trace.busy_us() / 1e3 / trace.frames
            gaps = harness.breakdown(trace)["idle_gaps"]
            del prof
    finally:
        node.close()
        del node, engine
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    _report(tw, gaps)
    return tw


def _report(tw: Traced, gaps) -> None:
    lo, hi = tw.window
    idle = idle_by_span(tw)
    total = sum(idle.values())
    parts = ", ".join(f"{k} {v / 1e9!r} s" for k, v in sorted(idle.items(), key=lambda x: -x[1]))
    print(f"program-traced window: {tw.frames} frames in {(hi - lo) / 1e9!r} s; device idle "
          f"{total / 1e9!r} s ({device_idle_pct(tw)!r} %), by the innermost loop span: {parts}; "
          f"node.frame covers {frame_cover_pct(tw)!r} % of the window; anchor error "
          f"{tw.anchor_error_ns} ns; device spans without events {tw.dropped}", file=sys.stderr)
    if gaps is not None:
        print(f"profiled window with the program's spans: device busy {tw.busy_ms_per_frame!r} "
              f"ms a frame; idle gaps by range: " + ", ".join(f"{k} {v!r} s" for k, v in gaps),
              file=sys.stderr)
