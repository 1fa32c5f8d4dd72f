"""The program-traced window that the readers of the program's spans read.

The harness's windows time the program from outside. With ``--trace 1`` the
harness feeds its own node for ``SECONDS`` more with the program's tracer on
(``rpg_open_remode_tpu_torch.utils.profiling``: spans, the device intervals
of its CUDA events, the keyframe bytes counter), right after the measured
window and before any profiler session (``harness.program_window``), and
keeps it in the run's context as ``program_trace``. ``report`` prints to
standard error the window's device idle time by the innermost loop span open
in each gap. A program without the tracer gives None, and so does every
reader of it.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys

from benchmark import stats

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
    the host clock (ns), the loop's thread, the frames fed, the node's
    keyframe bytes when the window opened, the anchor's error (ns) and the
    device spans that found no event."""
    spans: list
    counters: dict
    window: tuple
    loop: int
    frames: int
    held_bytes: float = 0
    anchor_error_ns: int | None = None
    dropped: int = 0


def window(ctx: dict) -> Traced | None:
    """The run's program-traced window; None without ``--trace 1`` or
    without the program's tracer."""
    return ctx.get("program_trace")


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


# -- the report ---------------------------------------------------------------------------

def report(tw: Traced) -> None:
    """The window's frames, length and device idle time by loop span, on
    standard error."""
    lo, hi = tw.window
    idle = idle_by_span(tw)
    total = sum(idle.values())
    parts = ", ".join(f"{k} {v / 1e9!r} s" for k, v in sorted(idle.items(), key=lambda x: -x[1]))
    print(f"program-traced window: {tw.frames} frames in {(hi - lo) / 1e9!r} s; device idle "
          f"{total / 1e9!r} s ({device_idle_pct(tw)!r} %), by the innermost loop span: {parts}; "
          f"node.frame covers {frame_cover_pct(tw)!r} % of the window; anchor error "
          f"{tw.anchor_error_ns} ns; device spans without events {tw.dropped}", file=sys.stderr)
