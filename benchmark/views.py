"""What the metric readers read: per-frame series of the measured window
and classes of the traced window's device operations."""

from __future__ import annotations

import re

# the program's hand-written kernels, by their names on the device
HAND_KERNELS = re.compile(
    r"\b(sweep_kernel|homography_warp_kernel|resample_rows_kernel|resample_cols_kernel"
    r"|tvl1_steps_kernel|seed_update_kernel)\b")
SWEEP = re.compile(r"\bsweep_kernel\b")
TRANSFERS = re.compile(r"^(Memcpy|Memset)")


def latencies_ms(w) -> list:
    """Each frame's completion less its due time (open loop), ms."""
    return [1e3 * (d - u) for d, u in zip(w.done, w.due)]


def late_ms(w) -> list:
    """How late each call started after its due time (open loop), ms."""
    return [1e3 * (c - u) for c, u in zip(w.call, w.due)]


def enqueue_ms(w) -> list:
    """Each ``process_frame`` call's host time, ms."""
    return [1e3 * (r - c) for c, r in zip(w.call, w.ret)]


def switch_frames(w) -> list:
    """Offsets in the window of the reference-setting frames and of the
    frame after each."""
    out = set()
    for t in w.refs:
        out.update((t - w.start, t - w.start + 1))
    return sorted(k for k in out if 0 <= k < w.fed)


def kernels(trace, pattern=None, exclude=None) -> list:
    """The traced kernels ``(name, start_us, end_us)`` (copies and fills
    left out) whose names match ``pattern`` and not ``exclude``."""
    return [d for d in trace.device if not TRANSFERS.match(d[0])
            and (pattern is None or pattern.search(d[0]))
            and (exclude is None or not exclude.search(d[0]))]


def device_ms(ops) -> float:
    return sum(e - s for _, s, e in ops) / 1e3
