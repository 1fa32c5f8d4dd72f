"""Median over frames of a frame's own host time staging its inputs
(``programs.stage`` less its ``programs.staging_wait``: the copies into
pinned memory and the host-to-device enqueues, without the wait for a
pinned buffer, which ``device_wait_ms_per_frame.offline`` counts),
program-traced window."""

from benchmark import spans, stats


def read(ctx):
    tw = spans.window(ctx)
    if tw is None:
        return None
    ms = spans.per_frame_ms(tw, "programs.stage", own=True)
    return stats.percentile(ms, 50) if ms else None
