"""Median host time of a graph launch (``programs.replay``), program-traced
window."""

from benchmark import spans, stats


def read(ctx):
    tw = spans.window(ctx)
    if tw is None:
        return None
    ms = spans.host_ms(tw, "programs.replay")
    return stats.percentile(ms, 50) if ms else None
