"""Median host time of a keyframe switch on the loop (``node.switch``: the
state's copy for the worker and the hand-off), program-traced window."""

from benchmark import spans, stats


def read(ctx):
    tw = spans.window(ctx)
    if tw is None:
        return None
    ms = spans.host_ms(tw, "node.switch")
    return stats.percentile(ms, 50) if ms else None
