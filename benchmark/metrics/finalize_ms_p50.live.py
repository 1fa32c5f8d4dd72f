"""Median host time of a keyframe's finalization on the worker thread
(``node.finalize``: TV-L1, download, delivery), program-traced window."""

from benchmark import spans, stats


def read(ctx):
    tw = spans.window(ctx)
    if tw is None:
        return None
    ms = spans.host_ms(tw, "node.finalize")
    return stats.percentile(ms, 50) if ms else None
