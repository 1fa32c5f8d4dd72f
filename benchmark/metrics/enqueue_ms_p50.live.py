"""Median host time of a ``process_frame`` call, with no sync (host clock
around each call)."""

from benchmark import stats, views


def read(ctx):
    ms = views.enqueue_ms(ctx["window"])
    return stats.percentile(ms, 50) if ms else None
