"""Median device time of a frame: CUDA events recorded on the loop's
stream before and after each ``process_frame`` call."""

from benchmark import stats


def read(ctx):
    ms = ctx["window"].device_ms()
    return stats.percentile(ms, 50) if ms else None
