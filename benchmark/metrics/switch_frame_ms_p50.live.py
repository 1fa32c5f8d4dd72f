"""Median latency (completion less due time) of the frames that set a new
reference and of the frame after each: the reseed, and the frame that
follows the worker's finalization on the stream."""

from benchmark import stats, views


def read(ctx):
    w = ctx["window"]
    lat = views.latencies_ms(w)
    picked = [lat[k] for k in views.switch_frames(w) if k < len(lat)]
    return stats.percentile(picked, 50) if picked else None
