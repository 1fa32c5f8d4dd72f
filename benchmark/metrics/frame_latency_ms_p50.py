"""The 50th percentile over every frame of the window of its latency: the
host-clock time at which its completion event fired less its due time."""

from benchmark import stats, views


def read(ctx):
    lat = views.latencies_ms(ctx["window"])
    return stats.percentile(lat, 50) if lat else None
