"""Median host time of the matcher regime's choice on the host
(``programs.regime``), program-traced window."""

from benchmark import spans, stats


def read(ctx):
    tw = spans.window(ctx)
    if tw is None:
        return None
    ms = spans.host_ms(tw, "programs.regime")
    return stats.percentile(ms, 50) if ms else None
