"""Median device time of an update's replay: the program's CUDA events
right before and after each update graph's launch (``programs.replay``
spans labelled ``update``), program-traced window."""

from benchmark import spans, stats


def read(ctx):
    tw = spans.window(ctx)
    if tw is None:
        return None
    ms = [(s.device[1] - s.device[0]) / 1e6 for s in spans.named(tw, "programs.replay")
          if s.device is not None and (s.label or "").startswith("update")]
    return stats.percentile(ms, 50) if ms else None
