"""The device's idle share of the program-traced window, %: 100 x (1 - the
union of the device intervals of ``programs.replay`` and ``node.denoise``,
from the program's CUDA events around each graph launch and each TV-L1,
over the window)."""

from benchmark import spans


def read(ctx):
    tw = spans.window(ctx)
    if tw is None:
        return None
    return spans.device_idle_pct(tw) if spans.device_intervals(tw) else None
