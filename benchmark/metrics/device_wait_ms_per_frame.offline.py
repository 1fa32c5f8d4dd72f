"""The loop's host time waiting on the device, ms a frame: ``node.stats_wait``,
``programs.staging_wait`` and ``programs.refs_wait`` over the frames fed,
program-traced window."""

from benchmark import spans


def read(ctx):
    tw = spans.window(ctx)
    if tw is None:
        return None
    if not tw.frames:
        return None
    return sum(sum(spans.host_ms(tw, name)) for name in spans.WAITS) / tw.frames
