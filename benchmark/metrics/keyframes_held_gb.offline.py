"""Device memory that the node's finalized keyframes hold, GB: the counter
``node.keyframes_device_bytes`` at the program-traced window's end (a node
started with that window)."""

from benchmark import spans


def read(ctx):
    tw = spans.window(ctx)
    if tw is None:
        return None
    samples = tw.counters.get("node.keyframes_device_bytes")
    return samples[-1][1] / 1e9 if samples else None
