"""Device memory that the keyframes the node finalized in the program-traced
window hold at its end, GB: the counter ``node.keyframes_device_bytes``'s
last sample less its value when the window opened."""

from benchmark import spans


def read(ctx):
    tw = spans.window(ctx)
    if tw is None:
        return None
    samples = tw.counters.get("node.keyframes_device_bytes")
    return (samples[-1][1] - tw.held_bytes) / 1e9 if samples else None
