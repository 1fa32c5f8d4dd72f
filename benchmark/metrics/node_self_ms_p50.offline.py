"""Median self time of ``node.frame`` (its host time less its children's):
the node's, the facade's and the programs' own logic around the stages that
have spans, program-traced window."""

from benchmark import spans, stats


def read(ctx):
    tw = spans.window(ctx)
    if tw is None:
        return None
    ms = spans.self_ms(tw, "node.frame")
    return stats.percentile(ms, 50) if ms else None
