"""Frames fed in the window over its whole time, which ends once the last
frame's update has completed and the finalizations it triggered have been
delivered (host clock)."""


from benchmark import stats


def read(ctx):
    w = ctx["window"]
    return stats.rate(w.fed, w.t1 - w.t0)
