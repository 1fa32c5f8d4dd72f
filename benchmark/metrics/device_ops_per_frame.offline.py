"""Device operations (kernels, copies, fills) in the traced window over the
frames it fed."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    return len(tr.device) / tr.frames
