"""Device time of the kernels that are not the program's hand-written
ones (the plain PyTorch kernels of the frame step, the reseed and the
finalization), by name from the trace, over the frames fed."""

from benchmark import views


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    ops = views.kernels(tr, exclude=views.HAND_KERNELS)
    return views.device_ms(ops) / tr.frames if ops else None
