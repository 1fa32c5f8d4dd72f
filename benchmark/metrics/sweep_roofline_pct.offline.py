"""The sweep's least time over its device time in the trace, in %. The
least time of each sweep call is the larger of its bytes at 3.35 TB/s and
its ZNCC operations (12 hp + 11 a scored pair) at 67 TFLOP/s fp32
(``accounting.py``), counted from the traced frames' own disparity bands as
the reference recomputes them in the check."""

from benchmark import views


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    bound = ctx.get("sweep_bound_ms")
    if not bound:
        return None
    ms = views.device_ms(views.kernels(tr, pattern=views.SWEEP))
    return 100.0 * bound / ms if ms > 0 else None
