"""Process start to the window's first frame: imports, the kernel library,
the frame bank, the engine with its graph captures, the warm-up (host
clock)."""


def read(ctx):
    return ctx["setup_s"]
