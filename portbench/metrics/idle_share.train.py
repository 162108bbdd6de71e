"""The device's idle share over the traced slice: one minus the union of
the kernel intervals on the profiler's timeline, over the slice's span
on the same timeline."""


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.kernels:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
