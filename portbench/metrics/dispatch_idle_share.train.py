"""The device's idle share while the host is in ``model.forward``: the
Python of the training forward that launches every layer's kernels.
Idle seconds of the traced steps inside that span
(:mod:`portbench.span_idle`) over the steps' window."""

from portbench import span_idle

SPAN = "model.forward"


def read(ctx):
    return span_idle.share(ctx, SPAN)
