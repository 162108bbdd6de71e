"""The device's idle share while the host is in ``model.forward``: the
Python of the served model steps (each decode step and prefill
position) that launches every layer's kernels.  Idle seconds of the
traced burst inside that span (:mod:`portbench.span_idle`) over the
burst's window."""

from portbench import span_idle

SPAN = "model.forward"


def read(ctx):
    return span_idle.share(ctx, SPAN)
