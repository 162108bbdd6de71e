"""The device's idle share while the host is in ``serve.retire_pass``:
the engine's pass at a decode step that retires a row (the drain, its
device-to-host sync; each row's finalize; refills; the decode state
staged anew).  Idle seconds of the traced burst inside that span
(:mod:`portbench.span_idle`) over the burst's window."""

from portbench import span_idle

SPAN = "serve.retire_pass"


def read(ctx):
    return span_idle.share(ctx, SPAN)
