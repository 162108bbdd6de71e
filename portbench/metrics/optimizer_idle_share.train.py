"""The device's idle share while the host is in ``train.optimizer``:
AdamW's update (the global norm, the clip and every leaf's elementwise
passes).  Idle seconds of the traced steps inside that span
(:mod:`portbench.span_idle`) over the steps' window."""

from portbench import span_idle

SPAN = "train.optimizer"


def read(ctx):
    return span_idle.share(ctx, SPAN)
