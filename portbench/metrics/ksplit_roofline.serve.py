"""The KSplit linears' share of their roofline over the traced burst:
the least time of their work (every KSplit linear of every model step
at the microbatch's row count, from ``work/<family>.py``) over the
profiler's device time in the kernels named here."""

KERNELS = ("ksplit_gemm_kernel",)


def read(ctx):
    f, sl = ctx.facts, ctx.slice
    if sl is None or "slice_rows" not in f:
        return None
    dev = sl.device_seconds(*KERNELS)
    if not dev:
        return None
    steps = f["slice_pad"] + max(n for _, n in f["slice_rows"]) - 1
    return 100.0 * steps * ctx.work.ksplit_seconds(ctx.config,
                                                   f["batch"]) / dev
