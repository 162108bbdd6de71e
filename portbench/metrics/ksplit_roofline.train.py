"""The KSplit linears' share of their roofline over the traced training
steps: the least time of the forward's KSplit linears at M = batch x
sequence rows (from ``work/<family>.py``; the backward runs plain
library matmuls) over the profiler's device time in the kernels named
here."""

KERNELS = ("ksplit_gemm_kernel",)


def read(ctx):
    f, sl = ctx.facts, ctx.slice
    if sl is None or f.get("kind") != "train":
        return None
    dev = sl.device_seconds(*KERNELS)
    if not dev:
        return None
    m = f["batch"] * f["seq"]
    return 100.0 * f["slice_steps"] * ctx.work.ksplit_seconds(
        ctx.config, m) / dev
