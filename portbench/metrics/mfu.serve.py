"""The serving model steps' share of the chip's peak over the traced
burst: each step's least time on the card (the larger of its FLOPs at
peak and its bytes at 3.35 TB/s: the weights once, each row's keys and
values, its new ones and its logits), summed over the burst's steps and
counting only rows that still need a token, over the burst's wall time.

The steps follow from the traffic: a prefill step per padded prompt
position, then a decode step per token after the first, while any row
still needs one (``work/<family>.py`` gives a step's least time)."""


def read(ctx):
    f, sl = ctx.facts, ctx.slice
    if sl is None or "slice_rows" not in f:
        return None
    rows, c = f["slice_rows"], ctx.config
    total = 0.0
    for s in range(f["slice_pad"]):
        total += ctx.work.decode_step_seconds(
            c, [s + 1 for L, _ in rows if L > s])
    for t in range(1, max(n for _, n in rows)):
        total += ctx.work.decode_step_seconds(
            c, [L + t for L, n in rows if n > t])
    return 100.0 * total / sl.window_s
