"""Peak device memory of the window: ``torch.cuda.max_memory_allocated``
after a reset at the window's start, in GiB."""


def read(ctx):
    b = ctx.facts.get("peak_window_bytes")
    return None if b is None else b / 2 ** 30
