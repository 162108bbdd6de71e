"""Share of the prefill's token slots that held padding over the window:
the engine's own counters (``Engine.stats()["tokens"]``, prompt and
padded), read before and after the window."""


def read(ctx):
    got = ctx.facts.get("window_stats")
    if got is None:
        return None
    s0, s1 = got
    real = s1["tokens"]["prompt"] - s0["tokens"]["prompt"]
    pad = s1["tokens"]["padded"] - s0["tokens"]["padded"]
    return 100.0 * pad / (real + pad) if real + pad else None
