"""The training step's share of the chip's peak: the model's FLOPs per
step (``work/<family>.py``: three times the forward's matmul and causal
attention FLOPs), charged at 989 TFLOP/s, over the traced steps' wall
time per step."""

from portbench import peaks


def read(ctx):
    f, sl = ctx.facts, ctx.slice
    if sl is None or f.get("kind") != "train" or not f.get("slice_steps"):
        return None
    flops = ctx.work.train_step_flops(ctx.config, f["batch"], f["seq"])
    step_s = sl.window_s / f["slice_steps"]
    return 100.0 * flops / peaks.BF16_FLOPS / step_s
