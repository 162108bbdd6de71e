"""``train_steps``: back-to-back calls of the step that
``repro_torch.train.train_step.make_train_step`` returns, on batches
made from the seed (Zipf tokens over the vocabulary, every row new).

Set-up builds one object, the step with its model and AdamW state, and
drives it through its first ``check_steps`` steps through the window's
own call and feed: their losses, each weight's norm of the first
gradient as the optimizer got it (its first moment after one step, over
``1 - b1``) and each weight's norm of its change over those steps are
read then.  The same object runs the window.  The window starts no step
after ``--seconds``; its time is the whole time of the steps it started,
ending in a synchronise.  A traced run profiles two steps of it.

After the window the program's state is freed and the reference follows
the first steps from the same dense weights and batches
(:func:`portbench.reference.checks.train_readings`).
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from portbench import inputs
from portbench.devtrace import sync

#: the traced run profiles these steps of the window
TRACED_STEPS = (1, 2)


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.workload["traffic"]
        self.batch, self.seq = int(t["batch"]), int(t["seq"])
        self.probs = inputs.zipf_probs(ctx.config["vocab_size"], t["zipf_a"])
        self.arch = ctx.family.arch(ctx.config)

    def batch_at(self, k: int) -> tuple:
        """(tokens, labels) [batch, seq] of step k, on the device."""
        gen = inputs.rng(self.ctx.seed, f"batch/{k}")
        rows = inputs.zipf_tokens(gen, self.probs,
                                  self.batch * (self.seq + 1))
        rows = torch.from_numpy(rows).view(self.batch, self.seq + 1)
        rows = rows.to(self.ctx.device)
        return rows[:, :-1], rows[:, 1:]

    def _step(self, k: int):
        tokens, labels = self.batch_at(k)
        self.params, self.opt, m = self.step(
            self.params, self.opt, {"tokens": tokens, "labels": labels})
        return m

    def setup(self) -> None:
        from repro_torch.optim import adamw
        from repro_torch.train.train_step import make_train_step
        ctx = self.ctx
        o = ctx.workload["traffic"]["optimizer"]
        self.ocfg = adamw.AdamWConfig(
            lr_peak=o["lr"], warmup_steps=o["warmup_steps"],
            total_steps=o["total_steps"], b1=o["b1"], b2=o["b2"],
            eps=o["eps"], weight_decay=o["weight_decay"],
            grad_clip=o["grad_clip"])
        self.params = ctx.family.build(ctx.config, ctx.seed, ctx.device)
        self.opt = adamw.init(self.params, self.ocfg)
        self.step = make_train_step(
            self.arch, self.ocfg, int(ctx.workload["traffic"]
                                      ["microbatches"]),
            tune_params=self.params, tune_tokens=self.batch * self.seq)
        names = [lf.name for lf in ctx.family.REFERENCE.leaves(ctx.config)]
        t0 = time.perf_counter()
        self.losses = []
        n = int(ctx.workload["traffic"]["check_steps"])
        for k in range(n):
            self.losses.append(float(self._step(k)["loss"]))
            if k == 0:
                b1 = 1.0 - self.ocfg.b1
                self.grad1 = {
                    nm: float(torch.linalg.vector_norm(
                        ctx.family.read(self.opt.mu, nm))) / b1
                    for nm in names}
        t1 = time.perf_counter()
        ref = ctx.family.REFERENCE
        self.change = {}
        for lf in ref.leaves(ctx.config):
            w0 = ref.stored(ctx.config, lf,
                            ref.dense(ctx.seed, lf, ctx.device))
            w = ctx.family.read(self.opt.master, lf.name)
            self.change[lf.name] = float(torch.linalg.vector_norm(w - w0))
            del w0, w
        self.next = n
        print(f"set-up: {n} first steps {t1 - t0:.4f} s, their readings "
              f"{time.perf_counter() - t1:.4f} s", flush=True)

    def window(self, seconds: float, trace: bool) -> dict:
        from portbench.devtrace import Slice
        first, last = TRACED_STEPS[0], TRACED_STEPS[-1]
        steps, sl, traced = 0, None, 0
        sync()
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            if trace and steps == first:
                sl = Slice().__enter__()
            t0 = time.perf_counter()
            self._step(self.next)
            self.next += 1
            if sl is not None and steps <= last:
                sl.span("bench.train_step", t0, time.perf_counter())
                traced += 1
                if steps == last:
                    sl.__exit__(None, None, None)
            steps += 1
        sync()
        wall = time.perf_counter() - t_start
        if sl is not None and steps <= last:
            sl.__exit__(None, None, None)
        elif trace and sl is None:
            # a window shorter than the traced steps: trace one more
            sl = Slice()
            with sl:
                t0 = time.perf_counter()
                self._step(self.next)
                self.next += 1
                sl.span("bench.train_step", t0, time.perf_counter())
            traced = 1
        self.slice = sl
        tokens = steps * self.batch * self.seq
        print(f"train window: {steps} steps in {wall:.4f} s", flush=True)
        facts = {"kind": "train", "batch": self.batch, "seq": self.seq}
        if sl is not None:
            facts["slice_steps"] = traced
        return {"attempted": steps, "failed": 0,
                "metrics": {"train_tokens_per_s": (tokens / wall,
                                                   "tokens/s")},
                "facts": facts}

    def free(self) -> None:
        del self.params, self.opt, self.step
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self) -> list:
        """(name, reading, limit) of each number compared."""
        from portbench.reference import checks
        ctx = self.ctx
        self.free()
        t = ctx.workload["traffic"]
        ref = checks.train_readings(
            ctx.family.REFERENCE, ctx.config, ctx.seed, t["optimizer"],
            [self.batch_at(k) for k in range(len(self.losses))],
            ctx.device)
        return compare(self.losses, self.grad1, self.change, ref,
                       ctx.workload["limits"])


def leaf_gap(prog: dict, ref: dict, keep: list) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the
    reference's, against the larger of that leaf's reference norm and
    the median leaf's."""
    med = statistics.median(ref[k] for k in keep)
    worst = max(keep, key=lambda k: abs(prog[k] - ref[k])
                / max(ref[k], med))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], med), worst


def kept_leaves(ref: dict) -> list:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move by round-off alone."""
    med = statistics.median(ref["grad1"].values())
    return [k for k, g in ref["grad1"].items() if g >= 1e-3 * med]


def gaps(losses: list, grad1: dict, change: dict, ref: dict) -> dict:
    """Every number a training cell can compare: the first step's loss
    (the later steps' losses swing with the steps before them), the
    worst leaf's first gradient and the worst leaf's change, each as a
    gap against the reference."""
    keep = kept_leaves(ref)
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"])]
    g_gap, g_leaf = leaf_gap(grad1, ref["grad1"], keep)
    c_gap, c_leaf = leaf_gap(change, ref["change"], keep)
    print(f"train check: losses {losses} against {ref['loss']} (gaps "
          f"{loss}); worst "
          f"gradient leaf {g_leaf}, worst change leaf {c_leaf}; "
          f"{len(keep)} of {len(ref['grad1'])} leaves compared",
          flush=True)
    return {"loss_gap": loss[0], "grad_gap": g_gap, "change_gap": c_gap}


def compare(losses: list, grad1: dict, change: dict, ref: dict,
            limits: dict) -> list:
    """(name, reading, limit) of each number that the cell's limits name
    (a number with no upper reading has no limit and is only printed)."""
    got = gaps(losses, grad1, change, ref)
    return [(n, v, limits[n]) for n, v in got.items() if n in limits]
