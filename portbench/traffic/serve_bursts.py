"""``serve_bursts``: a closed loop of bursts through ``Engine.generate``.

A burst of ``burst`` requests is submitted at once; the next is sent when
the engine has drained and handed every result back.  Batch jobs that
arrive in bursts are the load the engine takes as it stands: it drains
synchronously.

Every burst holds the same multiset of sizes, drawn once from the traffic
file's ``sizes_seed``: prompt lengths and output lengths.  ``--seed``
draws the pairing of the sizes within each burst, the tokens (Zipf over
the vocabulary) and the weights.  So runs of different seeds do the same
amount of work.

A request's latency runs from its admission (the burst's submission) to
its completion: the moment the engine marks it done, with its tokens on
the host, which in masked mode is the step at which it reached its own
``max_new_tokens``.  The benchmark stamps both by its own clock
(:class:`Timed` notes when ``done`` is set).  A request that comes back
with an error, or with fewer tokens than it asked for, counts as failed
and as missing every latency limit.

The window starts no burst after ``--seconds``; its time is the whole
time of the bursts it ran.  A traced run profiles its first burst (set-up
has warmed every shape it uses).

After the window the program's state is freed and the reference reads a
sample of the finished requests, drawn from the seed, with the longest
among them (:func:`portbench.reference.checks.served_gaps`).
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import inputs

def _lengths(gen: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    """``n`` lengths, clipped to [lo, hi]: uniform, or lognormal given
    its ``median`` or its ``mean`` (before the clip) and ``sigma``."""
    lo, hi = int(spec["lo"]), int(spec["hi"])
    if spec["dist"] == "uniform":
        x = gen.integers(lo, hi + 1, size=n)
    elif spec["dist"] == "lognormal":
        sigma = float(spec["sigma"])
        median = (spec["median"] if "median" in spec
                  else spec["mean"] * math.exp(-sigma * sigma / 2))
        x = np.exp(gen.normal(math.log(median), sigma, size=n)).round()
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(x, lo, hi).astype(np.int64)


def timed_request():
    """The port's ``Request`` with the moment it is marked done stamped
    by the benchmark's clock (``t_done``)."""
    from repro_torch.serve import Request

    class Timed(Request):
        t_done = None

        def __setattr__(self, name, value):
            if name == "done" and value and self.t_done is None:
                object.__setattr__(self, "t_done", time.perf_counter())
            object.__setattr__(self, name, value)
    return Timed


class Traffic:
    """The requests of every burst of run ``seed``."""

    def __init__(self, t: dict, vocab: int, seed: int):
        self.seed = seed
        sizes = np.random.default_rng(int(t["sizes_seed"]))
        n = int(t["burst"])
        self.prompt_lens = _lengths(sizes, t["prompt_len"], n)
        self.new_tokens = _lengths(sizes, t["new_tokens"], n)
        self.probs = inputs.zipf_probs(vocab, t["zipf_a"])
        self.request = timed_request()

    def burst(self, b, new_tokens=None) -> list:
        order = inputs.rng(self.seed, f"burst/{b}/order").permutation(
            len(self.prompt_lens))
        gen = inputs.rng(self.seed, f"burst/{b}/tokens")
        reqs = []
        for i in order:
            prompt = inputs.zipf_tokens(gen, self.probs,
                                        self.prompt_lens[i])
            n = int(self.new_tokens[i] if new_tokens is None
                    else new_tokens)
            reqs.append(self.request(prompt=prompt, max_new_tokens=n))
        return reqs


def _failed(r) -> bool:
    return bool(r.error) or not r.done \
        or len(r.out_tokens) != r.max_new_tokens


def nearest_rank(values: list, q: float) -> float:
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        c, t = ctx.config, ctx.workload["traffic"]
        self.arch = ctx.family.arch(c)
        self.traffic = Traffic(t, c["vocab_size"], ctx.seed)

    def setup(self) -> None:
        """Weights from the seed, the engine, its plans, and one warm-up
        burst of the window's bucket (prefill and decode shapes)."""
        from repro_torch.serve import Engine, ServeConfig
        ctx = self.ctx
        sc = dict(ctx.workload["traffic"]["serve"])
        sc["buckets"] = tuple(sc["buckets"])
        t0 = time.perf_counter()
        self.params = ctx.family.build(ctx.config, ctx.seed, ctx.device)
        t1 = time.perf_counter()
        self.engine = Engine(self.arch, self.params, ServeConfig(**sc))
        self.engine.warmup()
        t2 = time.perf_counter()
        warm = ctx.workload["traffic"]["warmup_new_tokens"]
        self._generate(self.traffic.burst("warmup", new_tokens=warm))
        print(f"set-up: weights {t1 - t0:.4f} s, engine and plans "
              f"{t2 - t1:.4f} s, warm-up burst "
              f"{time.perf_counter() - t2:.4f} s", flush=True)

    def _generate(self, reqs: list) -> tuple[float, float]:
        """(submission, return) of one burst by the benchmark's clock."""
        t0 = time.perf_counter()
        self.engine.generate(reqs)
        return t0, time.perf_counter()

    def _traced(self, reqs: list):
        """One burst under the profiler: (slice, submission, return)."""
        from portbench.devtrace import Slice
        sl = Slice()
        with sl:
            t0, t1 = self._generate(reqs)
            sl.span("bench.burst", t0, t1)
        return sl, t0, t1

    def window(self, seconds: float, trace: bool) -> dict:
        self.done: list = []
        lat, bursts, tokens = [], [], 0
        sl = traced = None
        stats0 = self.engine.stats()
        t_start = time.perf_counter()
        t_end = t_start
        b = 0
        while time.perf_counter() - t_start < seconds:
            reqs = self.traffic.burst(b)
            if trace and b == 0:
                sl, t0, t1 = self._traced(reqs)
                traced = reqs
            else:
                t0, t1 = self._generate(reqs)
            t_end = t1
            for r in reqs:
                if _failed(r) or r.t_done is None:
                    lat.append(math.inf)
                else:
                    lat.append(r.t_done - t0)
                    tokens += r.max_new_tokens
                    self.done.append(r)
            bursts.append(t1 - t0)
            b += 1
        stats1 = self.engine.stats()
        wall = t_end - t_start
        self.slice = sl
        facts = {"kind": "serve",
                 "window_stats": (stats0, stats1),
                 "batch": self.engine.max_batch}
        if sl is not None:
            facts.update(slice_rows=[(len(r.prompt), r.max_new_tokens)
                                     for r in traced],
                         slice_pad=max(r.padded_to for r in traced))
        n_failed = sum(1 for x in lat if math.isinf(x))
        print(f"serve window: {len(bursts)} bursts in {wall:.4f} s "
              f"({', '.join(f'{x:.4f}' for x in bursts)}), "
              f"{len(lat)} requests, {n_failed} failed, latency median "
              f"{nearest_rank(lat, 0.5):.4f} s, p95 "
              f"{nearest_rank(lat, 0.95):.4f} s over {len(lat)}",
              flush=True)
        return {"attempted": len(lat), "failed": n_failed,
                "metrics": {
                    "serve_tokens_per_s": (tokens / wall, "tokens/s"),
                    "request_p95_s": (nearest_rank(lat, 0.95), "s")},
                "facts": facts}

    def free(self) -> None:
        del self.engine, self.params
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """The requests the reference reads: ``check_requests`` of the
        finished ones drawn from the seed, the one with the most served
        tokens always among them."""
        n = int(self.ctx.workload["traffic"]["check_requests"])
        done = self.done
        if not done:
            return []
        longest = max(range(len(done)),
                      key=lambda i: len(done[i].out_tokens))
        rest = [i for i in range(len(done)) if i != longest]
        pick = inputs.rng(self.ctx.seed, "check").permutation(rest)[:n - 1]
        return [{"prompt": [int(x) for x in done[i].prompt],
                 "served": [int(x) for x in done[i].out_tokens]}
                for i in [longest, *sorted(pick)]]

    def check(self) -> list:
        """(name, reading, limit) of each number compared."""
        from portbench.reference import checks
        ctx = self.ctx
        reqs = self.sample()
        self.free()
        if not reqs:
            return [("finished_requests_missing", 1.0, 0.0)]
        gaps = checks.served_gaps(ctx.family.REFERENCE, ctx.config,
                                  ctx.seed, reqs, ctx.device)
        limits = ctx.workload["limits"]
        return [("served_logit_gap", max(gaps),
                 limits["served_logit_gap"])]
