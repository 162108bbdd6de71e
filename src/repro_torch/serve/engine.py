"""Serving engine: shape-bucketed batching with plan-warmed dispatch —
the masked-mode path of ``repro.serve.engine`` with ``refill``,
``prefix_cache`` and ``chunked_prefill`` off, greedy decoding only.

Requests are admitted into :class:`~repro_torch.serve.scheduler.
ShapeBucketScheduler` and drained as fixed-shape microbatches (bucket
batch × padded length).  A microbatch is right-padded; its prefill steps
the decode function over the padded prompt at a shared position, then
decode threads per-row positions and a KV visibility mask through
``forward_decode``.

Cache layout: row i's KV for position p lives in cache slot p, so a
request's visible keys occupy slots ``0 .. pos`` in the same places
whether it is served in a padded batch or alone.  Prefill writes padding
KV into slots ``L_i .. pad_len-1``; decode overwrites them one slot at a
time and the mask ``slot <= pos_i`` hides the rest.  (The reference
leaves a gap after the padded prompt; placing generated tokens right
after the prompt instead means no reduction ever sees a request's keys at
other offsets than in the unbatched run.)

Exactness: :meth:`generate_reference` serves each request alone — exact
prompt length, no padding, no other request in the batch — through the
same decode step at the engine's batch width (the idle rows repeat the
request, as the engine's filler rows do).  Every launch then has the
serving shapes, so cuBLAS and PyTorch's reductions pick the same
algorithms, and a row's result does not depend on the other rows; the
ksplit kernel's summation order does not depend on the row count at all.
Batched tokens must equal the reference's.

There is no ``jit`` to warm: :meth:`warmup` resolves every GEMM plan the
buckets need (and builds the CUDA kernels), and ``stats()`` counts the
*fresh* plan resolutions after warmup, which must stay 0.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.config import DEFAULT_PAD_LENS, ServeConfig
from repro_torch.serve.scheduler import (AdmissionError, BucketKey,
                                         QueueFullError,
                                         ShapeBucketScheduler)
from repro_torch.tune import dispatch

__all__ = ["DEFAULT_PAD_LENS", "Engine", "Request", "ServeConfig"]


@dataclasses.dataclass(eq=False)
class Request:
    prompt: np.ndarray            # int [S]
    max_new_tokens: int = 16
    temperature: float = 0.0      # only 0 (greedy) is ported
    fset: str = "default"         # format-set tag (weight variant)
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    bucket: str = ""
    padded_to: int = 0
    cold: bool = False
    latency_s: float = 0.0
    dispatch_paths: tuple = ()
    error: str = ""


class Engine:
    def __init__(self, cfg: ArchConfig, params,
                 config: Optional[ServeConfig] = None):
        config = config or ServeConfig()
        for flag in ("refill", "prefix_cache", "chunked_prefill"):
            if getattr(config, flag):
                raise NotImplementedError(
                    f"ServeConfig.{flag}=True is not ported yet: serve with "
                    "refill=False, prefix_cache=False, chunked_prefill=False")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: only dense (masked mode) is ported")
        self.config = config
        self.cfg, self.params = cfg, params
        self.device = params["embed"].device
        self.max_batch, self.max_seq = config.max_batch, config.max_seq
        #: weights per format-set tag (one tag until quantized variants
        #: are ported)
        self.variants = {"default": params}
        self.mode = "masked"
        # tune-once at setup: a plan for every mixed-precision layer at
        # the decode batch size
        dispatch.warm_registry()
        self.gemm_plans = dispatch.tune_linear_params(
            params, m_hint=self.max_batch)
        sched_cfg = config.scheduler_config(cfg.serve_buckets)
        fitting = tuple(p for p in sched_cfg.pad_lens
                        if p + 1 <= self.max_seq)
        if not fitting:
            raise ValueError(
                f"no serve bucket fits max_seq={self.max_seq} "
                f"(pad_lens={sched_cfg.pad_lens})")
        if fitting != sched_cfg.pad_lens:
            sched_cfg = dataclasses.replace(sched_cfg, pad_lens=fitting)
        self.metrics = MetricsRegistry()
        self.scheduler = ShapeBucketScheduler(
            sched_cfg, fsets=tuple(self.variants), mode=self.mode,
            max_prompt=self.max_seq - 1, metrics=self.metrics)
        # global counters at the end of warmup (None before warmup)
        self._fresh_at_warmup: Optional[int] = None
        self._linear_at_warmup: dict[str, int] = {}

    # ------------------------------------------------------------------
    # warmup: resolve every plan the buckets need, build the kernels
    # ------------------------------------------------------------------

    def warmup(self, keys=None) -> dict:
        """Resolve the GEMM plans of every configured bucket (or the
        given keys) at the decode batch and at m = 1, and build the CUDA
        kernels, so serving does no fresh work.  Returns a report."""
        keys = list(keys) if keys is not None else [
            k for k, b in self.scheduler.buckets.items() if b.configured]
        fresh0 = dispatch.fresh_resolutions()
        plan_table = dispatch.resolve_plans_for_buckets(
            self.variants,
            [(k.fset, self.scheduler.cfg.max_batch, k.pad_len)
             for k in keys])
        if self.device.type == "cuda":
            ops.ensure_built()
        report = {}
        for key in keys:
            bucket = self.scheduler.buckets[key]
            if key.pad_len + 1 > self.max_seq:
                raise AdmissionError(
                    f"bucket {key} does not fit max_seq {self.max_seq}")
            plans = {**plan_table.get((key.fset, 1), {}),
                     **plan_table.get((key.fset, bucket.batch), {})}
            bucket.paths = tuple(sorted({p.path for p in plans.values()}))
            bucket.warmed = True
            report[str(key)] = {"paths": list(bucket.paths)}
        self._fresh_at_warmup = dispatch.fresh_resolutions()
        self._linear_at_warmup = dispatch.dispatch_counts("linear")
        report["fresh_resolutions"] = self._fresh_at_warmup - fresh0
        return report

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> BucketKey:
        """Admit one request (raises AdmissionError / QueueFullError /
        NotImplementedError for temperature > 0).

        KV head-room: a row writes slots up to ``L + max_new - 2`` and
        its padded prefill up to ``pad_len - 1``, so ``pad_len + max_new
        - 1 <= max_seq`` bounds both; a request whose padded length
        breaks it but whose exact length fits gets an exact-length
        bucket."""
        if req.temperature > 0:
            raise NotImplementedError(
                "temperature sampling is not ported yet (greedy only)")
        L = len(req.prompt)
        if self.scheduler.pending() >= self.scheduler.cfg.max_queue:
            self.scheduler.reject()
            raise QueueFullError(
                f"admission queue full "
                f"({self.scheduler.cfg.max_queue} pending)")
        try:
            key = self.scheduler.bucket_for(L, req.fset, commit=False)
        except AdmissionError:
            self.scheduler.reject()
            raise
        use_exact = False
        if key.pad_len + req.max_new_tokens - 1 > self.max_seq:
            if L + req.max_new_tokens - 1 <= self.max_seq:
                use_exact = True
            else:
                self.scheduler.reject()
                raise AdmissionError(
                    f"prompt {L} (padded {key.pad_len}) + "
                    f"{req.max_new_tokens} new tokens exceeds max_seq "
                    f"{self.max_seq}")
        key = (self.scheduler.exact_bucket(L, req.fset) if use_exact
               else self.scheduler.bucket_for(L, req.fset))
        req._t_admit = time.perf_counter()
        return self.scheduler.admit(req, L, req.fset, key=key)

    def generate(self, requests: list[Request]) -> list[Request]:
        """Admit a list of requests and drain the queue; inadmissible
        requests come back with ``error`` set."""
        for r in requests:
            try:
                self.submit(r)
            except (AdmissionError, QueueFullError) as e:
                r.error = f"{type(e).__name__}: {e}"
        self.run()
        return requests

    def run(self) -> None:
        """Drain the admission queue, one microbatch at a time."""
        while True:
            mb = self.scheduler.next_microbatch()
            if mb is None:
                return
            bucket, reqs = mb
            if reqs:
                self._serve_microbatch(bucket, reqs)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Snapshot a host staging buffer onto the device.  The numpy copy
        comes first: ``torch.from_numpy`` aliases the buffer, and a copy
        that is still in flight must never see a later host write."""
        return torch.from_numpy(np.array(a)).to(self.device)

    def _run_rows(self, params, toks: np.ndarray, lengths: np.ndarray,
                  max_new: np.ndarray, on_retire=None) -> np.ndarray:
        """Prefill + greedy decode of one fixed-shape microbatch.

        ``toks`` [B, S] right-padded prompts, ``lengths`` [B] real
        lengths, ``max_new`` [B] tokens to generate (0 → filler row).
        ``on_retire(i, tokens)`` is called when row i finishes.  Returns
        the [steps, B] token history."""
        B, S = toks.shape
        m = self.metrics
        caches = T.init_cache(self.cfg, B, self.max_seq, self.device)
        toks_d = self._dev(toks)
        lengths_d = self._dev(lengths)
        rows = torch.arange(B, device=self.device)
        # prefill: step the decode function over the padded prompt
        step_tok = []
        for s in range(S):
            logits, caches = T.forward_decode(params, self.cfg,
                                              toks_d[:, s:s + 1], caches, s)
            step_tok.append(torch.argmax(logits[:, 0], dim=-1))
        m.counter("serve.prefill_steps").inc(S)
        cur = torch.stack(step_tok)[lengths_d - 1, rows]
        hist = [cur]
        emitted = np.ones(B, np.int64)
        active = (max_new > 1).astype(np.int64)
        retired = np.zeros(B, bool)

        def retire():
            done = [i for i in range(B) if not retired[i] and max_new[i] > 0
                    and emitted[i] >= max_new[i]]
            if not done:
                return False
            h = torch.stack(hist).cpu().numpy()    # syncs, at retirement
            for i in done:
                retired[i] = True
                active[i] = 0
                if on_retire is not None:
                    on_retire(i, [int(t) for t in h[:max_new[i], i]])
            return True

        retire()
        pos = lengths_d.clone()
        active_d = self._dev(active)
        kv_pos = torch.arange(self.max_seq, device=self.device)
        steps = 0
        while active.any():
            kv_valid = kv_pos[None, :] <= pos[:, None]
            logits, caches = T.forward_decode(
                params, self.cfg, cur[:, None], caches, pos, slot=pos,
                kv_valid=kv_valid)
            cur = torch.argmax(logits[:, 0], dim=-1)
            hist.append(cur)
            pos = pos + active_d
            emitted += active
            steps += 1
            if retire():
                active_d = self._dev(active)
        m.counter("serve.decode_steps").inc(steps)
        return torch.stack(hist).cpu().numpy()

    def _serve_microbatch(self, bucket, reqs: list[Request]) -> None:
        key = bucket.key
        params = self.variants[key.fset]
        S, B, n_real = key.pad_len, bucket.batch, len(reqs)
        was_warm = bucket.warmed
        if was_warm:
            bucket.hits += 1
        else:
            bucket.misses += 1
        m = self.metrics
        t0 = time.perf_counter()
        # right-pad prompts to the bucket length; unused slots repeat the
        # last request but generate nothing (max_new 0)
        toks = np.zeros((B, S), np.int64)
        lengths = np.zeros(B, np.int64)
        max_new = np.zeros(B, np.int64)
        for i in range(B):
            r = reqs[min(i, n_real - 1)]
            toks[i, :len(r.prompt)] = r.prompt
            lengths[i] = len(r.prompt)
            if i < n_real:
                max_new[i] = r.max_new_tokens

        def on_retire(i, tokens):
            r = reqs[i]
            r.out_tokens = tokens
            r.done = True
            r.bucket, r.padded_to, r.cold = str(key), S, not was_warm
            r.dispatch_paths = bucket.paths
            r.latency_s = time.perf_counter() - getattr(r, "_t_admit", t0)
            bucket.served += 1
            bucket.real_tokens += int(lengths[i])
            m.counter("serve.requests_served").inc()
            m.counter("serve.tokens_generated").inc(len(tokens))
            m.histogram("serve.request.latency_s").observe(r.latency_s)

        self._run_rows(params, toks, lengths, max_new, on_retire)
        bucket.padded_tokens += int(B * S - lengths[:n_real].sum())
        bucket.warmed = True
        m.counter("serve.serve_time_s").inc(time.perf_counter() - t0)
        m.histogram("serve.microbatch.size").observe(n_real)
        if n_real > 1:
            m.counter("serve.microbatch.multi").inc()

    # ------------------------------------------------------------------
    # unbatched reference
    # ------------------------------------------------------------------

    def generate_reference(self, requests: list[Request]) -> list[Request]:
        """Serve each request alone — exact prompt length, no padding, no
        co-batched request — at the engine's batch width (every row holds
        the request; row 0's tokens are kept).  The baseline the batched
        path must match token for token."""
        B = self.max_batch
        for r in requests:
            if r.temperature > 0:
                raise NotImplementedError(
                    "temperature sampling is not ported yet (greedy only)")
            L = len(r.prompt)
            toks = np.tile(np.asarray(r.prompt, np.int64)[None], (B, 1))
            hist = self._run_rows(self.variants[r.fset], toks,
                                  np.full(B, L, np.int64),
                                  np.full(B, r.max_new_tokens, np.int64))
            r.out_tokens = [int(t) for t in hist[:r.max_new_tokens, 0]]
            r.done = True
        return requests

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        m = self.metrics
        totals = self.scheduler.totals()
        hits, misses = totals["hits"], totals["misses"]
        real, padded = totals["real_tokens"], totals["padded_tokens"]
        mb = m.histogram("serve.microbatch.size")
        lat = m.histogram("serve.request.latency_s")
        linear = dispatch.dispatch_counts("linear")
        since = {p: n - self._linear_at_warmup.get(p, 0)
                 for p, n in linear.items()}
        fresh = (None if self._fresh_at_warmup is None
                 else dispatch.fresh_resolutions() - self._fresh_at_warmup)
        serve_s = m.value("serve.serve_time_s")
        generated = int(m.value("serve.tokens_generated"))
        return {
            "mode": self.mode,
            "requests": {"served": int(m.value("serve.requests_served")),
                         "rejected": self.scheduler.rejected},
            "tokens": {"prompt": real, "padded": padded,
                       "generated": generated},
            "padding_waste": padded / (real + padded) if real + padded
            else 0.0,
            "microbatches": {
                "total": mb.count,
                "multi_request": int(m.value("serve.microbatch.multi")),
                "mean_size": mb.mean,
            },
            "bucket_hits": hits, "bucket_misses": misses,
            "plans": {"post_warmup_fresh_resolutions": fresh},
            "linear_dispatch_since_warmup": since,
            "prefill_steps": int(m.value("serve.prefill_steps")),
            "decode_steps": int(m.value("serve.decode_steps")),
            "serve_time_s": serve_s,
            "tokens_per_s": generated / serve_s if serve_s else 0.0,
            "latency_s": {"mean": lat.mean,
                          "max": lat.max if lat.count else 0.0},
            "scheduler": self.scheduler.stats(),
        }
