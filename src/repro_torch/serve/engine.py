"""Serving engine: shape-bucketed continuous batching with plan-warmed
dispatch, slot retire-and-refill, block-paged prefix-KV reuse, chunked
long-prompt prefill and per-request sampling streams — both batching
modes of ``repro.serve.engine``.

The mode follows the family, as in the reference: full-attention dense
decoders serve in ``masked`` mode (below); sliding-window attention
(gemma3's local layers), MoE and the recurrent mixers — xLSTM cells and
Jamba's Mamba mixers, their fp32 state carried per row in the caches
beside any attention layer's KV and updated in place where it is large
(mLSTM's C, Mamba's h) — and the vision-language decoder, served on
its text tokens only (the reference's prefill steps the decode
function, which embeds tokens alone; an image never reaches the
engine), serve in ``equal`` mode, where a
bucket holds requests of one exact length and every row shares a scalar
position — prefill steps the decode function over positions
``0 .. S-1``, decode runs at ``S + t - 1``, filler rows repeat the last real
request (after the real rows, so under MoE they never take a real row's
expert capacity), and refill, the prefix cache and chunked prefill are
off. Equal mode is exact for windowed attention. Under MoE capacity
routing it is not: a decode step routes the B rows' tokens together, and
with the configured ``capacity_factor`` (1.25) a (token, expert) pair
that two rows both pick can drop for the later row, which the same
request served alone keeps. The engine reproduces the reference's
batched behaviour, drops included, and ``stats()["moe"]`` counts the
dropped pairs per microbatch; batched equals unbatched where nothing
drops (``capacity_factor`` with C ≥ B).

Requests are admitted into :class:`~repro_torch.serve.scheduler.
ShapeBucketScheduler` and drained as fixed-shape microbatches (bucket
batch × padded length).  In masked mode a microbatch is right-padded
(different lengths share a bucket); its prefill steps
the decode function over the padded prompt at a shared position, then
decode threads per-row positions and a KV visibility mask through
``forward_decode``.  On top of that, as in the reference:

* **Retire-and-refill.**  A request retires the step it reaches
  ``max_new_tokens`` (tokens read out, latency stamped, its pages
  released) and the next pending request of the same bucket
  (``scheduler.pop_pending``) is prefilled into the freed row.
* **Paged prefix reuse.**  A bucket's prefix point is ``P = pad_len // 2``
  aligned down to the page size; the KV of positions ``0 .. P-1`` is kept
  as ref-counted pages keyed by a digest chain over the prompt
  (:mod:`repro_torch.serve.kv_pages`).  When every real row of a
  microbatch (or a refill) covers its chain, the pages are copied in and
  only the suffix is prefilled.  In-flight rows pin their pages through
  block tables.
* **Chunked prefill.**  A prompt longer than every configured bucket
  rounds up to a multiple of the largest bucket ``C``; leading whole
  chunks covered by every row's cached chain are skipped.
* **Sampling.**  Temperature 0 takes the argmax; temperature > 0 takes
  Gumbel-max under a stream that depends only on (``rng_seed``, the
  request's ``seed``, the token index) — see :func:`sample_tokens`.

Cache layout: row i's KV for position p lives in cache slot p, so a
request's visible keys occupy slots ``0 .. pos`` in the same places
whether it is served in a padded batch or alone.  Prefill writes padding
KV into slots ``L_i .. pad_len-1``; decode overwrites them one slot at a
time and the mask ``slot <= pos_i`` hides the rest.  (The reference
leaves a gap after the padded prompt; placing generated tokens right
after the prompt instead means no reduction ever sees a request's keys at
other offsets than in the unbatched run.)  Pages cover positions
``0 .. P-1``, the same slots in both layouts; a refilled row starts
decoding at ``pos = L``.

Exactness: :meth:`generate_reference` serves each request alone — exact
prompt length, no padding, no other request in the batch — through the
same decode step (per-row positions in masked mode, the scalar position
in equal mode) at the engine's batch width (the idle rows repeat the
request, as the engine's filler rows do).  Every launch then has the
serving shapes, so cuBLAS and PyTorch's reductions pick the same
algorithms, and a row's result does not depend on the other rows; the
ksplit kernel's summation order does not depend on the row count at all.
For the same reason a refill is prefilled at the bucket's batch width in
a scratch cache (every row holding the request; row 0 is copied into the
freed slot), not at batch 1 as in the reference, and a suffix or chunk
prefill is the full prefill's loop started later, over caches holding
the copied pages.  Batched tokens must equal the reference's, for
refilled, page-reused, chunked and sampled requests alike.

There is no ``jit`` to warm: :meth:`warmup` resolves every GEMM plan the
buckets need (and builds the CUDA kernels), and ``stats()`` counts the
*fresh* plan resolutions after warmup, which must stay 0.

Trace events (``repro_torch.obs``, when enabled), as the reference's:
``serve.warmup`` per bucket, ``serve.microbatch`` around each microbatch,
``serve.prefill`` around every prefill (full, page-reused, chunked, and
a refill's), ``serve.decode`` around the decode loop, ``serve.retire``
per retired request and ``serve.refill`` per refilled slot.  Beyond the
reference's: the model's ``model.forward`` per model step, and at each
step that retires a row ``serve.retire_pass`` around the drain
(``serve.drain``), each row's finalize, refills and the decode state
staged anew.  An
admitted request gets a ``req_id`` that its admit, retire, refill and
evict events carry (``serve.microbatch``: ``req_ids``).  Spans are host
time; a microbatch's span ends after its last tokens are read to the
host, so it covers the device work too.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import decode_attention, ops
from repro_torch.models import transformer as T
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.config import DEFAULT_PAD_LENS, ServeConfig
from repro_torch.serve.kv_pages import (BlockTable, PagePool,
                                        PagedPrefixCache, page_digests)
from repro_torch.serve.scheduler import (AdmissionError, BucketKey,
                                         QueueFullError,
                                         ShapeBucketScheduler)
from repro_torch.tune import dispatch

__all__ = ["DEFAULT_PAD_LENS", "Engine", "Request", "ServeConfig",
           "sample_tokens", "stream_seed"]


@dataclasses.dataclass(eq=False)
class Request:
    prompt: np.ndarray            # int [S]
    max_new_tokens: int = 16
    temperature: float = 0.0      # 0 → greedy
    fset: str = "default"         # format-set tag (weight variant)
    seed: int = 0                 # per-request sampling stream
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    bucket: str = ""
    padded_to: int = 0
    cold: bool = False
    latency_s: float = 0.0
    dispatch_paths: tuple = ()
    error: str = ""
    replica: int = -1             # cluster replica (serve.cluster)
    req_id: int = -1              # the engine's admission id (obs events)


@dataclasses.dataclass
class _Row:
    """Host-side state of one microbatch slot under continuous decode."""
    req: Optional[Request]        # None → filler / retired slot
    length: int                   # real prompt length
    emitted: int = 0              # tokens sampled so far (incl. prefill's)
    join: int = 0                 # step index of its first decode token
    first_tok: Optional[int] = None   # refill: token sampled at prefill
    active: bool = False
    cold: bool = False
    table: Optional[BlockTable] = None    # pages pinned by this row


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(rng_seed: int, seed: int, n: int) -> int:
    """Generator seed of token ``n`` of a request: a fixed mix of the
    engine seed, the request seed and the token index, nothing else."""
    h = _splitmix64(int(rng_seed) & _MASK64)
    h = _splitmix64(h ^ (int(seed) & _MASK64))
    return _splitmix64(h ^ (int(n) & _MASK64)) >> 1


def sample_tokens(logits: torch.Tensor, temps: np.ndarray,
                  seeds: np.ndarray, n: np.ndarray, draw: np.ndarray,
                  rng_seed: int) -> torch.Tensor:
    """One step's tokens.  ``logits`` [B, V]; ``temps``, ``seeds``, ``n``
    (index of the token within its request, 0 = the prefill's) and
    ``draw`` (rows that may sample: filler and retired rows draw nothing)
    are host arrays [B].

    Temperature 0 → argmax.  Temperature > 0 → Gumbel-max over the fp32
    logits with the reference's clip constants, the uniforms drawn by a
    ``torch.Generator`` on the logits' device seeded with
    :func:`stream_seed`, so a request's tokens do not depend on its row,
    its batch or whether it was refilled.  (Philox on the card, mt19937
    on the CPU: the two devices draw different streams.)"""
    logits = logits.float()
    out = torch.argmax(logits, dim=-1)
    for i in np.flatnonzero(draw & (temps > 0)):
        g = torch.Generator(device=logits.device)
        g.manual_seed(stream_seed(rng_seed, seeds[i], n[i]))
        u = torch.rand(logits.shape[-1], generator=g, device=logits.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-20, 1.0 - 1e-12)))
        out[i] = torch.argmax(logits[i] / float(temps[i]) + gumbel)
    return out


class Engine:
    def __init__(self, cfg: ArchConfig, params,
                 config: Optional[ServeConfig] = None, *,
                 variants: Optional[dict] = None):
        config = config or ServeConfig()
        T.check_family(cfg)
        self.config = config
        self.cfg, self.params = cfg, params
        self.device = params["embed"].device
        self.max_batch, self.max_seq = config.max_batch, config.max_seq
        #: weights per format-set tag (a request's ``fset`` picks one)
        self.variants = {"default": params, **(variants or {})}
        # the reference's rule: only full attention without experts,
        # frontend or encoder-only layout can mask per-row progress
        self.mode = ("masked" if (cfg.block_type == "attn"
                                  and cfg.attn_pattern == "full"
                                  and not cfg.encoder_only
                                  and cfg.n_experts == 0
                                  and cfg.frontend == "none")
                     else "equal")
        # tune-once at setup: a plan for every mixed-precision layer of
        # every variant at the decode batch size
        dispatch.warm_registry()
        self.gemm_plans = {}
        for tree in self.variants.values():
            self.gemm_plans.update(dispatch.tune_linear_params(
                tree, m_hint=self.max_batch))
        # the distributed SUMMA path (from ArchConfig or ServeConfig):
        # checked against the single-device reference at this config's
        # tile/policy/format set, on ranks of the engine's device type
        self.summa_report = None
        grid = config.summa_grid or cfg.summa_grid
        if grid:
            from repro_torch.core.summa import config_selfcheck
            self.summa_report = config_selfcheck(
                cfg, grid, device=self.device.type)
        # refill, paged prefix reuse and chunked prefill need per-row
        # cache progress: masked mode only
        self.refill_enabled = config.refill and self.mode == "masked"
        if config.prefix_cache and self.mode == "masked":
            self.pool = PagePool(config.page_tokens, config.prefix_pages)
            self.prefix = PagedPrefixCache(self.pool)
        else:
            self.pool = None
            self.prefix = None
        sched_cfg = config.scheduler_config(cfg.serve_buckets)
        fitting = tuple(p for p in sched_cfg.pad_lens
                        if p + 1 <= self.max_seq)
        if not fitting:
            raise ValueError(
                f"no serve bucket fits max_seq={self.max_seq} "
                f"(pad_lens={sched_cfg.pad_lens})")
        if fitting != sched_cfg.pad_lens:
            sched_cfg = dataclasses.replace(sched_cfg, pad_lens=fitting)
        # prompts longer than every configured bucket round up to a
        # multiple of the largest bucket width and prefill chunk by chunk
        self._max_cfg_pad = max(fitting)
        self._chunk = (self._max_cfg_pad
                       if config.chunked_prefill and self.mode == "masked"
                       else 0)
        self._chunk_warmed = False
        self.metrics = MetricsRegistry()
        self.scheduler = ShapeBucketScheduler(
            sched_cfg, fsets=tuple(self.variants), mode=self.mode,
            max_prompt=self.max_seq - 1, metrics=self.metrics)
        # global counters at the end of warmup (None before warmup)
        self._fresh_at_warmup: Optional[int] = None
        self._linear_at_warmup: dict[str, int] = {}
        #: refill prefill caches, one per batch width, zeroed per refill
        self._scratch: dict[int, list] = {}
        self._kv_pos = torch.arange(self.max_seq, device=self.device)
        #: MoE (token, expert) pairs dropped, per equal-mode microbatch
        self.moe_dropped: list[int] = []
        #: ``Request.req_id`` of the next admission
        self._req_ids = itertools.count()

    def _prefix_len(self, pad_len: int) -> int:
        """Reusable-prefix point of a bucket: ``pad_len // 2`` aligned
        down to whole KV pages (0 → prefix reuse off for this bucket)."""
        if self.prefix is None:
            return 0
        pt = self.pool.page_tokens
        return (pad_len // 2) // pt * pt

    def _is_chunked(self, pad_len: int) -> bool:
        """Buckets wider than every configured pad serve through chunked
        prefill when their width is a whole number of chunks."""
        return bool(self._chunk) and pad_len > self._max_cfg_pad \
            and pad_len % self._chunk == 0

    # ------------------------------------------------------------------
    # warmup: resolve every plan the buckets need, build the kernels
    # ------------------------------------------------------------------

    def warmup(self, keys=None) -> dict:
        """Resolve the GEMM plans of every configured bucket (or the
        given keys) at the decode batch and at m = 1, and build the CUDA
        kernels, so serving does no fresh work.  Chunked buckets use the
        same plans, so they count as warm from here on.  Returns a
        report."""
        keys = list(keys) if keys is not None else [
            k for k, b in self.scheduler.buckets.items() if b.configured]
        fresh0 = dispatch.fresh_resolutions()
        if self.device.type == "cuda":
            ops.ensure_built()
        report = {}
        for key in keys:
            bucket = self.scheduler.buckets[key]
            if key.pad_len + 1 > self.max_seq:
                raise AdmissionError(
                    f"bucket {key} does not fit max_seq {self.max_seq}")
            with obs.span("serve.warmup", "serve", bucket=str(key),
                          batch=bucket.batch):
                plan_table = dispatch.resolve_plans_for_buckets(
                    self.variants,
                    [(key.fset, self.scheduler.cfg.max_batch, key.pad_len)])
            plans = {**plan_table.get((key.fset, 1), {}),
                     **plan_table.get((key.fset, bucket.batch), {})}
            bucket.paths = tuple(sorted({p.path for p in plans.values()}))
            bucket.warmed = True
            report[str(key)] = {"paths": list(bucket.paths)}
        if self._chunk and keys:
            self._chunk_warmed = True
        self._fresh_at_warmup = dispatch.fresh_resolutions()
        self._linear_at_warmup = dispatch.dispatch_counts("linear")
        report["fresh_resolutions"] = self._fresh_at_warmup - fresh0
        return report

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> BucketKey:
        """Admit one request (raises AdmissionError / QueueFullError).

        KV head-room: a row writes slots up to ``L + max_new - 2`` and
        its padded prefill up to ``pad_len - 1``, so ``pad_len + max_new
        - 1 <= max_seq`` bounds both.  Prompts longer than every
        configured bucket round up to a chunk multiple (chunked prefill);
        a request whose padded or chunked length breaks the bound but
        whose exact length fits gets an exact-length bucket.  Every check
        runs on a prospective bucket key, so a rejected request never
        creates or evicts a bucket."""
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
        use_exact = use_chunk = False
        if self._chunk and L > self._max_cfg_pad:
            chunk_pad = -(-L // self._chunk) * self._chunk
            use_chunk = chunk_pad + req.max_new_tokens - 1 <= self.max_seq
        if not use_chunk \
                and key.pad_len + req.max_new_tokens - 1 > self.max_seq:
            if L + req.max_new_tokens - 1 <= self.max_seq:
                use_exact = True
            else:
                self.scheduler.reject()
                raise AdmissionError(
                    f"prompt {L} (padded {key.pad_len}) + "
                    f"{req.max_new_tokens} new tokens exceeds max_seq "
                    f"{self.max_seq}")
        req.req_id = rid = next(self._req_ids)
        if use_chunk:
            key = self.scheduler.exact_bucket(chunk_pad, req.fset,
                                              req_id=rid)
            bucket = self.scheduler.buckets[key]
            if self._chunk_warmed and not bucket.warmed:
                bucket.warmed = True      # same plans as every bucket
        elif use_exact:
            key = self.scheduler.exact_bucket(L, req.fset, req_id=rid)
        else:
            key = self.scheduler.bucket_for(L, req.fset, req_id=rid)
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
        """Drain the admission queue, one microbatch at a time (each
        microbatch keeps refilling from its bucket's queue until that
        bucket's stream drains)."""
        while True:
            mb = self.scheduler.next_microbatch()
            if mb is None:
                return
            bucket, reqs = mb
            if not reqs:
                continue
            serve = (self._serve_microbatch if self.mode == "masked"
                     else self._serve_microbatch_equal)
            ids = [r.req_id for r in reqs] if obs.is_enabled() else None
            with obs.span("serve.microbatch", "serve",
                          bucket=str(bucket.key), n_real=len(reqs),
                          batch=bucket.batch, pad_len=bucket.key.pad_len,
                          warm=bucket.warmed, req_ids=ids):
                serve(bucket, reqs)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Snapshot a host staging buffer onto the device.  The numpy copy
        comes first: ``torch.from_numpy`` aliases the buffer, and a copy
        that is still in flight must never see a later host write."""
        return torch.from_numpy(np.array(a)).to(self.device)

    # -- model steps ------------------------------------------------------

    def _prefill(self, params, caches, toks: np.ndarray,
                 lengths: np.ndarray, start: int, stop: int,
                 moe_drops: list | None = None) -> torch.Tensor:
        """Step the decode function over positions ``start .. stop-1`` of
        ``toks`` [B, S] (caches already hold positions ``< start``: copied
        pages or skipped chunks).  Returns the logits [B, V] at each row's
        last real position, which must lie in the span."""
        if not np.all((lengths > start) & (lengths <= stop)):
            raise ValueError(f"a row's last token is outside the prefill "
                             f"span [{start}, {stop})")
        toks_d = self._dev(toks[:, start:stop])
        steps = self.metrics.counter("serve.prefill_steps")
        last = None
        for s in range(start, stop):
            logits, _ = T.forward_decode(params, self.cfg,
                                         toks_d[:, s - start:s - start + 1],
                                         caches, s, moe_drops=moe_drops)
            if last is None:
                last = torch.empty_like(logits[:, 0])
            for i in np.flatnonzero(lengths == s + 1):
                last[i].copy_(logits[i, 0])
            # per position: a cluster's heartbeat reads it mid-prefill
            steps.inc()
        return last

    def _decode(self, params, caches, cur: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
        """One decode step at per-row positions ``pos`` [B] (also the
        cache slots); returns logits [B, V]."""
        kv_valid = self._kv_pos[None, :] <= pos[:, None]
        logits, _ = T.forward_decode(params, self.cfg, cur[:, None], caches,
                                     pos, slot=pos, kv_valid=kv_valid)
        return logits[:, 0]

    def _sample(self, logits, temps, seeds, n, draw) -> torch.Tensor:
        return sample_tokens(logits, temps, seeds, n, draw,
                             self.config.rng_seed)

    # -- retirement bookkeeping ------------------------------------------

    def _finalize(self, row: _Row, i: int, bucket, hist, S: int,
                  t0: float) -> None:
        """Retire the request in slot ``i``: collect its tokens from the
        materialized step history, stamp latency now (the step at which
        it finished), release the pages the row pinned, and count."""
        r = row.req
        m = self.metrics
        n_new = r.max_new_tokens
        toks_out = [] if row.first_tok is None else [row.first_tok]
        need = n_new - len(toks_out)
        toks_out += [int(hist[j][i]) for j in range(row.join,
                                                    row.join + need)]
        r.out_tokens = toks_out
        r.done = True
        r.bucket = str(bucket.key)
        r.padded_to = S
        r.cold = row.cold
        r.dispatch_paths = bucket.paths
        r.latency_s = time.perf_counter() - getattr(r, "_t_admit", t0)
        if row.table is not None:
            row.table.release()
            row.table = None
        row.req, row.active = None, False
        bucket.served += 1
        bucket.real_tokens += row.length
        m.counter("serve.requests_served").inc()
        m.counter("serve.tokens_generated").inc(n_new)
        m.histogram("serve.request.latency_s").observe(r.latency_s)
        if obs.is_enabled():
            obs.event("serve.retire", "serve", bucket=str(bucket.key),
                      req_id=r.req_id, slot=i, new_tokens=n_new,
                      cold=r.cold,
                      latency_s=round(r.latency_s, 6))

    @staticmethod
    def _drain(devbuf: list, hist: list) -> None:
        """Materialize pending device token vectors into the host history
        (the engine's device→host sync, paid at retirement)."""
        if devbuf:
            with obs.span("serve.drain", "serve", steps=len(devbuf)):
                hist.extend(torch.stack(devbuf).cpu().numpy())
            devbuf.clear()

    # -- continuous decode with retire-and-refill -------------------------

    def _serve_microbatch(self, bucket, reqs: list[Request]) -> None:
        key = bucket.key
        params = self.variants[key.fset]
        S, B, n_real = key.pad_len, bucket.batch, len(reqs)
        P = self._prefix_len(S)
        was_warm = bucket.warmed
        if was_warm:
            bucket.hits += 1
        else:
            bucket.misses += 1
        m = self.metrics
        t0 = time.perf_counter()
        # right-pad prompts to the bucket length; unused slots repeat the
        # last request as greedy fillers whose tokens are discarded
        toks = np.zeros((B, S), np.int64)
        lengths = np.zeros(B, np.int64)
        temps = np.zeros(B, np.float32)
        seeds = np.zeros(B, np.int64)
        rows: list[_Row] = []
        for i in range(B):
            r = reqs[min(i, n_real - 1)]
            toks[i, :len(r.prompt)] = r.prompt
            lengths[i] = len(r.prompt)
            if i < n_real:
                temps[i], seeds[i] = r.temperature, r.seed
                rows.append(_Row(req=r, length=int(lengths[i]), emitted=1,
                                 active=True, cold=not was_warm))
            else:
                rows.append(_Row(req=None, length=int(lengths[i])))
        pos = lengths.copy()              # next slot (= position) per row
        hist: list[np.ndarray] = []       # materialized [B] token steps
        devbuf: list = []                 # device [B] steps not yet pulled
        caches = T.init_cache(self.cfg, B, self.max_seq, self.device)
        cur = self._prefill_rows(bucket, params, caches, toks, lengths,
                                 temps, seeds, n_real, P, rows)
        devbuf.append(cur)

        def finished() -> list:
            return [i for i in range(B)
                    if rows[i].active and rows[i].req is not None
                    and rows[i].emitted >= rows[i].req.max_new_tokens]

        def decode_state():
            # host staging buffers to the device: at microbatch start and
            # after a retire/refill event only
            active = np.array([r.active for r in rows], np.int64)
            return self._dev(pos), self._dev(active)

        def retire_pass() -> bool:
            """Retire (and refill) every finished row, then stage the
            decode state anew; False, doing nothing, if none finished."""
            nonlocal cur, pos_d, active_d
            ret = finished()
            if not ret:
                return False
            with obs.span("serve.retire_pass", "serve", rows=len(ret)):
                while ret:
                    self._drain(devbuf, hist)
                    new_cur = None
                    for i in ret:
                        self._finalize(rows[i], i, bucket, hist, S, t0)
                        if not self.refill_enabled:
                            continue
                        nxt = self.scheduler.pop_pending(key)
                        if nxt is None:
                            continue
                        first = self._refill_slot(
                            bucket, params, caches, i, nxt, toks, lengths,
                            temps, seeds, pos, rows, hist, P)
                        if new_cur is None:
                            # from the LIVE decode input: a refill made by
                            # an earlier iteration of this pass (one that
                            # itself retired at max_new_tokens == 1)
                            # exists only there
                            new_cur = cur.clone()
                        new_cur[i] = first
                    if new_cur is not None:
                        cur = new_cur
                    ret = finished()
                pos_d, active_d = decode_state()
            return True

        with obs.span("serve.decode", "serve", bucket=str(key)):
            pos_d = active_d = None
            if not retire_pass():
                pos_d, active_d = decode_state()
            while any(r.active for r in rows):
                logits = self._decode(params, caches, cur, pos_d)
                live = np.array([r.active for r in rows])
                n = np.array([r.emitted for r in rows], np.int64)
                cur = self._sample(logits, temps, seeds, n, live)
                devbuf.append(cur)
                pos_d = pos_d + active_d
                # counted per step: the cluster's heartbeat reads it
                m.counter("serve.decode_steps").inc()
                for i, r in enumerate(rows):
                    if r.active:
                        r.emitted += 1
                        pos[i] += 1
                retire_pass()
        bucket.warmed = True
        m.counter("serve.serve_time_s").inc(time.perf_counter() - t0)
        m.histogram("serve.microbatch.size").observe(n_real)
        if n_real > 1:
            m.counter("serve.microbatch.multi").inc()

    # -- equal mode: shared-position decode --------------------------------

    def _decode_equal(self, params, caches, cur: torch.Tensor,
                      position: int, moe_drops: list | None = None
                      ) -> torch.Tensor:
        """One decode step at the shared scalar ``position``; logits
        [B, V]."""
        logits, _ = T.forward_decode(params, self.cfg, cur[:, None], caches,
                                     position, moe_drops=moe_drops)
        return logits[:, 0]

    def _serve_microbatch_equal(self, bucket, reqs: list[Request]) -> None:
        """Equal-length batching: every row has length ``S`` and shares
        the scalar position; requests retire (latency stamped, tokens
        read out) the step they finish, and the loop ends with the last
        real row.  Real rows keep sampling after they retire (the
        reference's loop does), so a retired row routes its MoE tokens as
        it would there."""
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
        toks = np.zeros((B, S), np.int64)
        temps = np.zeros(B, np.float32)
        seeds = np.zeros(B, np.int64)
        rows: list[_Row] = []
        for i in range(B):
            r = reqs[min(i, n_real - 1)]      # fillers repeat the last
            toks[i, :len(r.prompt)] = r.prompt
            if i < n_real:
                temps[i], seeds[i] = r.temperature, r.seed
                rows.append(_Row(req=r, length=len(r.prompt), emitted=1,
                                 active=True, cold=not was_warm))
            else:
                rows.append(_Row(req=None, length=len(r.prompt)))
        draw = np.arange(B) < n_real
        hist: list[np.ndarray] = []
        devbuf: list = []
        drops: list = []
        caches = T.init_cache(self.cfg, B, self.max_seq, self.device)
        with obs.span("serve.prefill", "serve", bucket=str(key), batch=B,
                      pad_len=S, prefix_reuse=False):
            last = self._prefill(params, caches, toks, np.full(B, S), 0, S,
                                 drops)
        cur = self._sample(last, temps, seeds, np.zeros(B, np.int64), draw)
        devbuf.append(cur)
        bucket.padded_tokens += int((B - n_real) * S)

        def process_retirements() -> None:
            ret = [i for i in range(B)
                   if rows[i].active and rows[i].req is not None
                   and rows[i].emitted >= rows[i].req.max_new_tokens]
            if ret:
                with obs.span("serve.retire_pass", "serve", rows=len(ret)):
                    self._drain(devbuf, hist)
                    for i in ret:
                        self._finalize(rows[i], i, bucket, hist, S, t0)

        with obs.span("serve.decode", "serve", bucket=str(key)):
            process_retirements()
            t = 1
            while any(r.active for r in rows):
                logits = self._decode_equal(params, caches, cur, S + t - 1,
                                            drops)
                cur = self._sample(logits, temps, seeds,
                                   np.full(B, t, np.int64), draw)
                devbuf.append(cur)
                m.counter("serve.decode_steps").inc()
                for r in rows:
                    if r.active:
                        r.emitted += 1
                t += 1
                process_retirements()
        if self.cfg.n_experts:
            self.moe_dropped.append(int(torch.stack(drops).sum()))
        bucket.warmed = True
        m.counter("serve.serve_time_s").inc(time.perf_counter() - t0)
        m.histogram("serve.microbatch.size").observe(n_real)
        if n_real > 1:
            m.counter("serve.microbatch.multi").inc()

    # -- KV pages ----------------------------------------------------------

    def _row_digests(self, fset: str, toks, lengths, i: int, P: int):
        """Page-digest chain for row ``i``'s prefix span (None → row has
        no reusable prefix: too short or paging disabled)."""
        if not P or lengths[i] <= P:
            return None
        return page_digests(fset, toks[i, :P], self.pool.page_tokens)

    def write_pages(self, caches, row: int, pages: list) -> None:
        """Copy page payloads ([layers, 2, page_tokens, n_kv, dh] each,
        positions from 0 on) into cache row ``row``: one concatenation and
        one copy per layer for K and V, whatever the chain's length."""
        kv = torch.cat(pages, dim=2)
        n = kv.shape[2]
        for layer, c in enumerate(caches):
            c["k"][row, :n] = kv[layer, 0]
            c["v"][row, :n] = kv[layer, 1]

    def _scatter_chain(self, caches, digests, row: int) -> BlockTable:
        """Commit a cached chain into ``row``: LRU-refresh, copy the pages
        in, and pin them all in a fresh block table."""
        pids = self.prefix.lookup(digests)
        self.prefix.hits += 1
        table = BlockTable(self.pool)
        for pid in pids:
            table.append_page(pid)
        self.write_pages(caches, row, [self.pool.payload(p) for p in pids])
        return table

    def _insert_chain_from_row(self, caches, digests, row: int) -> None:
        """Feed the cache from ``row``'s freshly computed prefix span; the
        span is read once, on the first page the cache does not hold."""
        pt = self.pool.page_tokens
        span = []

        def page(j: int) -> torch.Tensor:
            if not span:
                n = len(digests) * pt
                span.append(torch.stack([torch.stack((c["k"][row, :n],
                                                      c["v"][row, :n]))
                                         for c in caches]))
            return span[0][:, :, j * pt:(j + 1) * pt].clone()

        self.prefix.insert_chain(digests, page)

    # -- prefill paths (full / page-reused suffix / chunked / refill) -----

    def _prefill_rows(self, bucket, params, caches, toks, lengths, temps,
                      seeds, n_real: int, P: int, rows: list):
        """Microbatch prefill: chunked for long buckets; otherwise
        suffix-only when every real row covers its page chain, else full
        (which then feeds the page cache).  Returns the first tokens."""
        key = bucket.key
        B, S = toks.shape
        if self._is_chunked(S):
            last = self._prefill_chunked(bucket, params, caches, toks,
                                         lengths, n_real, rows)
        else:
            digs = [self._row_digests(key.fset, toks, lengths, i, P)
                    for i in range(n_real)]
            use_sfx = bool(digs) and all(
                d is not None and self.prefix.covers(d) for d in digs)
            with obs.span("serve.prefill", "serve", bucket=str(key),
                          batch=B, pad_len=S, prefix_reuse=use_sfx):
                if use_sfx:
                    for i in range(n_real):
                        rows[i].table = self._scatter_chain(caches, digs[i],
                                                            i)
                    last = self._prefill(params, caches, toks, lengths, P, S)
                    self.metrics.counter(
                        "serve.prefix.reused_prefills").inc()
                    bucket.padded_tokens += int(
                        B * (S - P)
                        - np.maximum(lengths[:n_real] - P, 0).sum())
                else:
                    missed = self._count_wave(digs)
                    last = self._prefill(params, caches, toks, lengths, 0, S)
                    bucket.padded_tokens += int(
                        B * S - lengths[:n_real].sum())
                    for i in missed.values():
                        self._insert_chain_from_row(caches, digs[i], i)
        return self._sample(last, temps, seeds, np.zeros(B, np.int64),
                            np.arange(B) < n_real)

    def _count_wave(self, digs: list) -> dict:
        """Hit/miss accounting of a wave that prefills in full: rows whose
        chain is cached count a hit each; each distinct uncovered chain
        counts one miss, matching its one insert.  Returns ``{chain: row}``
        of the chains to insert.  Rows without a chain (None or empty: too
        short, or no prefix cache) count nothing — the reference adds to
        a None cache here (``repro/serve/engine.py:845``)."""
        missed: dict[tuple, int] = {}
        for i, d in enumerate(digs):
            if not d:
                continue
            if self.prefix.covers(d):
                self.prefix.hits += 1
            else:
                missed.setdefault(tuple(d), i)
        if missed:
            self.prefix.misses += len(missed)
        return missed

    def _chunk_skip(self, fset: str, toks, lengths, rows_idx, S: int):
        """Chunked-prefill page plan: ``(digests per row, whole chunks
        every row's cached chain covers)``.  The chains cover each prompt
        minus its last token (the first sampled token comes from a fresh
        computation); at least the last chunk always runs."""
        pt = self.pool.page_tokens if self.prefix is not None else 0
        if not pt or self._chunk % pt:
            return [], 0
        digs = [page_digests(fset, toks[i], pt, limit=int(lengths[i]) - 1)
                for i in rows_idx]
        n_skip = min(min(len(self.prefix.chain(d)) * pt // self._chunk,
                         S // self._chunk - 1) for d in digs)
        return digs, n_skip

    def _count_chunks(self, S: int, n_skip: int) -> None:
        m = self.metrics
        m.counter("serve.chunked_prefills").inc()
        m.counter("serve.chunks_run").inc(S // self._chunk - n_skip)
        m.counter("serve.chunks_skipped").inc(n_skip)

    def _prefill_chunked(self, bucket, params, caches, toks, lengths,
                         n_real: int, rows: list):
        """Long-prompt prefill from the first chunk not covered by every
        row's cached chain; an uncovered wave feeds its chains back to
        the cache.  Every row's last real token lies in the last chunk."""
        key = bucket.key
        B, S = toks.shape
        C = self._chunk
        digs, n_skip = self._chunk_skip(key.fset, toks, lengths,
                                        range(n_real), S)
        with obs.span("serve.prefill", "serve", bucket=str(key), batch=B,
                      pad_len=S, prefix_reuse=n_skip > 0,
                      chunks=S // C, chunks_skipped=n_skip):
            missed: dict[tuple, int] = {}
            if n_skip:
                npages = n_skip * C // self.pool.page_tokens
                for i in range(n_real):
                    rows[i].table = self._scatter_chain(caches,
                                                        digs[i][:npages], i)
                self.metrics.counter("serve.prefix.reused_prefills").inc()
            else:
                missed = self._count_wave(digs)
            last = self._prefill(params, caches, toks, lengths, n_skip * C, S)
            self._count_chunks(S, n_skip)
            bucket.padded_tokens += int(
                B * (S - n_skip * C)
                - np.maximum(lengths[:n_real] - n_skip * C, 0).sum())
            for i in missed.values():
                self._insert_chain_from_row(caches, digs[i], i)
            return last

    def _scratch_cache(self, B: int) -> list:
        """The refill prefill's cache at batch width ``B``, zeroed."""
        caches = self._scratch.get(B)
        if caches is None:
            caches = self._scratch[B] = T.init_cache(
                self.cfg, B, self.max_seq, self.device)
        else:
            for c in caches:
                c["k"].zero_()
                c["v"].zero_()
        return caches

    def _refill_slot(self, bucket, params, caches, i: int, nxt: Request,
                     toks, lengths, temps, seeds, pos, rows, hist,
                     P: int) -> int:
        """Pull ``nxt`` into freed slot ``i`` mid-decode: prefill it
        (page-reused or chunked as its bucket allows) at the bucket's
        batch width in the scratch cache, every row holding the request,
        then copy row 0 into slot ``i``.  Returns its first token."""
        key = bucket.key
        B, S = toks.shape
        L2 = len(nxt.prompt)
        toks[i, :] = 0
        toks[i, :L2] = nxt.prompt
        lengths[i] = L2
        temps[i], seeds[i] = nxt.temperature, nxt.seed
        scratch = self._scratch_cache(B)
        table = None
        insert = None
        if self._is_chunked(S):
            C = self._chunk
            digs, n_skip = self._chunk_skip(key.fset, toks, lengths, [i], S)
            start = n_skip * C
            if n_skip:
                table = self._scatter_chain(
                    scratch, digs[0][:start // self.pool.page_tokens], 0)
            elif digs and digs[0]:
                self.prefix.misses += 1
                insert = digs[0]
            self._count_chunks(S, n_skip)
            bucket.padded_tokens += int((S - start) - max(L2 - start, 0))
        else:
            dig = self._row_digests(key.fset, toks, lengths, i, P)
            if dig is not None and self.prefix.covers(dig):
                table = self._scatter_chain(scratch, dig, 0)
                start = P
                bucket.padded_tokens += int((S - P) - max(L2 - P, 0))
            else:
                if dig is not None:
                    self.prefix.misses += 1
                    insert = dig
                start = 0
                bucket.padded_tokens += int(S - L2)
        chunks = (dict(chunks=S // self._chunk,
                       chunks_skipped=start // self._chunk)
                  if self._is_chunked(S) else {})
        with obs.span("serve.prefill", "serve", bucket=str(key), batch=B,
                      pad_len=S, prefix_reuse=table is not None,
                      refill_slot=i, **chunks):
            last = self._prefill(params, scratch,
                                 np.tile(toks[i, :L2], (B, 1)),
                                 np.full(B, L2, np.int64), start, L2)
        draw = np.arange(B) == 0
        first = int(self._sample(last, np.where(draw, temps[i], 0.0),
                                 np.full(B, seeds[i]), np.zeros(B, np.int64),
                                 draw)[0])
        if insert is not None:
            self._insert_chain_from_row(scratch, insert, 0)
        for c, s in zip(caches, scratch):
            c["k"][i] = s["k"][0]
            c["v"][i] = s["v"][0]
        pos[i] = L2
        rows[i] = _Row(req=nxt, length=L2, emitted=1, join=len(hist),
                       first_tok=first, active=True, cold=False, table=table)
        self.metrics.counter("serve.refills").inc()
        if table is not None:
            self.metrics.counter("serve.prefix.reused_refills").inc()
        if obs.is_enabled():
            obs.event("serve.refill", "serve", bucket=str(key),
                      req_id=nxt.req_id, slot=i, length=L2,
                      prefix_reuse=table is not None)
        return first

    # ------------------------------------------------------------------
    # unbatched reference
    # ------------------------------------------------------------------

    def generate_reference(self, requests: list[Request]) -> list[Request]:
        """Serve each request alone — exact prompt length, no padding, no
        co-batched request — at the engine's batch width (every row holds
        the request; row 0's tokens are kept, and only row 0 samples).
        The baseline the batched path must match token for token, greedy
        and sampled alike (under MoE, where no token drops).  In equal
        mode it decodes at the shared scalar position, as the reference's
        unbatched path does."""
        B = self.max_batch
        zeros = np.zeros(B, np.int64)
        draw = np.arange(B) == 0
        for r in requests:
            params = self.variants[r.fset]
            L = len(r.prompt)
            caches = T.init_cache(self.cfg, B, self.max_seq, self.device)
            toks = np.tile(np.asarray(r.prompt, np.int64)[None], (B, 1))
            temps = np.where(draw, r.temperature, 0.0).astype(np.float32)
            seeds = np.full(B, r.seed, np.int64)
            last = self._prefill(params, caches, toks, np.full(B, L), 0, L)
            cur = self._sample(last, temps, seeds, zeros, draw)
            out = [cur]
            pos = torch.full((B,), L, dtype=torch.int64, device=self.device)
            for step in range(1, r.max_new_tokens):
                if self.mode == "equal":
                    logits = self._decode_equal(params, caches, cur,
                                                L + step - 1)
                else:
                    logits = self._decode(params, caches, cur, pos)
                cur = self._sample(logits, temps, seeds, zeros + step, draw)
                out.append(cur)
                pos = pos + 1
            r.out_tokens = [int(t) for t in torch.stack(out)[:, 0].cpu()]
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
                "max_size": int(mb.max) if mb.count else 0,
                "refills": int(m.value("serve.refills")),
                "reused_refills": int(
                    m.value("serve.prefix.reused_refills")),
            },
            "bucket_hits": hits, "bucket_misses": misses,
            "bucket_hit_rate": hits / (hits + misses) if hits + misses
            else 0.0,
            "plans": {"post_warmup_fresh_resolutions": fresh},
            "linear_dispatch_since_warmup": since,
            "prefill_steps": int(m.value("serve.prefill_steps")),
            "decode_steps": int(m.value("serve.decode_steps")),
            "serve_time_s": serve_s,
            "tokens_per_s": generated / serve_s if serve_s else 0.0,
            "chunked_prefills": int(m.value("serve.chunked_prefills")),
            "chunks": {"run": int(m.value("serve.chunks_run")),
                       "skipped": int(m.value("serve.chunks_skipped"))},
            "latency_s": {"mean": lat.mean,
                          "max": lat.max if lat.count else 0.0},
            "prefix_cache": (self.prefix.stats() if self.prefix is not None
                             else None),
            "kv_pages": (self.pool.stats() if self.pool is not None
                         else None),
            "scheduler": self.scheduler.stats(),
            "moe": ({"dropped_per_microbatch": list(self.moe_dropped)}
                    if self.cfg.n_experts else None),
            # the decode-attention kernel's launches and 64-key tiles
            # (read / covered) in this process since the last reset
            "attention": decode_attention.stats(),
        }
