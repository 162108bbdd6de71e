"""Shape-bucketed continuous-batching scheduler for the serve engine
(host-side control plane, ported from ``repro.serve.scheduler``).

The paper delegates heterogeneous work placement to PaRSEC's runtime; the
serving analogue is this module: requests of arbitrary prompt length and
format-set tag are admitted into a bounded FIFO queue, grouped into
*shape buckets* — (padded length, format-set tag) pairs — and drained as
fixed-shape microbatches so every dispatch hits a pre-resolved GEMM plan
(``tune.resolve_plans_for_buckets``).

Bucketing policy (``SchedulerConfig``):

* **best-fit padding** — a request of prompt length L lands in the smallest
  configured bucket with ``pad_len >= L``;
* **waste cap** — if padding waste ``(pad_len - L) / pad_len`` exceeds
  ``waste_cap``, the warm bucket is *rejected* for this request and it is
  redirected to a dynamically-created cold bucket at its exact length
  (served correctly, recorded as a bucket miss — never a crash);
* **cold-bucket LRU eviction** — at most ``max_dynamic`` dynamic buckets
  are tracked; the least-recently-used one is evicted when the cap is hit
  (its next use is a fresh miss again);
* **bounded admission** — ``max_queue`` pending requests; beyond that
  ``admit`` raises :class:`QueueFullError` (backpressure, not OOM).

Two batching modes, chosen by the engine per model family:

* ``masked`` (full attention, no MoE): requests of *different* lengths
  share a bucket; right-padding plus per-request positions and a KV
  visibility mask keep results bit-exact with unbatched decoding.
* ``equal`` (state-carrying mixers — Mamba/xLSTM — sliding-window
  attention, and MoE): padding cannot be masked out of the recurrent
  state / capacity routing, so a bucket only ever holds requests of one
  exact length (pad_len == L; configured lengths can still be pre-warmed).
  Exact for windowed attention; under MoE capacity routing a decode
  step routes every row's token together, so batched differs from
  unbatched whenever a (token, expert) pair drops past its expert's
  capacity.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional

from repro_torch import obs
from repro_torch.obs.metrics import MetricsRegistry

__all__ = [
    "AdmissionError", "QueueFullError", "Bucket", "BucketKey",
    "SchedulerConfig", "ShapeBucketScheduler",
]


class AdmissionError(ValueError):
    """Request can never be served by this engine (too long for any
    bucket / would overflow the KV cache)."""


class QueueFullError(RuntimeError):
    """Admission queue is at capacity — retry after draining."""


@dataclasses.dataclass(frozen=True)
class BucketKey:
    pad_len: int          # right-padded prompt length of the microbatch
    fset: str             # format-set tag (which weight variant serves it)

    def __str__(self) -> str:
        return f"S{self.pad_len}/{self.fset}"


@dataclasses.dataclass
class Bucket:
    key: BucketKey
    batch: int                    # microbatch slot count
    configured: bool              # from SchedulerConfig (warmup target)
    warmed: bool = False          # dispatch plans pre-resolved
    # --- accounting -----------------------------------------------------
    hits: int = 0                 # microbatches served warm
    misses: int = 0               # microbatches served unwarmed
    served: int = 0               # requests retired through this bucket
    real_tokens: int = 0          # prompt tokens (pre-padding)
    padded_tokens: int = 0        # pad slots prefilling garbage
    paths: tuple = ()             # resolved GEMM dispatch paths (warmup)

    def stats(self) -> dict:
        denom = self.hits + self.misses
        return {
            "pad_len": self.key.pad_len, "fset": self.key.fset,
            "configured": self.configured, "warmed": self.warmed,
            "hits": self.hits, "misses": self.misses, "served": self.served,
            "real_tokens": self.real_tokens,
            "padded_tokens": self.padded_tokens,
            "hit_rate": self.hits / denom if denom else 0.0,
            "paths": sorted(self.paths),
        }


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Knobs of the shape-bucketed scheduler (``ArchConfig.serve_buckets``
    seeds ``pad_lens``)."""
    pad_lens: tuple = (16, 32, 64, 128)
    waste_cap: float = 0.75       # max (pad - L) / pad before redirect
    max_batch: int = 4            # microbatch slots per bucket
    max_queue: int = 1024         # pending-request bound (backpressure)
    max_dynamic: int = 8          # LRU cap on dynamically-created buckets

    def __post_init__(self):
        if not self.pad_lens or any(p <= 0 for p in self.pad_lens):
            raise ValueError(f"bad pad_lens {self.pad_lens}")
        if not 0.0 <= self.waste_cap <= 1.0:
            raise ValueError(f"waste_cap {self.waste_cap} not in [0, 1]")
        object.__setattr__(self, "pad_lens",
                           tuple(sorted(set(self.pad_lens))))


#: per-bucket counters folded into the registry when a bucket is evicted
_EVICTED_FIELDS = ("hits", "misses", "served", "real_tokens",
                   "padded_tokens")


class ShapeBucketScheduler:
    """Admission queue + bucket bookkeeping.  Pure host-side control plane:
    no device code in here, so every policy edge is unit-testable in
    microseconds.

    Stream-level counters (rejections, waste redirects, evictions, evicted
    bucket totals) live in a :class:`~repro_torch.obs.metrics.MetricsRegistry`
    (the engine shares its own); ``rejected``/``waste_redirects``/
    ``evictions`` remain as read-only views of those series."""

    def __init__(self, cfg: SchedulerConfig, *, fsets=("default",),
                 mode: str = "masked", max_prompt: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if mode not in ("masked", "equal"):
            raise ValueError(f"mode {mode!r} not in ('masked', 'equal')")
        self.cfg = cfg
        self.mode = mode
        self.fsets = tuple(fsets)
        self.metrics = metrics or MetricsRegistry()
        #: longest admissible prompt (engine: KV-cache head-room)
        self.max_prompt = max_prompt or max(cfg.pad_lens)
        self.buckets: dict[BucketKey, Bucket] = {}
        # configured (warmup-eligible) buckets exist up front, per fset
        for fset in self.fsets:
            for pad in cfg.pad_lens:
                key = BucketKey(pad, fset)
                self.buckets[key] = Bucket(key, cfg.max_batch,
                                           configured=True)
        self._queue: collections.deque = collections.deque()
        self._pending: dict[BucketKey, collections.deque] = (
            collections.defaultdict(collections.deque))
        self._queued_ids: set[int] = set()   # admission de-dup (id()s)
        self._drained: set[int] = set()   # id()s already pulled via a batch
        self._dynamic_lru: collections.OrderedDict = collections.OrderedDict()
        # cluster front-end: the router thread admits while a replica's
        # worker thread drains — every queue/bucket mutation holds this
        self._lock = threading.RLock()

    # -- registry-backed stream counters ----------------------------------

    @property
    def rejected(self) -> int:
        return int(self.metrics.value("serve.rejected"))

    def reject(self, n: int = 1) -> None:
        self.metrics.counter("serve.rejected").inc(n)

    @property
    def waste_redirects(self) -> int:
        return int(self.metrics.value("serve.waste_redirects"))

    @property
    def evictions(self) -> int:
        return int(self.metrics.value("serve.evictions"))

    @property
    def _evicted_totals(self) -> dict:
        """Counters of evicted dynamic buckets, folded into the registry so
        Engine.stats() totals survive eviction."""
        return {f: int(self.metrics.value("serve.evicted_totals", field=f))
                for f in _EVICTED_FIELDS}

    # -- bucket selection -------------------------------------------------

    def bucket_for(self, length: int, fset: str, *, commit: bool = True,
                   req_id: Optional[int] = None) -> BucketKey:
        """Best-fit bucket for a prompt of ``length`` (see module doc).
        Prompts longer than every configured bucket fall through to a
        dynamic exact-length bucket (``max_prompt`` still bounds them).

        ``commit=False`` resolves the key without touching any scheduler
        state (no bucket creation, LRU bump, or redirect counting) — the
        engine uses it to finish admission checks before committing.
        ``req_id``: the admitted request's, for a ``serve.evict`` event."""
        if length <= 0:
            raise AdmissionError(f"empty prompt (length {length})")
        if length > self.max_prompt:
            raise AdmissionError(
                f"prompt length {length} exceeds max admissible "
                f"{self.max_prompt}")
        if fset not in self.fsets:
            raise AdmissionError(
                f"unknown format-set tag {fset!r} (have {self.fsets})")
        with self._lock:
            if self.mode == "equal":
                return self._dynamic_or_configured(length, fset,
                                                   commit=commit,
                                                   req_id=req_id)
            fits = [p for p in self.cfg.pad_lens if p >= length]
            if fits:
                pad = fits[0]      # best fit = least padding
                waste = (pad - length) / pad
                if waste <= self.cfg.waste_cap:
                    return BucketKey(pad, fset)
                if commit:
                    self.metrics.counter("serve.waste_redirects").inc()
            return self._dynamic_or_configured(length, fset, commit=commit,
                                               req_id=req_id)

    def _dynamic_or_configured(self, length: int, fset: str, *,
                               commit: bool = True,
                               req_id: Optional[int] = None) -> BucketKey:
        key = BucketKey(length, fset)
        if key in self.buckets:
            if commit and not self.buckets[key].configured:
                self._dynamic_lru.move_to_end(key)
            return key
        if not commit:
            return key             # prospective only — nothing created
        # new dynamic (cold) bucket, LRU-capped: evict the least-recently
        # used dynamic bucket without pending work; if every one is busy,
        # temporarily exceed the cap rather than drop queued requests
        while len(self._dynamic_lru) >= self.cfg.max_dynamic:
            victim = next((k for k in self._dynamic_lru
                           if not self._pending.get(k)), None)
            if victim is None:
                break
            del self._dynamic_lru[victim]
            gone = self.buckets.pop(victim)
            for field in _EVICTED_FIELDS:
                self.metrics.counter("serve.evicted_totals",
                                     field=field).inc(getattr(gone, field))
            self._pending.pop(victim, None)
            self.metrics.counter("serve.evictions").inc()
            if obs.is_enabled():
                obs.event("serve.evict", "serve", bucket=str(victim),
                          served=gone.served, req_id=req_id)
        self.buckets[key] = Bucket(key, self.cfg.max_batch, configured=False)
        self._dynamic_lru[key] = True
        return key

    # -- admission --------------------------------------------------------

    def admit(self, req, length: int, fset: str = "default",
              key: Optional[BucketKey] = None) -> BucketKey:
        """Queue one request.  Returns its bucket key; raises
        :class:`AdmissionError` / :class:`QueueFullError`.  Callers that
        already resolved the bucket (the engine's pre-admission checks)
        pass ``key`` so redirect/LRU bookkeeping is not done twice."""
        with self._lock:
            if self.pending() >= self.cfg.max_queue:
                self.reject()
                raise QueueFullError(
                    f"admission queue full ({self.cfg.max_queue} pending)")
            if id(req) in self._queued_ids:
                self.reject()
                raise AdmissionError("request is already queued")
            try:
                key = key or self.bucket_for(length, fset)
            except AdmissionError:
                self.reject()
                raise
            self._queue.append((key, req))
            self._pending[key].append(req)
            self._queued_ids.add(id(req))
        if obs.is_enabled():
            obs.event("serve.admit", "serve", bucket=str(key),
                      req_id=getattr(req, "req_id", None), length=length,
                      fset=fset)
        return key

    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._pending.values())

    # -- microbatch formation --------------------------------------------

    def next_microbatch(self):
        """FIFO-fair draining: serve the bucket owning the oldest pending
        request, batching up to its slot count.  Returns
        ``(Bucket, [requests])`` or ``None`` when idle."""
        with self._lock:
            while self._queue and id(self._queue[0][1]) in self._drained:
                self._drained.discard(id(self._queue[0][1]))
                self._queue.popleft()    # already drained via its bucket
            if not self._queue:
                return None
            key = self._queue[0][0]
            bucket = self.buckets[key]
            q = self._pending[key]
            batch = [q.popleft() for _ in range(min(bucket.batch, len(q)))]
            for r in batch:
                self._drained.add(id(r))
                self._queued_ids.discard(id(r))
            if not bucket.configured and key in self._dynamic_lru:
                self._dynamic_lru.move_to_end(key)
            return bucket, batch

    def pop_pending(self, key: BucketKey):
        """Pull the oldest pending request for ``key`` out of turn — the
        engine's retire-and-refill hook: when a slot of an in-flight
        microbatch frees mid-decode, the next request for the *same*
        bucket joins it immediately rather than waiting for a fresh
        microbatch.  Returns a request or None.

        This trades strict global FIFO for occupancy: a refill may serve a
        younger request of this bucket before an older request of another
        bucket — but only into a slot no other bucket could use, so no
        request is ever *delayed* by a refill."""
        with self._lock:
            q = self._pending.get(key)
            if not q:
                return None
            req = q.popleft()
            self._drained.add(id(req))
            self._queued_ids.discard(id(req))
            return req

    def drain_pending(self) -> list:
        """Remove and return EVERY pending request, oldest first — the
        cluster front-end's stall hook: when a replica stops making
        progress, its undrained queue is pulled back out and re-routed to
        healthy replicas.  Requests already pulled into an in-flight
        microbatch are not (and cannot be) recalled."""
        with self._lock:
            out = []
            for key, req in list(self._queue):
                if id(req) not in self._queued_ids:
                    continue        # already drained into a microbatch
                out.append(req)
                self._queued_ids.discard(id(req))
                self._drained.add(id(req))
                self._pending[key].remove(req)   # identity ==  (eq=False)
            return out

    def exact_bucket(self, length: int, fset: str, *, commit: bool = True,
                     req_id: Optional[int] = None) -> BucketKey:
        """Bucket a request at its exact length, bypassing best-fit padding
        (the engine's KV-headroom fallback: a prompt whose *padded* length
        cannot fit ``max_new`` tokens in the cache may still fit unpadded)."""
        with self._lock:
            return self._dynamic_or_configured(length, fset, commit=commit,
                                               req_id=req_id)

    # -- reporting --------------------------------------------------------

    def totals(self) -> dict:
        """Bucket counters summed over live AND evicted buckets (eviction
        must never deflate the stream-level stats CI asserts on)."""
        t = dict(self._evicted_totals)
        for b in self.buckets.values():
            for field in t:
                t[field] += getattr(b, field)
        return t

    def stats(self) -> dict:
        return {
            "mode": self.mode,
            "pending": self.pending(),
            "rejected": self.rejected,
            "waste_redirects": self.waste_redirects,
            "evictions": self.evictions,
            "evicted_totals": dict(self._evicted_totals),
            "buckets": {str(k): b.stats()
                        for k, b in sorted(self.buckets.items(),
                                           key=lambda kv: (kv[0].fset,
                                                           kv[0].pad_len))},
        }
