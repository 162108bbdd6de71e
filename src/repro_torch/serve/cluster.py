"""Multi-replica serving front-end: data-parallel Engines behind one
admission queue (twin of ``repro.serve.cluster``).

``replicas`` :class:`~repro_torch.serve.engine.Engine` instances share one
parameter tree (nothing is copied per replica: every replica's weights
are the caller's tensors) and one admission front-end:

* **Bounded global queue.**  Pending requests across the cluster are
  capped at ``max_queue × replicas``; beyond that ``submit`` raises
  :class:`~repro_torch.serve.scheduler.QueueFullError`.
* **Load-aware routing.**  Each admission goes to the healthy replica
  with the fewest *outstanding tokens* (prompt + max_new of everything
  routed there and not yet retired).  Within ``AFFINITY_SLACK`` the
  replica that last served the request's (bucket, format set) wins,
  then the lowest id.  Routing is a pure function of the submission
  sequence, and a request's tokens do not depend on its replica: every
  replica has the same ``rng_seed`` and weights.
* **Graceful degradation.**  ``run()`` drains every replica on its own
  thread while a monitor samples progress heartbeats (prefill positions,
  decode steps, retirements and refills, counted as they happen).  A replica that
  raises, or makes no progress for ``stall_timeout_s`` while holding
  work, is marked unhealthy (``serve.replica_stall`` event); its queued
  requests are pulled back (:meth:`ShapeBucketScheduler.drain_pending`)
  and re-routed to healthy replicas (``serve.reroute``).  Requests inside
  the stalled replica's in-flight microbatch cannot be recalled: they
  come back with ``error`` set.

Before the drain threads start, ``run()`` builds the CUDA kernels (the
first build takes about a minute, which a drain thread's monitor would
read as a stall) and, under ``ServeConfig.warmup``, warms every replica
not warmed yet.  Both replicas' threads launch on the device's current
stream, as the reference's replicas share its one device.

``Cluster`` mirrors the single-engine surface (``submit`` / ``run`` /
``generate`` / ``warmup`` / ``stats``), so launchers swap between them on
``ServeConfig.replicas`` alone.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from repro_torch import obs
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.scheduler import AdmissionError, QueueFullError

__all__ = ["AFFINITY_SLACK", "Cluster"]

#: outstanding-token slack within which format/bucket affinity may
#: override strict least-loaded routing
AFFINITY_SLACK = 0.25

#: engine counters whose movement is a replica's heartbeat: the
#: reference's three plus prefill positions, since the port prefills by
#: stepping the decode function (seconds at full depth with no decode step)
HEARTBEAT = ("serve.decode_steps", "serve.requests_served", "serve.refills",
             "serve.prefill_steps")


class Cluster:
    """N data-parallel Engine replicas behind one admission front-end."""

    def __init__(self, cfg, params, config: Optional[ServeConfig] = None,
                 *, variants: Optional[dict] = None):
        config = config or ServeConfig()
        self.config = config
        self.replicas = [Engine(cfg, params, config, variants=variants)
                         for _ in range(config.replicas)]
        self._healthy = [True] * config.replicas
        # routing state: outstanding token cost per replica, and the
        # replica that last served each (pad bucket, fset) pair
        self._outstanding = [0] * config.replicas
        self._affinity: dict[tuple, int] = {}
        self._routed: list[list[Request]] = [[] for _ in self.replicas]
        self._lock = threading.RLock()
        self._serve_s = 0.0

    # -- admission / routing ----------------------------------------------

    @staticmethod
    def _cost(req: Request) -> int:
        return len(req.prompt) + req.max_new_tokens

    def _affinity_key(self, req: Request) -> tuple:
        """The best-fit configured pad (the exact bucket is the
        replica's business) plus the format tag."""
        L = len(req.prompt)
        fits = [p for p in self.replicas[0].scheduler.cfg.pad_lens
                if p >= L]
        return (fits[0] if fits else L, req.fset)

    def _pick_replica(self, req: Request) -> int:
        cand = [i for i, ok in enumerate(self._healthy)
                if ok and self.replicas[i].scheduler.pending()
                < self.config.max_queue]
        if not cand:
            raise QueueFullError(
                "every healthy replica is at queue capacity")
        best = min(cand, key=lambda i: (self._outstanding[i], i))
        akey = self._affinity_key(req)
        if self.config.affinity:
            warm = self._affinity.get(akey)
            if warm in cand and warm != best:
                slack = max(1, int(self._cost(req) + AFFINITY_SLACK
                                   * max(self._outstanding[best], 1)))
                if self._outstanding[warm] - self._outstanding[best] \
                        <= slack:
                    best = warm
        self._affinity[akey] = best
        return best

    def submit(self, req: Request) -> int:
        """Route one request to a replica; returns the replica id.
        Raises AdmissionError/QueueFullError as ``Engine.submit`` does."""
        with self._lock:
            total_cap = self.config.max_queue * len(self.replicas)
            if sum(e.scheduler.pending() for e in self.replicas) \
                    >= total_cap:
                raise QueueFullError(
                    f"cluster queue full ({total_cap} pending)")
            rid = self._pick_replica(req)
            self.replicas[rid].submit(req)     # may raise AdmissionError
            req.replica = rid
            self._outstanding[rid] += self._cost(req)
            self._routed[rid].append(req)
            if obs.is_enabled():
                obs.event("serve.route", "serve", replica=rid,
                          length=len(req.prompt), fset=req.fset,
                          outstanding=self._outstanding[rid])
            return rid

    # -- lifecycle ---------------------------------------------------------

    def warmup(self) -> dict:
        return {f"replica{i}": e.warmup()
                for i, e in enumerate(self.replicas)}

    def _prepare(self) -> None:
        """Build the kernels and warm the replicas before any drain
        thread runs (see the module docstring)."""
        if any(e.device.type == "cuda" for e in self.replicas):
            from repro_torch.kernels import ops
            ops.ensure_built()
        if self.config.warmup:
            for e in self.replicas:
                if e._fresh_at_warmup is None:
                    e.warmup()

    def _settle(self) -> None:
        """After a drain: outstanding cost and routed lists keep only
        requests still in flight."""
        with self._lock:
            for rid, lst in enumerate(self._routed):
                live = [r for r in lst if not r.done]
                self._outstanding[rid] = sum(self._cost(r) for r in live)
                self._routed[rid] = live

    def run(self) -> None:
        """Drain every replica concurrently; re-route on stall/crash."""
        work = [i for i, e in enumerate(self.replicas)
                if self._healthy[i] and e.scheduler.pending()]
        if work:
            self._prepare()
        t0 = time.perf_counter()
        while work:
            errors: dict[int, BaseException] = {}

            def drain(rid: int) -> None:
                try:
                    self.replicas[rid].run()
                except BaseException as e:     # noqa: BLE001 — stall path
                    errors[rid] = e

            threads = {rid: threading.Thread(target=drain, args=(rid,),
                                             daemon=True)
                       for rid in work}
            for t in threads.values():
                t.start()
            stalled = self._watch(threads, errors)
            rerouted = []
            for rid in stalled:
                self._healthy[rid] = False
                pulled = self.replicas[rid].scheduler.drain_pending()
                obs.event("serve.replica_stall", "serve", replica=rid,
                          error=str(errors.get(rid, "no progress")),
                          rerouted=len(pulled))
                with self._lock:
                    for r in pulled:
                        self._routed[rid].remove(r)
                    self._outstanding[rid] = 0
                rerouted.extend(pulled)
                # in-flight requests the stalled replica never finished
                for r in self._routed[rid]:
                    if not r.done and not r.error:
                        r.error = ("ReplicaStall: replica "
                                   f"{rid} stalled mid-flight")
            for r in rerouted:
                try:
                    self.submit(r)
                    if obs.is_enabled():
                        obs.event("serve.reroute", "serve",
                                  replica=r.replica)
                except (AdmissionError, QueueFullError) as e:
                    r.error = f"{type(e).__name__}: {e}"
            self._settle()
            work = [i for i, e in enumerate(self.replicas)
                    if self._healthy[i] and e.scheduler.pending()]
        self._serve_s += time.perf_counter() - t0

    def _watch(self, threads: dict, errors: dict) -> list[int]:
        """Join the drain threads while sampling heartbeats.  Returns the
        replicas declared stalled (raised, or no heartbeat movement for
        ``stall_timeout_s`` while still running)."""

        def beat(rid: int) -> int:
            m = self.replicas[rid].metrics
            return sum(int(m.value(name)) for name in HEARTBEAT)

        timeout = self.config.stall_timeout_s
        last = {rid: (beat(rid), time.monotonic()) for rid in threads}
        stalled: list[int] = []
        live = dict(threads)
        while live:
            for rid, t in list(live.items()):
                t.join(timeout=min(0.05, timeout / 10))
                if not t.is_alive():
                    del live[rid]
                    if rid in errors:
                        stalled.append(rid)
                    continue
                b = beat(rid)
                prev, t0 = last[rid]
                if b != prev:
                    last[rid] = (b, time.monotonic())
                elif time.monotonic() - t0 > timeout:
                    # abandon the wedged daemon thread: if it ever wakes
                    # it finds its queue drained and exits idle
                    stalled.append(rid)
                    del live[rid]
        return stalled

    def generate(self, requests: list[Request]) -> list[Request]:
        """Route and drain a request list (as ``Engine.generate``)."""
        for r in requests:
            try:
                self.submit(r)
            except (AdmissionError, QueueFullError) as e:
                r.error = f"{type(e).__name__}: {e}"
        self.run()
        return requests

    # -- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        """Totals over the replicas and each replica's ``stats()``.  Fresh
        plan resolutions are counted process-wide (the plan registry is
        shared): the cluster's figure is the largest any replica reads
        since its own warmup (None before every replica warmed)."""
        per = [e.stats() for e in self.replicas]
        fresh = [p["plans"]["post_warmup_fresh_resolutions"] for p in per]
        generated = sum(p["tokens"]["generated"] for p in per)
        return {
            "replicas": len(self.replicas),
            "healthy": sum(self._healthy),
            "requests": {
                "served": sum(p["requests"]["served"] for p in per),
                "rejected": sum(p["requests"]["rejected"] for p in per),
            },
            "tokens": {
                k: sum(p["tokens"][k] for p in per)
                for k in ("prompt", "padded", "generated")
            },
            "decode_steps": sum(p["decode_steps"] for p in per),
            "post_warmup_fresh_resolutions": (
                None if None in fresh else max(fresh)),
            "serve_time_s": self._serve_s,
            "tokens_per_s": generated / self._serve_s if self._serve_s
            else 0.0,
            "per_replica": per,
        }
