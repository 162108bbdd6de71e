"""ServeConfig: the one construction surface of the serve stack (twin of
``repro.serve.config``; the legacy-kwargs shim is not ported)::

    from repro_torch.serve import Engine, ServeConfig
    eng = Engine(cfg, params, ServeConfig(max_batch=4))

The defaults are the reference's: slot refill, the paged prefix cache
and chunked long-prompt prefill are on; one engine serves unless
``replicas`` asks for a :class:`~repro_torch.serve.cluster.Cluster`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serve.scheduler import SchedulerConfig

__all__ = ["DEFAULT_PAD_LENS", "ServeConfig"]

#: engine defaults when neither ServeConfig.buckets nor
#: ArchConfig.serve_buckets specify pad lengths
DEFAULT_PAD_LENS = (16, 32, 64, 128)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Every serve-stack knob the port has, validated once at
    construction.

    Scheduler shape policy:

    * ``buckets`` — configured pad lengths (None → ``ArchConfig.
      serve_buckets``, then :data:`DEFAULT_PAD_LENS`).
    * ``waste_cap`` / ``max_batch`` / ``max_queue`` / ``max_dynamic`` —
      see :class:`~repro_torch.serve.scheduler.SchedulerConfig`.

    Engine:

    * ``max_seq`` — KV-cache length (bounds prompt+generation).
    * ``rng_seed`` — engine seed of the sampling streams; a request's
      stream mixes it with the request's ``seed`` and the token index.
    * ``refill`` — mid-decode slot retire-and-refill.
    * ``prefix_cache`` — block-paged prefix-KV reuse.
    * ``prefix_pages`` — page-pool capacity: the prefix cache LRU-evicts
      digests once this many pages are resident.
    * ``page_tokens`` — KV positions per page; bucket prefix points and
      chunk skips align down to this granularity.
    * ``chunked_prefill`` — serve prompts longer than every configured
      bucket by chunked paged prefill (off → such prompts use cold
      exact-length buckets).
    * ``warmup`` — resolve plans and build the kernels at startup
      (honoured by the launcher; ``Engine.warmup()`` stays explicit).
    * ``summa_grid`` — run the SUMMA self-check for this P×Q grid at
      engine construction (None → ``ArchConfig.summa_grid``).

    Cluster:

    * ``replicas`` — data-parallel engines behind the front-end.
    * ``affinity`` — prefer the replica that last served a request's
      (bucket, format set) when load is within ``AFFINITY_SLACK``.
    * ``stall_timeout_s`` — no-progress window after which a replica is
      declared stalled and its pending work re-routed.
    """
    buckets: Optional[tuple] = None
    waste_cap: float = 0.75
    max_batch: int = 4
    max_queue: int = 1024
    max_dynamic: int = 8
    max_seq: int = 256
    rng_seed: int = 0
    summa_grid: Optional[tuple] = None
    refill: bool = True
    prefix_cache: bool = True
    prefix_pages: int = 128
    page_tokens: int = 4
    chunked_prefill: bool = True
    warmup: bool = True
    replicas: int = 1
    affinity: bool = True
    stall_timeout_s: float = 10.0

    def __post_init__(self):
        if self.buckets is not None:
            object.__setattr__(self, "buckets",
                               tuple(sorted(set(int(b)
                                                for b in self.buckets))))
        for field, lo in (("max_batch", 1), ("max_queue", 1),
                          ("max_dynamic", 1), ("max_seq", 2),
                          ("prefix_pages", 1), ("page_tokens", 1),
                          ("replicas", 1)):
            if getattr(self, field) < lo:
                raise ValueError(f"{field} {getattr(self, field)} < {lo}")
        if not 0.0 <= self.waste_cap <= 1.0:
            raise ValueError(f"waste_cap {self.waste_cap} not in [0, 1]")
        if self.stall_timeout_s <= 0:
            raise ValueError(f"stall_timeout_s {self.stall_timeout_s} <= 0")

    def pad_lens(self, arch_buckets: Optional[tuple] = None) -> tuple:
        """Configured pad lengths with the documented fallback chain."""
        return tuple(self.buckets or arch_buckets or DEFAULT_PAD_LENS)

    def scheduler_config(self,
                         arch_buckets: Optional[tuple] = None,
                         ) -> SchedulerConfig:
        return SchedulerConfig(pad_lens=self.pad_lens(arch_buckets),
                               waste_cap=self.waste_cap,
                               max_batch=self.max_batch,
                               max_queue=self.max_queue,
                               max_dynamic=self.max_dynamic)
