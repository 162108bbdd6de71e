"""ServeConfig: the one construction surface of the serve stack (twin of
``repro.serve.config``; the legacy-kwargs shim is not ported)::

    from repro_torch.serve import Engine, ServeConfig
    eng = Engine(cfg, params, ServeConfig(max_batch=4, refill=False,
                                          prefix_cache=False,
                                          chunked_prefill=False))

The port's engine serves the masked-mode path with ``refill``,
``prefix_cache`` and ``chunked_prefill`` off (the port's defaults); it
rejects a config that turns any of them on.
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
    * ``refill`` / ``prefix_cache`` / ``chunked_prefill`` — the
      reference's slot refill, paged prefix reuse and chunked long-prompt
      prefill.  Not ported yet: only ``False`` (the default here) is
      served; ``True`` makes the engine raise ``NotImplementedError``.
    """
    buckets: Optional[tuple] = None
    waste_cap: float = 0.75
    max_batch: int = 4
    max_queue: int = 1024
    max_dynamic: int = 8
    max_seq: int = 256
    refill: bool = False
    prefix_cache: bool = False
    chunked_prefill: bool = False

    def __post_init__(self):
        if self.buckets is not None:
            object.__setattr__(self, "buckets",
                               tuple(sorted(set(int(b)
                                                for b in self.buckets))))
        for field, lo in (("max_batch", 1), ("max_queue", 1),
                          ("max_dynamic", 1), ("max_seq", 2)):
            if getattr(self, field) < lo:
                raise ValueError(f"{field} {getattr(self, field)} < {lo}")
        if not 0.0 <= self.waste_cap <= 1.0:
            raise ValueError(f"waste_cap {self.waste_cap} not in [0, 1]")

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
