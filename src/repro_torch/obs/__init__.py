"""repro_torch.obs — runtime telemetry: metrics and tracing (twin of
``repro.obs``).

* a process-local :class:`~repro_torch.obs.metrics.MetricsRegistry` of
  labeled counters and histograms — always live — that dispatch,
  the serve engine and the scheduler record into;
* a span/event :class:`~repro_torch.obs.trace.Tracer` writing JSON lines
  that are Chrome ``trace_event`` dicts (open the export in Perfetto or
  ``chrome://tracing``).  Off by default: the default tracer is a shared
  no-op singleton, so an instrumented path pays one attribute load and a
  constant-time call, and its results do not change.

Facade::

    from repro_torch import obs
    obs.configure(enabled=True, trace_path="run.jsonl")
    with obs.span("solve.sweep", "solve", sweep=3):
        ...
    obs.event("serve.admit", "serve", bucket="S16/default")
    obs.metrics_registry().counter("dispatch.calls", path="tile").inc()
    obs.configure(enabled=False)          # back to the no-op tracer

Environment bootstrap: ``REPRO_TORCH_OBS_TRACE=<path>`` (or
``REPRO_TORCH_OBS=1`` for an in-memory tracer) enables tracing at import
time; ``repro_torch.configure(obs_trace=..., obs=...)`` does the same at
run time.  The JAX package's ``REPRO_OBS*`` variables are not read.
"""
from __future__ import annotations

import atexit
import os

from repro_torch.config import KNOWN_SETTINGS
from repro_torch.obs.metrics import (Counter, Histogram, MetricsRegistry,
                                     default_registry, label_key)
from repro_torch.obs.trace import (CATEGORIES, NULL_TRACER, NullTracer,
                                   Tracer, chrome_path_for, chrome_payload,
                                   export_chrome, read_events, span_types)

__all__ = [
    "Counter", "Histogram", "MetricsRegistry",
    "default_registry", "label_key", "metrics_registry",
    "CATEGORIES", "NullTracer", "Tracer", "chrome_payload",
    "chrome_path_for", "export_chrome", "read_events", "span_types",
    "configure", "is_enabled", "tracer", "span", "event",
]

#: environment variables of the import-time bootstrap
TRACE_ENV = KNOWN_SETTINGS["obs_trace"][0]
OBS_ENV = KNOWN_SETTINGS["obs"][0]

_TRACER = NULL_TRACER


def configure(enabled: bool = True, trace_path: str | None = None, *,
              t0: float | None = None) -> Tracer | NullTracer:
    """Install (or tear down) the process tracer.

    ``enabled=True`` with a ``trace_path`` streams JSONL events to that
    file; without a path, events collect in ``tracer().buffer``.
    ``enabled=False`` closes any active tracer and restores the no-op
    singleton — the default state, under which no trace file is created
    and instrumented paths compute exactly what uninstrumented ones do.
    ``t0`` sets the instant ``ts`` counts from (see :class:`Tracer`).
    """
    global _TRACER
    if _TRACER is not NULL_TRACER:
        _TRACER.close()
    _TRACER = Tracer(trace_path, t0=t0) if enabled else NULL_TRACER
    return _TRACER


def is_enabled() -> bool:
    return _TRACER.enabled


def tracer() -> Tracer | NullTracer:
    return _TRACER


def span(name: str, cat: str, **args):
    """Context manager tracing one complete span (no-op when disabled)."""
    return _TRACER.span(name, cat, **args)


def event(name: str, cat: str, **args) -> None:
    """Instant event (no-op when disabled)."""
    _TRACER.event(name, cat, **args)


def metrics_registry() -> MetricsRegistry:
    """The process-global metrics registry (always live)."""
    return default_registry()


def _env_bootstrap() -> None:
    path = os.environ.get(TRACE_ENV, "")
    if path:
        configure(enabled=True, trace_path=path)
    elif os.environ.get(OBS_ENV, "") not in ("", "0"):
        configure(enabled=True)


@atexit.register
def _close_at_exit() -> None:
    _TRACER.close()


_env_bootstrap()
