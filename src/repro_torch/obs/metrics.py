"""Process-local metrics registry — labeled counters and histograms (the
part of ``repro.obs.metrics`` that dispatch and the serve engine use).

A *metric* is a name plus a label set
(``dispatch.calls{path=ksplit_cuda,op=linear,...}``); each distinct label
combination is its own series.  Increments are a dict lookup and a float
add under a lock.
"""
from __future__ import annotations

import threading


def label_key(labels: dict) -> str:
    """Canonical series key: ``'a=1,b=x'`` (sorted); ``''`` for none."""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


class Counter:
    """Monotonically-increasing value (float increments allowed)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Histogram:
    """Streaming count/sum/min/max summary."""

    __slots__ = ("count", "sum", "min", "max")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


_KINDS = {"counter": Counter, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe name → {label set → series} store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, tuple[str, dict]] = {}

    def _series(self, kind: str, name: str, labels: dict):
        key = label_key(labels)
        with self._lock:
            ent = self._metrics.get(name)
            if ent is None:
                ent = (kind, {})
                self._metrics[name] = ent
            elif ent[0] != kind:
                raise TypeError(f"metric {name!r} is a {ent[0]}, not a {kind}")
            hit = ent[1].get(key)
            if hit is None:
                hit = (dict(labels), _KINDS[kind]())
                ent[1][key] = hit
            return hit[1]

    def counter(self, name: str, **labels) -> Counter:
        return self._series("counter", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._series("histogram", name, labels)

    def series(self, name: str) -> list[tuple[dict, object]]:
        """Every (labels, series) of one metric (empty if absent)."""
        with self._lock:
            ent = self._metrics.get(name)
            return [(dict(lab), s) for lab, s in ent[1].values()] if ent \
                else []

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """One counter's value, without creating the series."""
        with self._lock:
            ent = self._metrics.get(name)
            if ent is None:
                return default
            hit = ent[1].get(label_key(labels))
            return hit[1].value if hit else default

    def reset(self, name: str | None = None) -> None:
        with self._lock:
            if name is None:
                self._metrics.clear()
            else:
                self._metrics.pop(name, None)


#: the process-global registry (tune dispatch records here; the serve
#: engine keeps a per-instance one)
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
