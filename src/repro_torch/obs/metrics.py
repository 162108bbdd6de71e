"""Process-local metrics registry — labeled counters and histograms (twin
of ``repro.obs.metrics`` without its gauges).

A *metric* is a name plus a label set
(``dispatch.calls{path=ksplit_cuda,op=linear,...}``); each distinct label
combination is its own series.  Creating or finding a series is a dict
lookup under a lock; the registry is always live, while the event tracer
(``repro_torch.obs.trace``) is the part that is off unless enabled.

Naming: ``<subsystem>.<noun>[_<unit>]`` (``tune.plan_resolutions``,
``serve.request.latency_s``), labels for the dimensions that fan out
(``path=``, ``source=``, ``op=``).
"""
from __future__ import annotations

import threading


def label_key(labels: dict) -> str:
    """Canonical series key: ``'a=1,b=x'`` (sorted); ``''`` for none."""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


#: guards the read-modify-write of every update: the cluster's replicas
#: update the process-global registry from their own threads
_UPDATE_LOCK = threading.Lock()


class Counter:
    """Monotonically-increasing value (float increments allowed)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        with _UPDATE_LOCK:
            self.value += v


class Histogram:
    """Streaming count/sum/min/max summary (no samples kept)."""

    __slots__ = ("count", "sum", "min", "max")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        with _UPDATE_LOCK:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0}


_KINDS = {"counter": Counter, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe name → {label set → series} store.

    ``counter()/histogram()`` create-or-return the series of one
    label combination (a name keeps its first kind: asking for another
    raises ``TypeError``); ``snapshot()`` returns plain data for reports;
    ``reset(name)`` clears one metric's series, ``reset()`` all."""

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

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """``{name: [{"labels": {...}, "value": v | summary-dict}, ...]}``
        — plain JSON-able data, sorted by label key."""
        out: dict = {}
        with self._lock:
            for name, (kind, table) in sorted(self._metrics.items()):
                out[name] = [
                    {"labels": dict(table[key][0]),
                     "value": (table[key][1].summary() if kind == "histogram"
                               else table[key][1].value)}
                    for key in sorted(table)]
        return out

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
