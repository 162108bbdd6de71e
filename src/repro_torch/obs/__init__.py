"""Runtime metrics of the port (the tracer of ``repro.obs`` comes later)."""
from repro_torch.obs.metrics import (Counter, Histogram, MetricsRegistry,
                                     default_registry)

__all__ = ["Counter", "Histogram", "MetricsRegistry", "default_registry",
           "metrics_registry"]


def metrics_registry() -> MetricsRegistry:
    """The process-global metrics registry."""
    return default_registry()
