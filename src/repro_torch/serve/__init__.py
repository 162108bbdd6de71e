"""Serving stack (twin of ``repro.serve``): one engine, or a cluster of
replicas behind one admission front-end.  ``ServeConfig``, the scheduler
and the KV-page control plane (``repro_torch.serve.kv_pages``) import
without torch device work; ``Engine``/``Request``/``Cluster`` load the
model stack on first use::

    from repro_torch.serve import Cluster, Engine, Request, ServeConfig
    eng = Engine(cfg, params, ServeConfig(max_batch=4))
    cl = Cluster(cfg, params, ServeConfig(replicas=2))
"""
from repro_torch.serve.config import DEFAULT_PAD_LENS, ServeConfig

__all__ = ["Cluster", "DEFAULT_PAD_LENS", "Engine", "Request",
           "ServeConfig"]

_LAZY = {"Engine": "repro_torch.serve.engine",
         "Request": "repro_torch.serve.engine",
         "Cluster": "repro_torch.serve.cluster"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(_LAZY[name]), name)
