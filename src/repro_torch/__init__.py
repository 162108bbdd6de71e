"""repro_torch — the tile-centric mixed-precision GEMM stack in PyTorch,
with hand-written CUDA kernels for one NVIDIA H100 (sm_90a).

The package mirrors ``repro``'s module names (``core``, ``kernels``,
``tune``, ``models``, ``serve``, …) so every module has a findable
counterpart, but it imports neither ``jax`` nor ``repro``: the JAX
package is the reference the tests hold this one to.

Importing the package is light: :func:`configure`, the process-global
settings facade (:mod:`repro_torch.config`, standard library only), is
bound at import; the subpackage names below are bound lazily, on first
attribute access.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on CPU tensors each kernel
wrapper computes its plain PyTorch version instead.
"""
from __future__ import annotations

import importlib

from repro_torch import config
from repro_torch.config import configure

__all__ = ["config", "configure", "bridge", "checkpoint", "configs", "core",
           "data", "formats", "kernels", "launch", "models", "obs", "optim",
           "quant", "runtime", "serve", "solve", "split", "train", "tree",
           "tune"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
