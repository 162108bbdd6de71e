"""Sharding hints for activations (twin of ``repro.models.shard_hints``).

The reference's hints are ``with_sharding_constraint`` calls that steer
XLA's SPMD partitioner.  Eager PyTorch has no partitioner: each rank
holds local tensors and the mesh code moves them explicitly
(``launch.mesh``), so ``hint``, ``batch_hint``, ``heads_hint`` and
``constrain_layer_params`` return their input unchanged, and the model
code does not call them.  What stays is the thread-local scope:
:func:`hints_enabled` makes a mesh active, and :func:`active_mesh` is
what ``models.transformer`` reads to route an MoE FFN through
``moe_block_sharded``, as the reference's does.
"""
from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


@contextlib.contextmanager
def hints_enabled(mesh):
    """Make ``mesh`` (a ``launch.mesh.Mesh``) the active mesh of this
    thread inside the scope."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def active_mesh():
    """The mesh enabled via hints_enabled, or None."""
    return getattr(_STATE, "mesh", None)


def hint(x, *spec):
    """Identity (the reference constrains ``x`` to ``spec``)."""
    return x


def constrain_layer_params(layer_params, cfg, zero: bool = False):
    """Identity (the reference re-applies the parameter sharding inside
    its scan body)."""
    return layer_params


def batch_hint(x):
    """Identity (the reference shards the leading dim over the data
    axes)."""
    return x


def heads_hint(x):
    """Identity (the reference shards [B, H, S, dh]'s heads over
    'model')."""
    return x
