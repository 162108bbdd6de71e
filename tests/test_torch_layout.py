"""Twins of ``tests/test_layout.py`` for the port's layouts that
``tests/test_torch_formats.py`` does not cover: the K-split weight
refuses a tile that does not divide K, the N-split weight refuses an
unsorted class vector (both as the reference does), and a layout taken
apart into its buffers and rebuilt is the same matrix (the port's
counterpart of a pytree round trip: ``repro_torch.tree``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as JL
from repro_torch import tree as TR
from repro_torch.core.layout import KSplitWeight, MPMatrix, NSplitWeight
from repro_torch.core.linear import MPLinear, split_cls
from repro_torch.core.precision import Policy, make_map


def test_ksplit_rejects_bad_tile():
    bad = np.zeros(7, np.int8)
    with pytest.raises(ValueError):
        KSplitWeight.from_dense(torch.zeros((100, 64)), bad, 16)
    with pytest.raises(ValueError):
        JL.KSplitWeight.from_dense(jnp.zeros((100, 64)), bad, 16)


def test_nsplit_requires_sorted():
    bad = np.array([1, 2, 1, 2], np.int8)  # unsorted
    with pytest.raises(ValueError):
        NSplitWeight.from_dense(torch.zeros((32, 64)), bad, 16)
    with pytest.raises(ValueError):
        JL.NSplitWeight.from_dense(jnp.zeros((32, 64)), bad, 16)


def test_pytree_roundtrip():
    """An MPMatrix rebuilt from its buffers (the leaves) and its map,
    tile, shape and set (the structure) is the same matrix; a parameter
    tree of K- and N-split linears walks into its tensors and rebuilds
    from them unchanged."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((32, 32), generator=g)
    cls = make_map((32, 32), 8, Policy(kind="ratio", ratio_high=0.5))
    m = MPMatrix.from_dense(w, cls, 8)
    m2 = dataclasses.replace(m, bufs=tuple(b.clone() for b in m.bufs))
    np.testing.assert_array_equal(m.to_dense().numpy(),
                                  m2.to_dense().numpy())
    pol = Policy(kind="ratio", ratio_high=0.25)
    tree = {"k": MPLinear(KSplitWeight.from_dense(w, split_cls(4, pol), 8)),
            "n": MPLinear(NSplitWeight.from_dense(w, split_cls(4, pol), 8))}
    leaves = TR.tensors(tree)
    rebuilt = TR.replace_tensors(tree, {id(t): t.clone() for t in leaves})
    x = torch.randn((3, 32), generator=g)
    for name in tree:
        assert rebuilt[name].w.shape == tree[name].w.shape
        np.testing.assert_array_equal(rebuilt[name](x).numpy(),
                                      tree[name](x).numpy())
    assert [t.shape for t in TR.tensors(rebuilt)] == \
        [t.shape for t in leaves]
