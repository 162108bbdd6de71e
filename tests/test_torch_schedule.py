"""Port parity: ``repro_torch.core.schedule`` (static load-balancing of
precision maps) against ``repro.core.schedule``, twins of
``tests/test_schedule.py``.  The module is numpy: every map equals the
reference's bit for bit for the same policy and seed, and each property
the reference asserts is asserted on the port's map too."""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.core import schedule as JS
from repro.core.formats import DEFAULT_FORMATS as JFS
from repro.core.precision import Policy as JPolicy
from repro.core.summa import _panel_owner_steps as j_steps
from repro_torch.core import schedule
from repro_torch.core.formats import DEFAULT_FORMATS as FS
from repro_torch.core.precision import Policy, make_map
from repro_torch.core.summa import _panel_owner_steps


def _pol(**kw):
    return Policy(**kw), JPolicy(**kw)


@settings(max_examples=30, deadline=None)
@given(p=st.integers(1, 4), q=st.integers(1, 4),
       reps=st.integers(1, 4), ratio=st.sampled_from([0.0, 0.25, 0.5, 1.0]),
       seed=st.integers(0, 100))
def test_balanced_map_imbalance_is_one(p, q, reps, ratio, seed):
    mt, nt = p * reps * 4, q * reps * 4
    pol, jpol = _pol(kind="ratio", ratio_high=ratio, seed=seed)
    m = schedule.balanced_ratio_map(mt, nt, pol, p, q)
    np.testing.assert_array_equal(
        m, JS.balanced_ratio_map(mt, nt, jpol, p, q))
    assert schedule.imbalance(m, p, q) == pytest.approx(1.0)
    assert schedule.imbalance(m, p, q) == JS.imbalance(m, p, q)


def test_random_map_is_imbalanced_balanced_map_fixes_it():
    pol, jpol = _pol(kind="ratio", ratio_high=0.5, seed=3)
    rand = make_map((32, 32), 1, pol)
    bal = schedule.balanced_ratio_map(32, 32, pol, 4, 4)
    np.testing.assert_array_equal(
        bal, JS.balanced_ratio_map(32, 32, jpol, 4, 4))
    assert schedule.imbalance(rand, 4, 4) > 1.01
    assert schedule.imbalance(rand, 4, 4) == JS.imbalance(rand, 4, 4)
    assert schedule.imbalance(bal, 4, 4) == pytest.approx(1.0)


@settings(max_examples=20, deadline=None)
@given(axis=st.sampled_from([0, 1]), groups=st.sampled_from([1, 2, 4]),
       ratio=st.sampled_from([0.0, 0.25, 0.5, 0.75, 1.0]))
def test_sorted_balanced_map_properties(axis, groups, ratio):
    pol, jpol = _pol(kind="ratio", ratio_high=ratio)
    m = schedule.sorted_balanced_map(16, 8, pol, axis=axis, groups=groups)
    np.testing.assert_array_equal(
        m, JS.sorted_balanced_map(16, 8, jpol, axis=axis, groups=groups))
    mm = m if axis == 0 else m.T
    seg = mm.shape[0] // groups
    counts = set()
    for g in range(groups):
        blk = mm[g * seg:(g + 1) * seg]
        for j in range(mm.shape[1]):
            col = blk[:, j]
            hi = int((col == FS.high).sum())
            counts.add(hi)
            assert (col[:hi] == FS.high).all()   # HIGH first in a segment
    assert len(counts) == 1


@settings(max_examples=16, deadline=None)
@given(axis=st.sampled_from([0, 1]), groups=st.sampled_from([1, 2, 4]),
       ratio=st.sampled_from([0.0, 0.25, 0.5]),
       ratio8=st.sampled_from([0.0, 0.25, 0.5]))
def test_sorted_balanced_map_n_class_invariants(axis, groups, ratio,
                                                ratio8):
    """Every segment-panel has identical per-class counts for every class,
    classes in descending storage cost (``fset.class_order``)."""
    pol, jpol = _pol(kind="ratio", ratio_high=ratio, ratio_low8=ratio8)
    m = schedule.sorted_balanced_map(16, 8, pol, axis=axis, groups=groups)
    np.testing.assert_array_equal(
        m, JS.sorted_balanced_map(16, 8, jpol, axis=axis, groups=groups))
    assert FS.class_order == JFS.class_order
    mm = m if axis == 0 else m.T
    seg = mm.shape[0] // groups
    counts = set()
    for g in range(groups):
        blk = mm[g * seg:(g + 1) * seg]
        for j in range(mm.shape[1]):
            col = blk[:, j]
            counts.add(tuple(int((col == c).sum()) for c in FS.codes))
            canon = np.concatenate(
                [np.full(int((col == c).sum()), c, np.int8)
                 for c in FS.class_order])
            assert np.array_equal(col, canon)
    assert len(counts) == 1


def test_sorted_balanced_map_indivisible_groups_raises():
    pol, jpol = _pol(kind="ratio", ratio_high=0.5)
    for mod, p in ((schedule, pol), (JS, jpol)):
        with pytest.raises(ValueError, match="must divide"):
            mod.sorted_balanced_map(15, 8, p, axis=0, groups=4)
        with pytest.raises(ValueError, match="must divide"):
            mod.balanced_ratio_map(15, 8, p, 4, 1)


def test_panel_owner_steps_raises_instead_of_bad_slicing():
    with pytest.raises(ValueError, match="divide evenly"):
        _panel_owner_steps(K=48, tile=8, P=4, Q=2)   # kt=6, 6 % 4 != 0
    with pytest.raises(ValueError, match="multiple of tile"):
        _panel_owner_steps(K=50, tile=8, P=1, Q=1)
    qa, la, pb, lb = _panel_owner_steps(K=64, tile=8, P=2, Q=4)
    for got, want in zip((qa, la, pb, lb), j_steps(K=64, tile=8, P=2, Q=4)):
        np.testing.assert_array_equal(got, want)
    kloc_a, kloc_b = 64 // 4, 64 // 2
    for step in range(8):
        assert qa[step] * (kloc_a // 8) + la[step] == step
        assert pb[step] * (kloc_b // 8) + lb[step] == step


def test_is_shard_balanced():
    pol, jpol = _pol(kind="ratio", ratio_high=0.5, seed=2)
    bal = schedule.balanced_ratio_map(8, 8, pol, 2, 2)
    np.testing.assert_array_equal(bal, JS.balanced_ratio_map(8, 8, jpol, 2, 2))
    assert schedule.is_shard_balanced(bal, 2, 2)
    unbal = np.full((8, 8), 1, np.int8)
    unbal[0, 0] = 2
    assert not schedule.is_shard_balanced(unbal, 2, 2)
    assert not schedule.is_shard_balanced(bal, 3, 2)   # indivisible grid
    for m, g in ((bal, (2, 2)), (unbal, (2, 2)), (bal, (3, 2))):
        assert schedule.is_shard_balanced(m, *g) == JS.is_shard_balanced(
            m, *g)


def test_shard_costs_reflect_mxu_model():
    pol, jpol = _pol(kind="uniform_high")
    m = schedule.balanced_ratio_map(8, 8, pol, 2, 2)
    costs = schedule.shard_costs(m, 2, 2)
    assert (costs == 16 * 3.0).all()   # 16 tiles × HIGH cost 3
    np.testing.assert_array_equal(costs, JS.shard_costs(m, 2, 2))
    pol_lo, _ = _pol(kind="uniform_low")
    m2 = schedule.balanced_ratio_map(8, 8, pol_lo, 2, 2)
    assert (schedule.shard_costs(m2, 2, 2) == 16 * 1.0).all()
    for kind in ("gpu-h100", "cpu"):   # the port's pass costs per device
        np.testing.assert_array_equal(
            schedule.shard_costs(m, 2, 2, device_kind=kind),
            JS.shard_costs(m, 2, 2, device_kind=kind))
