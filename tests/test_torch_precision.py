"""Twins of ``tests/test_precision.py`` for the port's
``repro_torch.core.precision`` (the rest of its twins are in
``tests/test_torch_formats.py``): the property tests over random grids
and every format-set flavour, the class-code and low8-role failure
paths, the paper's endpoints and the tile round trip.  Every map and
count is also held to the reference's, bit for bit.

The property tests draw only (ratio, ratio8) pairs with ratio + ratio8
≤ 1: an over-unity pair is the ValueError path, tested on its own (the
reference's bound tests draw such pairs, ``ROADMAP.md`` queue 3).
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import formats as JF
from repro.core import precision as JP
from repro_torch.core import formats as PF
from repro_torch.core import layout as PL
from repro_torch.core import precision as P

#: every registered format-set flavour the property tests sweep
FSETS = {
    "default": ("fp8_e4m3", "bf16", "fp32"),
    "fp8_e5m2": ("fp8_e5m2", "fp16", "fp32"),
    "fp16": ("fp16", "fp32"),
}


def _sets(fs):
    return PF.format_set(*FSETS[fs]), JF.format_set(*FSETS[fs])


def _jpolicy(p: P.Policy) -> JP.Policy:
    return JP.Policy(p.kind, p.ratio_high, p.ratio_low8, p.outlier_sigma,
                     p.seed)


def test_paper_ratio_endpoints():
    fs = PF.DEFAULT_FORMATS
    m_hi = P.make_map((64, 64), 16, P.PAPER_RATIOS["100D:0S"])
    assert (m_hi == fs.high).all()
    m_lo = P.make_map((64, 64), 16, P.PAPER_RATIOS["0D:100S"])
    assert (m_lo == fs.low).all()
    for name, pol in P.PAPER_RATIOS.items():
        np.testing.assert_array_equal(
            P.make_map((64, 64), 16, pol),
            JP.make_map((64, 64), 16, JP.PAPER_RATIOS[name]))


@settings(max_examples=50, deadline=None)
@given(n_hi=st.integers(0, 7), n_lo=st.integers(0, 7), n_lo8=st.integers(0, 7))
def test_ratio_string_components_always_sum_to_100(n_hi, n_lo, n_lo8):
    """Largest-remainder apportionment sums to exactly 100 with every
    component within 1 of its exact value, and equals the reference's
    string."""
    total = n_hi + n_lo + n_lo8
    if total == 0:
        return
    m = np.array([2] * n_hi + [1] * n_lo + [0] * n_lo8,
                 np.int8).reshape(1, total)
    s = P.map_ratio_string(m)
    assert s == JP.map_ratio_string(m)
    parts = {seg[-1]: int(seg[:-1]) for seg in s.split(":")}
    assert sum(parts.values()) == 100, s
    exact = {"D": 100 * n_hi / total, "S": 100 * n_lo / total,
             "Q": 100 * n_lo8 / total}
    for tag, val in parts.items():
        assert abs(val - exact[tag]) < 1.0, (s, exact)


def test_map_storage_bytes_rejects_unknown_class():
    m = np.array([[0, 1], [2, 5]], np.int8)   # 5 is not a registered code
    with pytest.raises(ValueError, match="outside format set"):
        P.map_storage_bytes(m, 8)


def test_role_counts_q_without_low8_role_raises():
    """A Q fraction on a 2-format set has no role to place it in; an
    over-unity sum raises its own error even when a low8 role exists."""
    fs = PF.format_set("fp16", "fp32")
    pol = P.Policy(kind="ratio", ratio_high=0.25, ratio_low8=0.25)
    with pytest.raises(ValueError, match="no low8 role"):
        P.make_map((64, 64), 16, pol, fset=fs)
    with pytest.raises(ValueError, match="exceeds 1"):
        P.make_map((64, 64), 16,
                   P.Policy(kind="ratio", ratio_high=1.0, ratio_low8=0.25))


@settings(max_examples=40, deadline=None)
@given(mt=st.integers(1, 10), nt=st.integers(1, 10),
       hi=st.floats(0.0, 1.0), q=st.floats(0.0, 1.0),
       fs=st.sampled_from(sorted(FSETS)), seed=st.integers(0, 999))
def test_make_map_exact_role_counts_property(mt, nt, hi, q, fs, seed):
    """The ratio policy places exactly round(frac·n) tiles of each role
    for any grid, ratio pair and format set, in the reference's places."""
    fset, jset = _sets(fs)
    lo8 = min(q, 1.0 - hi) if fset.low8 is not None else 0.0
    n = mt * nt
    if round(hi * n) + round(lo8 * n) > n:
        return   # over-unity after rounding: the ValueError path
    pol = P.Policy(kind="ratio", ratio_high=hi, ratio_low8=lo8, seed=seed)
    t = 8
    m = P.make_map((mt * t, nt * t), t, pol, fset=fset)
    assert m.shape == (mt, nt)
    assert (m == fset.high).sum() == round(hi * n)
    if fset.low8 is not None:
        assert (m == fset.low8).sum() == round(lo8 * n)
    assert set(np.unique(m)) <= set(fset.codes)
    np.testing.assert_array_equal(
        m, JP.make_map((mt * t, nt * t), t, _jpolicy(pol), fset=jset))


@settings(max_examples=40, deadline=None)
@given(n_hi=st.integers(0, 9), n_lo=st.integers(0, 9),
       n_lo8=st.integers(0, 9), fs=st.sampled_from(sorted(FSETS)))
def test_role_class_vector_and_ratio_string_property(n_hi, n_lo, n_lo8, fs):
    """role_class_vector emits exactly the requested counts (the
    reference's vector) and the ratio string always sums to 100."""
    fset, jset = _sets(fs)
    if n_lo8 and fset.low8 is None:
        with pytest.raises(ValueError, match="no low8 role"):
            P.role_class_vector(n_hi, n_lo, n_lo8, fset)
        return
    vec = P.role_class_vector(n_hi, n_lo, n_lo8, fset)
    np.testing.assert_array_equal(
        vec, JP.role_class_vector(n_hi, n_lo, n_lo8, jset))
    assert len(vec) == n_hi + n_lo + n_lo8
    assert (vec == fset.high).sum() == n_hi
    if n_hi + n_lo + n_lo8 == 0:
        return
    s = P.map_ratio_string(vec.reshape(1, -1), fset)
    assert sum(int(seg[:-1]) for seg in s.split(":")) == 100, s


@settings(max_examples=40, deadline=None)
@given(mt=st.integers(1, 8), nt=st.integers(1, 8), hi=st.floats(0.0, 1.0),
       fs=st.sampled_from(sorted(FSETS)), tile=st.sampled_from([4, 8, 16]))
def test_storage_bytes_round_trip_property(mt, nt, hi, fs, tile):
    """map_storage_bytes equals the per-class counts × registered bytes,
    the reference's count, and the MPMatrix layout's accounting."""
    fset, jset = _sets(fs)
    pol = P.Policy(kind="ratio", ratio_high=hi, seed=7)
    m = P.make_map((mt * tile, nt * tile), tile, pol, fset=fset)
    want = sum(int((m == c).sum()) * fset.bytes_of(c) * tile * tile
               for c in fset.codes)
    assert P.map_storage_bytes(m, tile, fset) == want
    assert JP.map_storage_bytes(m, tile, jset) == want
    mat = PL.MPMatrix.from_dense(torch.ones((mt * tile, nt * tile)), m,
                                 tile, fset)
    assert mat.storage_bytes() == want


def test_quantize_tile_roundtrip():
    """HIGH is exact, LOW within bf16 rounding; both bit for bit the
    reference's."""
    import jax.numpy as jnp
    x = np.random.default_rng(1).normal(size=(8, 8)).astype(np.float32)
    fs = PF.DEFAULT_FORMATS
    hi = P.quantize_tile(torch.from_numpy(x), fs.high)
    np.testing.assert_array_equal(hi.numpy(), x)
    lo = P.quantize_tile(torch.from_numpy(x), fs.low)
    assert np.abs(lo.numpy() - x).max() < 0.01
    for c, got in ((fs.high, hi), (fs.low, lo)):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JP.quantize_tile(jnp.asarray(x), c)))
