"""Port parity: the reference GEMM (Algorithm 1) and the fp64 accuracy
oracle of ``repro_torch`` against the JAX package.

``mp_gemm_ref`` outputs must sit inside the registry-derived error bounds
against numpy fp64 (the port's own copy of ``check_against_fp64``) and
agree with the JAX reference to summation-order tolerance: both multiply
the same operands rounded to the same compute dtype, so products are exact
in fp32 and only the order of fp32 sums differs — at most
``2·K·2^-24·(|α|·|A|·|B| + |β|·|C|)`` per element, plus one rounding of the
output tile's storage format (one quantization step for integer tiles);
``mp_gemm_tile.order_allowance`` computes it.
Only ``ratio + ratio8 ≤ 1`` pairs are drawn.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accuracy as JA
from repro.core import formats as JF
from repro.core import layout as JL
from repro.core import mp_gemm as JG
from repro.core import precision as JP
from repro_torch.core import accuracy as PA
from repro_torch.core import formats as PF
from repro_torch.core import layout as PL
from repro_torch.core import mp_gemm as PG
from repro_torch.kernels import mp_gemm_tile as PMT

CASES = [
    # (format-set key, ratio_high, ratio_low8, alpha, beta)
    ("fp8_e4m3+bf16+fp32", 0.5, 0.0, 1.0, 0.0),
    ("fp8_e4m3+bf16+fp32", 0.4, 0.3, 1.5, 0.5),
    ("fp8_e4m3+bf16+fp32", 1.0, 0.0, 1.0, 0.0),
    ("fp8_e4m3+bf16+fp32", 0.0, 0.0, 2.0, -1.0),
    ("fp8_e5m2+fp16+fp32", 0.3, 0.5, 1.0, 0.25),
    ("int8_pt+bf16+fp32", 0.4, 0.4, 1.0, 0.5),
    ("int4_pt+bf16+fp32", 0.2, 0.3, 1.0, 0.0),
    ("bf16+fp32", 0.5, 0.0, 1.0, 1.0),
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(key, hi, q, t=16, shape=(48, 64, 32), seed=0):
    rng = np.random.default_rng(seed)
    m, k, n = shape
    dense = [rng.standard_normal(s).astype(np.float32)
             for s in ((m, k), (k, n), (m, n))]
    jfs, pfs = JF.FormatSet.from_key(key), PF.FormatSet.from_key(key)
    maps = [JP.make_map(d.shape, t, JP.Policy("ratio", hi, q, seed=seed + i),
                        fset=jfs) for i, d in enumerate(dense)]
    jm = [JL.MPMatrix.from_dense(jnp.asarray(d), p, t, jfs)
          for d, p in zip(dense, maps)]
    pm = [PL.MPMatrix.from_dense(torch.from_numpy(d), p, t, pfs)
          for d, p in zip(dense, maps)]
    return dense, maps, jm, pm, pfs


@pytest.mark.parametrize("key,hi,q,alpha,beta", CASES)
def test_mp_gemm_ref_inside_bounds_and_matches_reference(key, hi, q, alpha,
                                                         beta):
    t = 16
    dense, maps, jm, pm, pfs = _operands(key, hi, q, t)
    out = PG.mp_gemm_ref(*pm, alpha=alpha, beta=beta)
    rep = PA.check_against_fp64(out.to_dense().numpy(), *dense, *maps, t,
                                pfs, alpha=alpha, beta=beta)
    assert rep["ok"], rep["worst_ratio"]
    jout = JG.mp_gemm_ref(*jm, alpha=alpha, beta=beta)
    jd = torch.from_numpy(np.array(jout.to_dense(), np.float32))
    pd = out.to_dense()
    allow = PMT.order_allowance(*(x.bufs for x in pm), maps[2], jd,
                                tile=t, specs=PMT.format_specs(pfs),
                                alpha=alpha, beta=beta)
    assert PMT.within(pd, jd, allow)[1] <= 1.0
    for jb, pb in zip(jout.bufs, out.bufs):
        assert PF.dtype_name(pb.dtype) == jnp.dtype(jb.dtype).name


@pytest.mark.parametrize("key,hi,q,alpha,beta", CASES[:2] + CASES[5:6])
def test_tilewise_ref_agrees_with_ref(key, hi, q, alpha, beta):
    """Algorithm 1 verbatim (per-tile loop) against the one-dot-per-class
    oracle, inside the port."""
    t = 16
    dense, maps, _, pm, pfs = _operands(key, hi, q, t, shape=(32, 48, 32))
    a = PG.mp_gemm_ref(*pm, alpha=alpha, beta=beta).to_dense().numpy()
    b = PG.mp_gemm_tilewise_ref(*pm, alpha=alpha, beta=beta).numpy()
    for out in (a, b):
        assert PA.check_against_fp64(out, *dense, *maps, t, pfs,
                                     alpha=alpha, beta=beta)["ok"]


@pytest.mark.parametrize("key,hi,q,alpha,beta", CASES)
def test_class_error_bounds_equal_reference(key, hi, q, alpha, beta):
    _, maps, _, _, pfs = _operands(key, hi, q)
    jb = JA.class_error_bounds(*maps, 64, JF.FormatSet.from_key(key))
    pb = PA.class_error_bounds(*maps, 64, pfs)
    assert jb == pb


def test_oracle_flags_a_wrong_precision():
    """The bound catches mis-dispatch: computing fp32-class tiles at bf16
    breaks it."""
    t = 16
    dense, maps, _, pm, pfs = _operands("fp8_e4m3+bf16+fp32", 1.0, 0.0, t,
                                        shape=(32, 256, 32))
    ad, bd = (x.padded_dense() for x in pm[:2])
    wrong = PL.dot_at(ad, bd, pfs.fmt(pfs.low)).numpy()
    assert not PA.check_against_fp64(wrong, *dense, *maps, t, pfs)["ok"]
