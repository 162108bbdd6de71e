"""Port parity: the compact class-sorted layout (``CompactMPMatrix``), the
grouped kernel's plain version and the ``grouped`` dispatch path, against
the JAX package on the same numpy-seeded inputs.

Tolerances.  Compact tiles, slots and ``to_dense`` are storage rounding
and copies: bit for bit (NaN where the reference has NaN).  Grouped GEMM
outputs differ from the Pallas kernel's only by the order of fp32 sums of
exact products — at most
``2·K·2^-24·|A|·|B|`` per element, plus one rounding of a float C tile's
storage format or one quantization step of an integer C tile
(``kernels.mp_gemm_tile.order_allowance``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import layout as JL
from repro.core import precision as JP
from repro.kernels import grouped_gemm as JG
from repro.obs import metrics as JOM
from repro.tune import dispatch as JTD
from repro.tune import search as JTS
from repro_torch import obs
from repro_torch.core import formats as PF
from repro_torch.core import layout as PL
from repro_torch.core.accuracy import check_against_fp64
from repro_torch.kernels import grouped_gemm as PG
from repro_torch.kernels import mp_gemm_tile as PMT
from repro_torch.kernels import ops
from repro_torch.obs import metrics as M
from repro_torch.tune import costmodel as CM
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as D
from repro_torch.tune import search as S

SETS = ("fp8_e4m3+bf16+fp32", "fp8_e5m2+fp16+fp32", "int8_pt+bf16+fp32",
        "int4_pt+bf16+fp32", "fp16+split2_fp16")


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    # both packages' plan caches, registries and metrics stay per test
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jplans.json"))
    monkeypatch.setattr(JTD, "_REGISTRY", {})
    monkeypatch.setattr(JTS, "_default_cache", None)
    monkeypatch.setattr(JOM, "_DEFAULT", JOM.MetricsRegistry())
    monkeypatch.setenv(S.CACHE_ENV, str(tmp_path / "plans.json"))
    monkeypatch.delenv(DV.DEVICE_ENV, raising=False)
    monkeypatch.setattr(D, "_REGISTRY", {})
    monkeypatch.setattr(S, "_default_cache", None)
    monkeypatch.setattr(M, "_DEFAULT", M.MetricsRegistry())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return _bits(t.view(ints[t.element_size()]).numpy())


def assert_same_bits(j, p: torch.Tensor) -> None:
    """Bit-equal where the reference holds a number, NaN where it holds
    NaN (the frameworks' NaN payloads differ)."""
    nan = np.isnan(np.asarray(j).astype(np.float32))
    np.testing.assert_array_equal(np.isnan(p.float().numpy()), nan)
    np.testing.assert_array_equal(_bits(j)[~nan], _torch_bits(p)[~nan])


def _map(shape, t, key, ratios, seed):
    return JP.make_map(shape, t, JP.Policy("ratio", *ratios, seed=seed),
                       fset=JF.FormatSet.from_key(key))


def _compact(x, cls_map, t, key):
    jc = JL.CompactMPMatrix.from_dense(jnp.asarray(x), cls_map, t,
                                       JF.FormatSet.from_key(key))
    pc = PL.CompactMPMatrix.from_dense(torch.from_numpy(x), cls_map, t,
                                       PF.FormatSet.from_key(key))
    return jc, pc


@pytest.mark.parametrize("key", SETS)
@pytest.mark.parametrize("shape", [(48, 64), (40, 56)])   # second: padded
def test_compact_layout_bit_exact(key, shape):
    t = 16
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 50).astype(np.float32)
    x.reshape(-1)[0] = 1e4          # an e4m3 overflow (NaN), as stored
    ratios = (0.4, 0.3) if key.count("+") == 2 else (0.5, 0.0)
    cls_map = _map(shape, t, key, ratios, seed=1)
    jc, pc = _compact(x, cls_map, t, key)
    np.testing.assert_array_equal(pc.slot, jc.slot.arr)
    np.testing.assert_array_equal(
        PL.CompactMPMatrix.make_slots(cls_map),
        JL.CompactMPMatrix.make_slots(cls_map))
    for jt, pt in zip(jc.tiles, pc.tiles):
        assert PF.dtype_name(pt.dtype) == jnp.dtype(jt.dtype).name
        assert_same_bits(jt, pt)
    assert_same_bits(jc.to_dense(), pc.to_dense())
    assert pc.storage_bytes() == jc.storage_bytes()
    assert_same_bits(jc.to_mpmatrix().to_dense(),
                     pc.to_mpmatrix().to_dense())


@pytest.mark.parametrize("key", SETS[:4])
@pytest.mark.parametrize("ratios", [(0.5, 0.3), (1.0, 0.0), (0.0, 0.0)])
def test_grouped_plain_matches_pallas(key, ratios):
    t, (m, k, n) = 16, (48, 64, 32)
    rng = np.random.default_rng(2)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    pa = _map((m, k), t, key, (0.4, 0.3), seed=3)
    pb = _map((k, n), t, key, (0.5, 0.2), seed=4)
    pc_ = _map((m, n), t, key, ratios, seed=5)
    ja, pa_ = _compact(a, pa, t, key)
    jb, pb_ = _compact(b, pb, t, key)
    jo = JG.grouped_mp_gemm(ja, jb, pc_, interpret=True)
    po = PG.grouped_gemm_plain(pa_, pb_, pc_)
    for jt, pt in zip(jo.tiles, po):
        assert tuple(pt.shape) == tuple(jt.shape)
        assert PF.dtype_name(pt.dtype) == jnp.dtype(jt.dtype).name
    out = PL.CompactMPMatrix(po, pc_, PL.CompactMPMatrix.make_slots(pc_), t,
                             (m, n), pa_.fset)
    got = out.to_dense()
    want = torch.from_numpy(np.array(jo.to_dense(), np.float32))
    am = pa_.to_mpmatrix()
    bm = pb_.to_mpmatrix()
    zero = tuple(torch.zeros((m, n), dtype=x.dtype) for x in am.bufs)
    allow = PMT.order_allowance(am.bufs, bm.bufs, zero, pc_, want, tile=t,
                                specs=PMT.format_specs(am.fset))
    assert PMT.within(got, want, allow)[1] <= 1.0


def test_grouped_rejects_unknown_c_codes_like_the_reference():
    t = 16
    x = np.ones((32, 32), np.float32)
    cls_map = np.full((2, 2), 1, np.int8)
    ja, pa = _compact(x, cls_map, t, SETS[0])
    bad = np.full((2, 2), 5, np.int8)
    with pytest.raises(ValueError, match="class codes"):
        JG.grouped_mp_gemm(ja, ja, bad, interpret=True)
    with pytest.raises(ValueError, match="class codes"):
        PG.grouped_mp_gemm(pa, pa, bad)
    _, other = _compact(x, np.full((2, 2), 1, np.int8), t, SETS[1])
    with pytest.raises(ValueError, match="format sets differ"):
        PG.grouped_mp_gemm(pa, other, cls_map)


def test_grouped_wrapper_on_cpu_is_the_plain_version():
    t = 16
    rng = np.random.default_rng(6)
    a = rng.standard_normal((32, 48)).astype(np.float32)
    b = rng.standard_normal((48, 32)).astype(np.float32)
    _, pa = _compact(a, _map((32, 48), t, SETS[0], (0.4, 0.3), 7), t,
                     SETS[0])
    _, pb = _compact(b, _map((48, 32), t, SETS[0], (0.4, 0.3), 8), t,
                     SETS[0])
    pc_ = _map((32, 32), t, SETS[0], (0.5, 0.25), 9)
    before = PG.launches
    out = ops.grouped_mp_gemm(pa, pb, pc_)
    plain = PG.grouped_gemm_plain(pa, pb, pc_)
    assert PG.launches == before
    assert all(torch.equal(x, y) for x, y in zip(out.tiles, plain))
    np.testing.assert_array_equal(out.slot,
                                  PL.CompactMPMatrix.make_slots(pc_))


def test_work_list_follows_make_slots():
    """The kernel's work list visits each class's tiles in slot order."""
    cls_map = _map((64, 80), 16, SETS[0], (0.4, 0.3), 10)
    work = PG.work_list(cls_map, 3)
    slots = PL.CompactMPMatrix.make_slots(cls_map)
    assert len(work) == cls_map.size
    for i, j, code, slot in work:
        assert cls_map[i, j] == code and slots[i, j] == slot


def test_mp_matmul_grouped_path_and_rules(monkeypatch):
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    t = 16
    fs = PF.FormatSet.from_key(SETS[0])
    rng = np.random.default_rng(11)
    dense = [rng.standard_normal((48, 48)).astype(np.float32)
             for _ in range(2)]
    maps = [_map((48, 48), t, SETS[0], (0.4, 0.3), s) for s in (12, 13, 14)]
    A, B = (PL.MPMatrix.from_dense(torch.from_numpy(d), p, t, fs)
            for d, p in zip(dense, maps))
    C = PL.MPMatrix.from_dense(torch.zeros(48, 48), maps[2], t, fs)
    plan = CM.GemmPlan("grouped", t, t, t)
    out = D.mp_matmul(A, B, C, plan=plan)
    assert obs.metrics_registry().value(
        "dispatch.calls", path="grouped", op="mp_gemm",
        formats=fs.key()) == 1
    rep = check_against_fp64(out.to_dense().numpy(), *dense, None, *maps, t,
                             fs)
    assert rep["ok"], rep
    with pytest.raises(ValueError, match="alpha=1, beta=0"):
        D.mp_matmul(A, B, C, beta=0.5, plan=plan)
    # the cost model keeps mp_matmul on the tile kernel
    chosen, _ = D.resolve_plan(D.problem_of(A, B, C),
                               DV.DEVICE_TABLE["gpu-h100"])
    assert chosen.path == "tile"


def test_grouped_solve_matches_reference(monkeypatch, tmp_path):
    """``residual_path="grouped"`` at n = 128, tile 16: equal decisions,
    the metric to 5e-3 absolute, the solution to 1e-3 relative (see
    ``test_torch_split``'s split solve for the reasons)."""
    from repro.solve import SolveConfig as JCfg, solve as jsolve
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    a = graded_spd(128, cond=1e4, rho=0.9, seed=0)
    _, b = rhs_for_solution(a, seed=1)
    kw = dict(tile=16, ratio_high=0.0, max_sweeps=30,
              residual_path="grouped")
    jr = jsolve(a, b, JCfg(**kw))
    before = PG.launches
    d0 = D.dispatch_counts().get("grouped", 0)
    pr = solve(a, b, SolveConfig(**kw), device="cpu")
    assert D.dispatch_counts()["grouped"] - d0 == pr.sweeps
    assert PG.launches == before           # CPU tensors: the plain version
    assert (pr.converged, pr.sweeps, pr.escalations, pr.compute_mode) == (
        jr.converged, jr.sweeps, jr.escalations, jr.compute_mode)
    assert pr.converged
    np.testing.assert_array_equal(pr.final_map, jr.final_map)
    assert abs(pr.metric - jr.metric) <= 5e-3
    assert np.abs(pr.x - jr.x).max() <= 1e-3 * np.abs(jr.x).max()
    assert pr.fresh_resolutions == 0


#: the card checks' format sets and (ratio_high, ratio_low8, edge case)
#: rows: the five mixes, then e4m3-overflow NaN, inf·0 and subnormal
#: operands on a mix with every class
CARD_SETS = SETS[:4] + ("fp8_e4m3+fp16+fp32",)
CARD_CASES = ((0.0, 0.0, None), (0.5, 0.0, None), (1.0, 0.0, None),
              (0.4, 0.2, None), (0.4, 0.3, None),
              (0.3, 0.3, "e4m3-overflow"), (0.3, 0.3, "inf*0"),
              (0.3, 0.3, "subnormal"))


def _card_operands(m, k, n, edge, seed=15):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    if edge == "e4m3-overflow":
        a[::7, ::5] = 1e3
    elif edge == "inf*0":
        a[1, :] = np.inf
        a[5, 3] = -np.inf
        b[3, :] = 0.0
        b[:, 2] = 0.0
    elif edge == "subnormal":
        a *= np.float32(1e-39)
    return a, b


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("key", CARD_SETS)
@pytest.mark.parametrize("t", PG.TILE_SIZES)
def test_grouped_kernel_matches_plain_on_card(t, key, case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel)")
    hi, q, edge = case
    m, k, n = 2 * t, 3 * t, 2 * t
    a, b = _card_operands(m, k, n, edge)
    pa = _map((m, k), t, key, (hi, q), 16)
    pb = _map((k, n), t, key, (hi, q), 17)
    pc_ = _map((m, n), t, key, (hi, q), 18)
    _, ca = _compact(a, pa, t, key)
    _, cb = _compact(b, pb, t, key)
    cuda = [PL.CompactMPMatrix(tuple(x.cuda() for x in c.tiles), c.cls,
                               c.slot, t, c.shape, c.fset)
            for c in (ca, cb)]
    before = PG.launches
    out = PG.grouped_mp_gemm(*cuda, pc_)
    assert PG.launches == before + 1
    plain = PG.grouped_gemm_plain(ca, cb, pc_)
    want = PL.CompactMPMatrix(plain, pc_, out.slot, t, out.shape,
                              ca.fset).to_dense()
    got = out.to_dense().cpu()
    am, bm = ca.to_mpmatrix(), cb.to_mpmatrix()
    zero = tuple(torch.zeros((m, n), dtype=x.dtype) for x in am.bufs)
    allow = PMT.order_allowance(am.bufs, bm.bufs, zero, pc_, want,
                                tile=t, specs=PMT.format_specs(am.fset))
    # NaN as NaN: equal where both have it, infinite error where one does
    assert PMT.within(got, want, allow)[1] <= 1.0


def test_grouped_launch_plan_is_the_tile_kernels():
    """The grouped kernel runs the tile kernel's staged dot: the same
    launch plan, and its own per-path counters."""
    fs = PF.FormatSet.from_key(SETS[0])
    for t in PG.TILE_SIZES:
        plan = PMT.launch_plan(t, PMT.format_specs(fs))
        assert plan["paths"] == ((("tensor_core", "tensor_core", "fp32"))
                                 if t >= 64 else ("simple",) * 3)
    assert set(PG.path_launches) == set(PMT.PATHS)
