"""Port parity: split accumulation (``repro_torch.split``, the split
formats, the split kernel's plain version and the ``split`` dispatch
path) against the JAX package on the same numpy-seeded inputs.

Tolerances.  Slicing, recombination, storage and spec rows are
elementwise or exact, so they are held bit for bit — where a value is
NaN, both sides must be NaN (the two frameworks encode an e5m2 NaN as
0x7E and 0x7F).  GEMM outputs differ
only by the order of fp32 sums: two orders of the ``K·s²`` exact slice
products differ by at most ``2·K·s²·2^-24·Σ|products|`` per element, and
each side's split round trip adds its recovered roundoff
(``kernels.split_gemm.order_allowance``).  The solve is held decision
for decision (threshold tests on fp64 data), its metric and solution to
the tolerances stated at the test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import layout as JL
from repro.core import precision as JP
from repro.kernels import split_gemm as JS
from repro.obs import metrics as JOM
from repro.split import recovery as JR
from repro.tune import costmodel as JCM
from repro.tune import device as JDV
from repro.tune import dispatch as JTD
from repro.tune import search as JTS
from repro_torch import obs
from repro_torch.core import formats as PF
from repro_torch.core import layout as PL
from repro_torch.core.accuracy import check_against_fp64
from repro_torch.kernels import ops
from repro_torch.kernels import split_gemm as PS
from repro_torch.obs import metrics as M
from repro_torch.split import recovery as PR
from repro_torch.tune import costmodel as CM
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as D
from repro_torch.tune import search as S

T = 16
MIXES = (("fp16+split2_fp16", (0.5, 0.0)), ("fp16+split3_e5m2", (0.5, 0.0)),
         ("int8_pt+bf16+split2_fp16", (0.4, 0.3)),
         ("fp8_e4m3+bf16+split3_e5m2", (0.4, 0.2)))


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


def _wide(shape, seed=0):
    """Normal values over 10^-9..10^5 plus zeros, ±inf and NaN: covers
    fp16/e5m2 subnormal second slices and overflow."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-9, 5, shape)
    x = x.astype(np.float32)
    flat = x.reshape(-1)
    flat[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 65520.0]
    return x


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return _bits(t.view(ints[t.element_size()]).numpy())


def assert_same_bits(j, p: torch.Tensor) -> None:
    """Bit-equal where the reference holds a number, NaN where it holds
    NaN."""
    jf = np.asarray(j).astype(np.float32)
    nan = np.isnan(jf)
    np.testing.assert_array_equal(np.isnan(p.float().numpy()), nan)
    np.testing.assert_array_equal(_bits(j)[~nan], _torch_bits(p)[~nan])


@pytest.mark.parametrize("name,slices,jdt,pdt", [
    ("split2", 2, jnp.float16, torch.float16),
    ("split3", 3, jnp.float8_e5m2, torch.float8_e5m2),
    ("fp16x3", 3, jnp.float16, torch.float16),
    ("e5m2x2", 2, jnp.float8_e5m2, torch.float8_e5m2)])
def test_split_slices_and_recombine_bit_exact(name, slices, jdt, pdt):
    x = _wide((64, 48))
    js = JF.split_slices(jnp.asarray(x), slices, jdt)
    ps = PF.split_slices(torch.from_numpy(x), slices, pdt)
    assert len(js) == len(ps) == slices
    for j, p in zip(js, ps):
        assert_same_bits(j, p)
    assert_same_bits(JR.recombine(js), PR.recombine(ps))


@pytest.mark.parametrize("name", ["split2_fp16", "split3_e5m2"])
def test_split_formats_registered_like_the_reference(name):
    jf, pf = JF.get_format(name), PF.get_format(name)
    assert isinstance(pf, PF.SplitFormat)
    assert pf.signature() == jf.signature()
    assert pf.recovered_roundoff() == jf.recovered_roundoff()
    assert pf.storage_roundoff() == jf.storage_roundoff()
    assert pf.operational_roundoff() == jf.operational_roundoff()
    x = _wide((32, 32), seed=1)
    assert_same_bits(jf.to_buffer(jnp.asarray(x)),
                     pf.to_buffer(torch.from_numpy(x)))


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_slice_pair_order_matches(s):
    assert PR.slice_pair_order(s) == JR.slice_pair_order(s)


@pytest.mark.parametrize("key", [m[0] for m in MIXES]
                         + ["fp8_e4m3+bf16+fp32"])
def test_split_format_specs_rows_and_variant(key):
    jrows = JR.split_format_specs(JF.FormatSet.from_key(key))
    prows = PR.split_format_specs(PF.FormatSet.from_key(key))
    assert len(jrows) == len(prows)
    for j, p in zip(jrows, prows):
        assert (PF.dtype_name(p[0]), p[1], PF.dtype_name(p[2]), p[3],
                PF.dtype_name(p[4]), p[5]) == tuple(
            jnp.dtype(v).name if i in (0, 2, 4) else getattr(v, "name", v)
            for i, v in enumerate(j))
    base = "fp8_e4m3+bf16+fp32"
    for name in ("split2_fp16", "split3_e5m2"):
        assert PR.split_variant(PF.FormatSet.from_key(base), name).names \
            == JR.split_variant(JF.FormatSet.from_key(base), name).names
    assert PR.has_split(PF.FormatSet.from_key(key)) == JR.has_split(
        JF.FormatSet.from_key(key))
    with pytest.raises(ValueError, match="not a split"):
        PR.split_variant(PF.FormatSet.from_key(base), "fp16")


def _case(key, ratios, shape=(32, 48, 32), seed=0):
    rng = np.random.default_rng(seed)
    m, k, n = shape
    jfs, pfs = JF.FormatSet.from_key(key), PF.FormatSet.from_key(key)
    dense = [rng.standard_normal(s).astype(np.float32)
             for s in ((m, k), (k, n), (m, n))]
    maps = [JP.make_map(d.shape, T, JP.Policy("ratio", *ratios,
                                               seed=seed + i), fset=jfs)
            for i, d in enumerate(dense)]
    jm = [JL.MPMatrix.from_dense(jnp.asarray(d), p, T, jfs)
          for d, p in zip(dense, maps)]
    pm = [PL.MPMatrix.from_dense(torch.from_numpy(d), p, T, pfs)
          for d, p in zip(dense, maps)]
    return jm, pm, maps, dense


@pytest.mark.parametrize("key,ratios", MIXES)
def test_split_plain_matches_pallas(key, ratios):
    jm, pm, maps, dense = _case(key, ratios)
    for j, p in zip(jm, pm):                # the operands are bit-equal
        for jb, pb in zip(j.bufs, p.bufs):
            assert_same_bits(jb, pb)
    alpha, beta = 1.5, 0.5
    jo = JS.split_gemm_tile_multi(
        jm[0].bufs, jm[1].bufs, jm[2].bufs, *(jnp.asarray(p) for p in maps),
        tile=T, specs=JR.split_format_specs(jm[0].fset), alpha=alpha,
        beta=beta, interpret=True)
    specs = PR.split_format_specs(pm[0].fset)
    po = PS.split_gemm_plain(pm[0].bufs, pm[1].bufs, pm[2].bufs, *maps,
                             tile=T, specs=specs, alpha=alpha, beta=beta)
    sel = PL.expand_map(maps[2], T)
    for code, (j, p) in enumerate(zip(jo, po)):
        assert PF.dtype_name(p.dtype) == jnp.dtype(j.dtype).name
        assert not p.float()[torch.from_numpy(sel != code)].any()
    jd = torch.from_numpy(sum(np.asarray(o).astype(np.float32) for o in jo))
    pd = sum(o.float() for o in po)
    allow = PS.order_allowance(pm[0].bufs, pm[1].bufs, pm[2].bufs, maps[2],
                               jd, tile=T, specs=specs, alpha=alpha,
                               beta=beta)
    assert PS.within(pd, jd, allow)[1] <= 1.0
    # ... and inside the registry's fp64 bound
    rep = check_against_fp64(pd.numpy(), *dense, *maps, T, pm[0].fset,
                             alpha=alpha, beta=beta)
    assert rep["ok"], rep


#: slice dtype of a split format, torch -> jax
_JSLICE = {torch.float16: jnp.float16, torch.float8_e5m2: jnp.float8_e5m2}


@pytest.mark.parametrize("operand", [0, 1])
@pytest.mark.parametrize("key,ratios", MIXES)
def test_slice_pass_plain_is_split_slices_of_each_tiles_class(key, ratios,
                                                              operand):
    """The slice pass's plain version (what the kernel's pass writes at
    t = 64 and 128) holds the reference's ``split_slices`` of the operand
    upcast from the buffer each tile's class names, bit for bit (NaN as
    NaN), each slice stored exactly in the split class's compute dtype;
    values span 1e-7..1e4, so second and third slices reach the slice
    dtypes' subnormals."""
    rng = np.random.default_rng(11)
    jfs, pfs = JF.FormatSet.from_key(key), PF.FormatSet.from_key(key)
    shape = ((32, 48), (48, 32))[operand]
    dense = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-7, 4, shape)
             ).astype(np.float32)
    cls = JP.make_map(shape, T, JP.Policy("ratio", *ratios, seed=5),
                      fset=jfs)
    jm = JL.MPMatrix.from_dense(jnp.asarray(dense), cls, T, jfs)
    pm = PL.MPMatrix.from_dense(torch.from_numpy(dense), cls, T, pfs)
    for jb, pb in zip(jm.bufs, pm.bufs):
        assert_same_bits(jb, pb)
    spec = PR.split_format_specs(pfs)[pfs.high]
    store = PS.slice_store_dtype(spec)
    assert store == spec[0]
    sel = PL.expand_map(cls, T)
    x = np.zeros(shape, np.float32)
    for code, b in enumerate(jm.bufs):
        x = np.where(sel == code, np.asarray(b).astype(np.float32), x)
    want = JF.split_slices(jnp.asarray(x), spec[3], _JSLICE[spec[4]])
    got = PS.slice_operand_plain(pm.bufs, cls, T, spec[3], spec[4], store)
    assert got.dtype == store and tuple(got.shape) == (spec[3], *shape)
    for w, g in zip(want, got):
        assert_same_bits(w, g.to(spec[4]))           # the slice itself
        wf = np.asarray(w).astype(np.float32)
        ok = ~np.isnan(wf)
        np.testing.assert_array_equal(g.float().numpy()[ok], wf[ok])


def test_slice_store_dtype_needs_exact_slices():
    """fp16 slices are stored in fp16, e5m2 slices in bf16 or fp16; fp16
    slices in bf16 would round, so that spec is refused."""
    f16, bf16, e5m2 = torch.float16, torch.bfloat16, torch.float8_e5m2
    assert PS.slice_store_dtype((f16, None, None, 2, f16, None)) == f16
    assert PS.slice_store_dtype((bf16, None, None, 3, e5m2, None)) == bf16
    assert PS.slice_store_dtype((f16, None, None, 3, e5m2, None)) == f16
    with pytest.raises(TypeError):
        PS.slice_store_dtype((bf16, None, None, 2, f16, None))


@pytest.mark.parametrize("tile", [32, 64])
def test_slice_pass_alone_has_no_cpu_path(tile):
    """``slice_operands`` launches the kernel's slice pass or raises: on
    CPU tensors (no kernel) and at t < 64 (no pass) it refuses."""
    pfs = PF.FormatSet.from_key("fp8_e4m3+bf16+split2_fp16")
    cls = np.full((2, 2), pfs.high, np.int8)
    mats = [PL.MPMatrix.from_dense(torch.ones((2 * tile, 2 * tile)), cls,
                                   tile, pfs) for _ in range(3)]
    specs = PR.split_format_specs(pfs)
    with pytest.raises(ValueError, match="slice pass|device"):
        PS.slice_operands(*(m.bufs for m in mats), cls, cls, cls,
                          tile=tile, specs=specs, code=pfs.high)


@pytest.mark.parametrize("key,ratios", MIXES[:3])
def test_split_gemm_ref_agrees_with_plain(key, ratios):
    _, pm, maps, _ = _case(key, ratios, shape=(32, 32, 32), seed=3)
    specs = PR.split_format_specs(pm[0].fset)
    ref = PR.split_gemm_ref(*pm, alpha=2.0, beta=-1.0).padded_dense()
    po = PS.split_gemm_plain(pm[0].bufs, pm[1].bufs, pm[2].bufs, *maps,
                             tile=T, specs=specs, alpha=2.0, beta=-1.0)
    pd = sum(o.float() for o in po)
    allow = PS.order_allowance(pm[0].bufs, pm[1].bufs, pm[2].bufs, maps[2],
                               pd, tile=T, specs=specs, alpha=2.0,
                               beta=-1.0)
    assert PS.within(ref, pd, allow)[1] <= 1.0


@pytest.mark.parametrize("key,ratios", MIXES)
def test_split_gemm_ref_within_order_allowance_of_jax_ref(key, ratios):
    """The port's ``split_gemm_ref`` sums in the t = 16/32 kernel's order
    (FMA chains per slice pair and k tile), the reference's in XLA's dot
    order: the two sit within the split order allowance, and every
    buffer is zero off its class's tiles, as in the reference."""
    jm, pm, maps, _ = _case(key, ratios)
    specs = PR.split_format_specs(pm[0].fset)
    jo = JR.split_gemm_ref(*jm, alpha=1.5, beta=0.5)
    po = PR.split_gemm_ref(*pm, alpha=1.5, beta=0.5)
    sel = PL.expand_map(maps[2], T)
    for code, (j, p) in enumerate(zip(jo.bufs, po.bufs)):
        assert PF.dtype_name(p.dtype) == jnp.dtype(j.dtype).name
        assert not p.float()[torch.from_numpy(sel != code)].any()
    jd = torch.from_numpy(sum(np.asarray(o).astype(np.float32)
                              for o in jo.bufs))
    allow = PS.order_allowance(pm[0].bufs, pm[1].bufs, pm[2].bufs, maps[2],
                               jd, tile=T, specs=specs, alpha=1.5,
                               beta=0.5)
    assert PS.within(po.padded_dense(), jd, allow)[1] <= 1.0


def test_fma32_rounds_once():
    """``fma32`` is one rounding of the exact ``a·b + c``: here the fp64
    sum lands on an fp32 midpoint the exact value lies below, so rounding
    fp64 to nearest first would tie to the wrong neighbour; and it agrees
    with exact rational arithmetic on random operands."""
    from fractions import Fraction
    a = torch.tensor([1 + 2.0 ** -20])
    b = torch.tensor([3 * 2.0 ** -24 * (1 - 2.0 ** -20)])
    c = torch.tensor([1.0])
    assert PR.fma32(a, b, c).item() == 1 + 2.0 ** -23
    assert (a.double() * b.double() + c.double()).float().item() \
        == 1 + 2.0 ** -22
    rng = np.random.default_rng(2)
    x, y, z = (rng.standard_normal(300).astype(np.float32) for _ in "xyz")
    got = PR.fma32(*(torch.from_numpy(v) for v in (x, y, z))).numpy()
    for i in range(300):
        exact = Fraction(float(x[i])) * Fraction(float(y[i])) \
            + Fraction(float(z[i]))
        err = abs(Fraction(float(got[i])) - exact)
        for nb in (np.nextafter(got[i], np.float32(-np.inf)),
                   np.nextafter(got[i], np.float32(np.inf))):
            assert err <= abs(Fraction(float(nb)) - exact)


@pytest.mark.parametrize("name", ["split2_fp16", "split3_e5m2"])
def test_split_identity_product_is_the_slice_sum(name):
    """With B = I and C = 0 every dot is exact, so a split C tile holds the
    fp32 sum of A's slices bit for bit — what chip_smoke checks on the
    card."""
    fs = PF.format_set("fp16", name)
    x = _wide((64, 64), seed=5)
    x[~np.isfinite(x)] = 1.0
    x = np.clip(x, -6e4, 6e4)
    hi = np.full((4, 4), fs.high, np.int8)
    A = PL.MPMatrix.from_dense(torch.from_numpy(x), hi, T, fs)
    B = PL.MPMatrix.from_dense(torch.eye(64), hi, T, fs)
    C = PL.MPMatrix.from_dense(torch.zeros(64, 64), hi, T, fs)
    po = PS.split_gemm_plain(A.bufs, B.bufs, C.bufs, hi, hi, hi, tile=T,
                             specs=PR.split_format_specs(fs))
    f = fs.fmt(fs.high)
    want = PR.recombine(PF.split_slices(A.bufs[fs.high], f.slices,
                                        f.slice_dtype))
    assert torch.equal(po[fs.high], want)


def test_split_dot_general_matches_reference():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((32, 64)).astype(np.float32)
    b = rng.standard_normal((64, 16)).astype(np.float32)
    for name in ("split2_fp16", "split3_e5m2"):
        j = np.asarray(JR.split_dot_general(jnp.asarray(a), jnp.asarray(b),
                                            JF.get_format(name)))
        p = PR.split_dot_general(torch.from_numpy(a), torch.from_numpy(b),
                                 PF.get_format(name)).numpy()
        bound = 2 * 64 * 4 * 2.0 ** -24 * (np.abs(a) @ np.abs(b)) * 2
        assert np.all(np.abs(j - p) <= bound)


def test_split_wrapper_on_cpu_is_the_plain_version_and_checks():
    _, pm, maps, _ = _case(MIXES[0][0], MIXES[0][1])
    specs = PR.split_format_specs(pm[0].fset)
    before = PS.launches
    out = ops.split_mp_gemm(*pm, alpha=1.0, beta=0.5)
    plain = PS.split_gemm_plain(pm[0].bufs, pm[1].bufs, pm[2].bufs, *maps,
                                tile=T, specs=specs, beta=0.5)
    assert all(torch.equal(a, b) for a, b in zip(out.bufs, plain))
    assert PS.launches == before
    with pytest.raises(ValueError):
        PS.split_gemm_tile_multi(pm[0].bufs, pm[1].bufs, pm[2].bufs,
                                 maps[0], maps[1], maps[2][:1], tile=T,
                                 specs=specs)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_mp_matmul_routes_split_classes_and_counts(monkeypatch):
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    key = "fp16+split2_fp16"
    _, pm, maps, dense = _case(key, (0.5, 0.0))
    out = D.mp_matmul(*pm)
    reg = obs.metrics_registry()
    assert reg.value("dispatch.calls", path="split", op="mp_gemm",
                     formats=key) == 1
    rep = check_against_fp64(out.to_dense().numpy(), *dense, *maps, T,
                             pm[0].fset)
    assert rep["ok"], rep
    # the cpu spec has no kernels: the oracle takes split classes
    monkeypatch.setenv(DV.DEVICE_ENV, "cpu")
    ref = D.mp_matmul(*pm)
    assert reg.value("dispatch.calls", path="ref", op="mp_gemm",
                     formats=key) == 1
    rep = check_against_fp64(ref.to_dense().numpy(), *dense, *maps, T,
                             pm[0].fset)
    assert rep["ok"], rep


#: port path -> the reference path with the same applicability rules
_JPATH = {"ref": "ref", "tile": "tile", "split": "split",
          "grouped": "grouped", "ksplit_torch": "ksplit_xla",
          "ksplit_cuda": "ksplit_pallas"}


@pytest.mark.parametrize("key,c_code", [
    (key, c) for key in ("fp16+split2_fp16", "fp8_e4m3+bf16+split3_e5m2",
                         "fp8_e4m3+bf16+fp32")
    for c in range(len(key.split("+")))])
@pytest.mark.parametrize("beta_zero", [True, False])
def test_validity_rules_match_the_reference(key, c_code, beta_zero):
    kw = dict(m=64, n=64, k=64, tile=T, c_classes=(c_code,),
              b_k_constant=True, beta_zero=beta_zero, formats=key)
    jprob, pprob = JCM.GemmProblem(**kw), CM.GemmProblem(**kw)
    jdev = JDV.DEVICE_TABLE["cpu-interpret"]
    pdev = DV.DEVICE_TABLE["gpu-h100"]
    for path, jpath in _JPATH.items():
        jbad = JCM.validate_plan(JCM.GemmPlan(jpath, T, T, T), jprob, jdev)
        pbad = CM.validate_plan(CM.GemmPlan(path, T, T, T), pprob, pdev)
        assert bool(jbad) == bool(pbad), (path, jbad, pbad)


def test_h100_prices_store_below_split_for_the_solver():
    """On the port's kernels a split2 C tile does 4 fp32-pipe dots, so the
    cost model keeps the storage ladder when asked to choose."""
    dev = DV.DEVICE_TABLE["gpu-h100"]
    costs = {}
    for key in ("fp8_e4m3+bf16+fp32", "fp8_e4m3+bf16+split2_fp16"):
        fs = PF.FormatSet.from_key(key)
        prob = D.solve_gemm_problem(np.full((32, 32), fs.high, np.int8),
                                    128, 1, fs)
        ranked = S.rank_plans(S.candidate_plans(prob, dev, D.SOLVE_PATHS),
                              prob, dev)
        costs[key] = (ranked[0][0].path, ranked[0][1]["total_s"])
    assert costs["fp8_e4m3+bf16+fp32"][0] == "tile"
    assert costs["fp8_e4m3+bf16+split2_fp16"][0] == "split"
    assert costs["fp8_e4m3+bf16+fp32"][1] < costs[
        "fp8_e4m3+bf16+split2_fp16"][1]


# ---------------------------------------------------------------------------
# the split solve against the reference's
# ---------------------------------------------------------------------------

def test_split_solve_matches_reference(monkeypatch, tmp_path):
    """``compute_escalation="split"`` at n = 128, tile 16: the decisions
    (convergence, sweeps, escalations, mode, final map) are equal; the
    metric agrees to 5e-3 absolute (both are ≤ tol = 1, and a metric this
    size is rounding noise of the order the GEMMs sum in) and the solution
    to 1e-3 relative: the two solves stop at different iterates of an
    operator whose condition number is up to ~1e4 (grading) × 19 (KMS
    correlation), so two converged iterates differ by about their own
    forward error."""
    from repro.solve import SolveConfig as JCfg, solve as jsolve
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    a = graded_spd(128, cond=1e4, rho=0.9, seed=0)
    _, b = rhs_for_solution(a, seed=1)
    kw = dict(tile=16, ratio_high=0.0, max_sweeps=30,
              compute_escalation="split")
    jr = jsolve(a, b, JCfg(**kw))
    pr = solve(a, b, SolveConfig(**kw), device="cpu")
    assert (pr.converged, pr.sweeps, pr.escalations, pr.compute_mode) == (
        jr.converged, jr.sweeps, jr.escalations, jr.compute_mode)
    assert pr.compute_mode == "split" and pr.converged
    np.testing.assert_array_equal(pr.final_map, jr.final_map)
    assert abs(pr.metric - jr.metric) <= 5e-3
    assert np.abs(pr.x - jr.x).max() <= 1e-3 * np.abs(jr.x).max()
    assert pr.fresh_resolutions == 0


@pytest.mark.gpu
def test_split_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel)")
    for key, ratios in MIXES:
        _, pm, maps, _ = _case(key, ratios, shape=(64, 96, 64))
        specs = PR.split_format_specs(pm[0].fset)
        before = PS.launches
        outs = PS.split_gemm_tile_multi(
            *[tuple(b.cuda() for b in x.bufs) for x in pm], *maps, tile=T,
            specs=specs, alpha=1.5, beta=0.5)
        assert PS.launches == before + 1
        plain = PS.split_gemm_plain(pm[0].bufs, pm[1].bufs, pm[2].bufs,
                                    *maps, tile=T, specs=specs, alpha=1.5,
                                    beta=0.5)
        kd = sum(o.float().cpu() for o in outs)
        pd = sum(o.float() for o in plain)
        allow = PS.order_allowance(pm[0].bufs, pm[1].bufs, pm[2].bufs,
                                   maps[2], pd, tile=T, specs=specs,
                                   alpha=1.5, beta=0.5)
        assert PS.within(kd, pd, allow)[1] <= 1.0
