"""Port parity: the refinement solver (``repro_torch.solve``), its numpy
building blocks, the accuracy oracles it decides with, ``MPMatrix.
requantize``, the plan prefetch and the ``repro_torch.launch.solve`` CLI,
against the JAX package on the same numpy-seeded inputs.

Tolerances.  The operators, the blocked LU and the triangular solves (fed
the same trailing products), the oracles and ``requantize`` are numpy or
storage rounding: bit for bit.  The whole solve is held decision for
decision (convergence, sweeps, escalations, mode and final map are
threshold tests on fp64 data); its metric and solution to the tolerances
stated at the test.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accuracy as JACC
from repro.core import layout as JL
from repro.core.formats import FormatSet as JFS
from repro.obs import metrics as JOM
from repro.solve import lu as JLU
from repro.solve import matrices as JM
from repro.solve import refine as JRF
from repro.tune import dispatch as JTD
from repro.tune import search as JTS
from repro_torch.core import accuracy as PACC
from repro_torch.core import layout as PL
from repro_torch.core.formats import DEFAULT_FORMATS, FormatSet
from repro_torch.obs import metrics as M
from repro_torch.solve import lu as PLU
from repro_torch.solve import matrices as PM
from repro_torch.solve import refine as PRF
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as D
from repro_torch.tune import search as S

KEY = DEFAULT_FORMATS.key()


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


# ---------------------------------------------------------------------------
# numpy building blocks
# ---------------------------------------------------------------------------

def test_matrices_bit_exact():
    for n in (48, 128):
        np.testing.assert_array_equal(PM.kms_correlation(n, 0.8),
                                      JM.kms_correlation(n, 0.8))
        np.testing.assert_array_equal(PM.graded_spd(n, 1e4, 0.9, seed=3),
                                      JM.graded_spd(n, 1e4, 0.9, seed=3))
        np.testing.assert_array_equal(PM.diag_dominant(n, 2.5, seed=4),
                                      JM.diag_dominant(n, 2.5, seed=4))
        a = PM.graded_spd(n, seed=5)
        for px, jx in zip(PM.rhs_for_solution(a, nrhs=3, seed=6),
                          JM.rhs_for_solution(a, nrhs=3, seed=6)):
            np.testing.assert_array_equal(px, jx)


def test_blocked_lu_and_substitutions_bit_exact():
    n, t = 96, 16
    a = JM.graded_spd(n, cond=1e3, rho=0.9, seed=1).astype(np.float32)
    pa = np.full((n // t, n // t), DEFAULT_FORMATS.high, np.int8)

    def trailing(l21, u12, step):
        return l21.astype(np.float32) @ u12.astype(np.float32)

    plu, pst = PLU.blocked_lu(a, pa, t, trailing)
    jlu, jst = JLU.blocked_lu(a, pa, t, trailing)
    np.testing.assert_array_equal(plu, jlu)
    assert pst == jst
    b = np.linspace(-1, 1, 2 * n).astype(np.float32).reshape(n, 2)
    py = PLU.solve_unit_lower(plu, b, t)
    np.testing.assert_array_equal(py, JLU.solve_unit_lower(jlu, b, t))
    np.testing.assert_array_equal(PLU.solve_upper(plu, py, t),
                                  JLU.solve_upper(jlu, py, t))
    with pytest.raises(ZeroDivisionError, match="pivot"):
        PLU.unblocked_lu(np.zeros((4, 4), np.float32))


def _stored(a, pa, t, fs_key=KEY):
    """The storage-rounded operator of both packages (bit-equal)."""
    jd = np.asarray(JL.MPMatrix.from_dense(jnp.asarray(a, jnp.float32), pa,
                                           t, JFS.from_key(fs_key))
                    .to_dense())
    pd = PL.MPMatrix.from_dense(torch.from_numpy(a.astype(np.float32)), pa,
                                t, FormatSet.from_key(fs_key)).to_dense()
    np.testing.assert_array_equal(np.isnan(jd), np.isnan(pd.numpy()))
    return jd


@pytest.mark.parametrize("loud", [300.0, 1e4])   # 1e4 overflows fp8 e4m3
def test_solver_oracles_bit_exact(loud):
    n, t = 64, 16
    fs, jfs = DEFAULT_FORMATS, JFS.from_key(KEY)
    rng = np.random.default_rng(0)
    a = np.abs(rng.standard_normal((n, n))) * 1e-2
    a[:t, :t] = loud * (1.0 + rng.standard_normal((t, t)))
    pa = np.array([[0, 1, 1, 2], [1, 1, 0, 1], [2, 1, 1, 1], [1, 0, 1, 1]],
                  np.int8)
    stored = _stored(a, pa, t)
    x = rng.standard_normal((n, 2))
    b = a @ x + 1e-3
    assert PACC.hpl_mxp_metric(a, x, b, fs) == JACC.hpl_mxp_metric(
        a, x, b, jfs)
    np.testing.assert_array_equal(PACC.error_scale(a, a.T, a, 0.5),
                                  JACC.error_scale(a, a.T, a, 0.5))
    np.testing.assert_array_equal(
        PACC.tile_rounding_contribution(a, stored, x, t),
        JACC.tile_rounding_contribution(a, stored, x, t))
    np.testing.assert_array_equal(
        PACC.escalation_threshold(a, x, t, fs, 3.0),
        JACC.escalation_threshold(a, x, t, jfs, 3.0))
    pm = PACC.promotion_mask(a, stored, x, pa, t, fs)
    np.testing.assert_array_equal(pm, JACC.promotion_mask(a, stored, x, pa,
                                                          t, jfs))
    assert pm[0, 0]            # the loud (or NaN-stored) tile is promoted
    if loud > 464:
        assert not np.all(np.isfinite(stored))


def test_requantize_bit_exact():
    n, t = 48, 16
    fs, jfs = DEFAULT_FORMATS, JFS.from_key(KEY)
    rng = np.random.default_rng(1)
    a = rng.standard_normal((n, n)).astype(np.float32)
    lo = np.full((3, 3), fs.low, np.int8)
    new = np.array([[2, 1, 0], [1, 2, 1], [0, 0, 2]], np.int8)
    jm = JL.MPMatrix.from_dense(jnp.asarray(a), lo, t, jfs)
    pm = PL.MPMatrix.from_dense(torch.from_numpy(a), lo, t, fs)
    for dense in (None, a):
        jr = jm.requantize(new, dense=None if dense is None
                           else jnp.asarray(dense))
        pr = pm.requantize(new, dense=None if dense is None
                           else torch.from_numpy(dense))
        np.testing.assert_array_equal(pr.cls, jr.cls.arr)
        np.testing.assert_array_equal(pr.to_dense().numpy(),
                                      np.asarray(jr.to_dense()))
    with pytest.raises(ValueError, match="tile grid"):
        pm.requantize(np.full((4, 4), fs.high, np.int8))


# ---------------------------------------------------------------------------
# ladders and plan prefetch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(ratio_high=0.25, ratio_low8=0.125),
    dict(escalation="balanced", balance_groups=2, ratio_low8=0.25),
    dict(escalation="balanced", summa_grid=(4, 2))])
def test_ladders_match(kw):
    mt, t = 8, 16
    w = JM.graded_spd(mt * t, seed=2)
    pl = PRF._ladder(PRF.SolveConfig(tile=t, **kw), mt, mt, weights=w)
    jl = JRF._ladder(JRF.SolveConfig(tile=t, **kw), mt, mt, weights=w)
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        np.testing.assert_array_equal(p, j)
    cfg, jcfg = PRF.SolveConfig(tile=t, **kw), JRF.SolveConfig(tile=t, **kw)
    for f in np.linspace(0, 1, 9):
        assert PRF._tile_rung(cfg, f) == JRF._tile_rung(jcfg, f)


@pytest.mark.parametrize("key", [KEY, "fp8_e4m3+bf16+split2_fp16"])
def test_resolve_solve_plans_key_set_matches(key, monkeypatch):
    """On a forced spec both packages prefetch the same problems under the
    same plan keys (up to the device kind), and afterwards a prefetched
    problem resolves from the registry — no fresh resolution."""
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    monkeypatch.setenv("REPRO_TUNE_DEVICE", "cpu-interpret")
    t, mt = 16, 4
    w = JM.graded_spd(mt * t, seed=0)
    maps = PRF._ladder(PRF.SolveConfig(tile=t), mt, mt, weights=w)
    pb = D.resolve_solve_plans(maps, t, FormatSet.from_key(key), nrhs=t)
    jb = JTD.resolve_solve_plans(maps, t, JFS.from_key(key), nrhs=t)
    assert set(pb) == set(jb)
    strip = [k.split("|", 1)[1] for k in pb["keys"]]
    assert strip == [k.split("|", 1)[1] for k in jb["keys"]]
    prob = D.solve_gemm_problem(maps[0], t, 1, FormatSet.from_key(key))
    fresh = D.fresh_resolutions()
    _plan, source = D.resolve_plan(prob)
    assert source == "registry" and D.fresh_resolutions() == fresh
    with pytest.raises(ValueError, match="multiple of tile"):
        D.resolve_solve_plans(maps, t, FormatSet.from_key(key), nrhs=8)
    # a plan registered under a key is what that problem resolves to
    other = D.solve_gemm_problem(maps[-1], t, 2, FormatSet.from_key(key))
    plan = D.GemmPlan("ref", t, t, t)
    D.register_plan(S.plan_key(DV.detect_device(), other), plan)
    assert D.resolve_plan(other) == (plan, "registry")


@pytest.mark.parametrize("local_path", ["ref", "grouped"])
def test_resolve_solve_plans_registers_summa_keys(local_path):
    """With summa_grid both packages register the distributed residual
    GEMM of every rung under the same ``summa{P}x{Q}`` problem, and a
    prefetched one resolves from the registry (no fresh resolution)."""
    t, mt = 8, 8
    maps = PRF._ladder(PRF.SolveConfig(tile=t, escalation="balanced",
                                       summa_grid=(2, 2)), mt, mt)
    kw = dict(nrhs=16, summa_grid=(2, 2), local_path=local_path)
    pb = D.resolve_solve_plans(maps, t, DEFAULT_FORMATS, **kw)
    jb = JTD.resolve_solve_plans(maps, t, JFS.from_key(KEY), **kw)
    assert set(pb) == set(jb)
    assert {pb[k].path for k in pb if k[0] == "summa"} == {local_path}
    skeys = [k.split("|", 1)[1] for k in pb["keys"] if "|summa" in k]
    assert skeys == [k.split("|", 1)[1] for k in jb["keys"]
                     if "|summa" in k] and len(skeys) == len(maps)
    pc = np.full((mt, 2), DEFAULT_FORMATS.high, np.int8)
    prob = D.summa_problem_from_maps(maps[-1], pc, pc, t, 2, 2,
                                     DEFAULT_FORMATS)
    fresh = D.fresh_resolutions()
    plan, source = D.resolve_summa_plan(prob)
    assert (plan.path, source) == (local_path, "registry")
    assert D.fresh_resolutions() == fresh
    # an un-prefetched SUMMA problem falls back to ref and counts as fresh
    other = D.summa_problem_from_maps(maps[-1], pc, pc, t, 1, 2,
                                      DEFAULT_FORMATS)
    assert D.resolve_summa_plan(other)[1] == "default"
    assert D.fresh_resolutions() == fresh + 1


# ---------------------------------------------------------------------------
# the whole solve
# ---------------------------------------------------------------------------

def test_store_solve_matches_reference(monkeypatch):
    """Storage escalation at n = 128, tile 16 on the card's dispatch
    decisions (the tile kernel's plain version): equal decisions, the
    metric to 5e-3 absolute and the solution to 1e-3 relative (see
    ``test_torch_split``'s split solve for the reasons); the solution is
    also within 1e-3 of the true one."""
    from repro.solve import SolveConfig as JCfg, solve as jsolve
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    a = graded_spd(128, cond=1e4, rho=0.9, seed=0)
    xt, b = rhs_for_solution(a, seed=1)
    kw = dict(tile=16, ratio_high=0.0, max_sweeps=30)
    jr = jsolve(a, b, JCfg(**kw))
    d0 = D.dispatch_counts().get("tile", 0)
    pr = solve(a, b, SolveConfig(**kw), device="cpu")
    assert D.dispatch_counts()["tile"] > d0
    assert (pr.converged, pr.sweeps, pr.escalations, pr.compute_mode,
            pr.factorizations, pr.ratio_history) == (
        jr.converged, jr.sweeps, jr.escalations, jr.compute_mode,
        jr.factorizations, jr.ratio_history)
    assert pr.converged and pr.escalations >= 1
    np.testing.assert_array_equal(pr.final_map, jr.final_map)
    assert pr.storage_bytes == jr.storage_bytes < pr.uniform_high_bytes
    assert pr.plan_keys == jr.plan_keys
    assert abs(pr.metric - jr.metric) <= 5e-3
    assert np.abs(pr.x - jr.x).max() <= 1e-3 * np.abs(jr.x).max()
    assert np.abs(pr.x - xt).max() <= 1e-3 * np.abs(xt).max()
    assert pr.fresh_resolutions == 0
    assert 0.0 <= pr.trail_copy_seconds <= pr.factor_seconds


def test_cg_solve_converges_on_cpu():
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    a = graded_spd(96, cond=1e3, rho=0.85, seed=2)
    xt, b = rhs_for_solution(a, seed=3)
    rep = solve(a, b, SolveConfig(tile=16, method="cg", max_sweeps=40),
                device="cpu")
    assert rep.converged and rep.method == "cg"
    assert rep.fresh_resolutions == 0
    assert np.abs(rep.x - xt).max() <= 0.05 * np.abs(xt).max()


def test_solve_rejects_what_it_cannot_run():
    from repro_torch.solve import SolveConfig, diag_dominant, solve
    a = diag_dominant(64, seed=0)
    b = np.ones((64, 1))
    # a grid needs the balanced ladder (checked before any rank spawns)
    with pytest.raises(ValueError, match="balanced"):
        solve(a, b, SolveConfig(tile=16, summa_grid=(2, 2)), device="cpu")
    with pytest.raises(ValueError, match="square"):
        solve(a[:, :32], b, SolveConfig(tile=16), device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        solve(a, b, SolveConfig(tile=16, method="qr"), device="cpu")
    with pytest.raises(ValueError, match="nrhs_pad"):
        solve(a, b, SolveConfig(tile=16, nrhs_pad=24), device="cpu")
    with pytest.raises(ValueError, match="store | split | auto"):
        solve(a, b, SolveConfig(tile=16, compute_escalation="bogus"),
              device="cpu")
    # the cpu spec has no kernels: a forced kernel path is refused
    with pytest.raises(ValueError, match="invalid"):
        solve(a, b, SolveConfig(tile=16, residual_path="grouped"),
              device="cpu")


def test_report_fields_cover_the_reference():
    port = {f.name for f in dataclasses.fields(PRF.SolveReport)}
    ref = {f.name for f in dataclasses.fields(JRF.SolveReport)}
    assert ref - port == set()
    assert port - ref == {"factor_seconds", "trail_copy_seconds",
                          "broadcast_seconds", "broadcast_bytes"}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_end_to_end_on_cpu(capsys):
    from repro_torch.launch import solve as L
    assert L._parse_ratio("20D:70S:10Q") == (0.2, 0.1)
    with pytest.raises(ValueError, match="bad ratio"):
        L._parse_ratio("20X:80S")
    rc = L.main(["--n", "128", "--ratio", "0D:100S", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "converged=True" in out
    assert "mid-solve fresh resolutions 0" in out
    # a solve stopped before it converges exits nonzero
    rc = L.main(["--n", "128", "--device", "cpu", "--max-sweeps", "1"])
    assert rc == 1


# ---------------------------------------------------------------------------
# distributed (SUMMA) solves: twins of tests/test_solve.py's four; the
# ranks are spawned on the CPU over gloo
# ---------------------------------------------------------------------------

def test_distributed_solution_bitwise_vs_single_device():
    """Invariant (b): the 2x2 grouped-SUMMA solve walks the 1x1-grid
    solve's trajectory bit for bit (the reference's parameters; its
    single-device side needs the grouped kernel at t = 8, which the port
    compiles only from t = 16: invariant (c) is the next test)."""
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    n = 64
    a = graded_spd(n, cond=1e4, rho=0.9, seed=0)
    xt, b = rhs_for_solution(a, seed=1)
    common = dict(tile=8, ratio_high=0.0, escalation="balanced",
                  balance_groups=2, local_path="grouped", nrhs_pad=16,
                  max_sweeps=25)
    rep_1 = solve(a, b, PRF.SolveConfig(summa_grid=(1, 1), **common),
                  device="cpu")
    rep_d = solve(a, b, SolveConfig(summa_grid=(2, 2), **common),
                  device="cpu")
    assert rep_1.converged and rep_d.converged
    assert rep_1.fresh_resolutions == 0 and rep_d.fresh_resolutions == 0
    assert rep_d.summa_recompiles == 0       # ladder tables prebuilt
    assert rep_d.escalations >= 1
    np.testing.assert_array_equal(rep_1.final_map, rep_d.final_map)
    np.testing.assert_array_equal(rep_1.x, rep_d.x)
    assert rep_1.metric_history == rep_d.metric_history
    assert np.abs(rep_d.x - xt).max() <= 1e-3 * np.abs(xt).max()


def test_distributed_grouped_solve_equals_single_device_grouped(
        monkeypatch):
    """Invariant (c): the 2x2 grouped-SUMMA solve equals the single-device
    grouped solve (``residual_path="grouped"``, the same ladder and RHS
    width) bit for bit: the accumulate-into local update sums every C
    tile in the single-device path's order (t = 16, the kernel's
    smallest tile; the card spec is forced for the single-device plan)."""
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    n = 64
    a = graded_spd(n, cond=1e4, rho=0.9, seed=0)
    xt, b = rhs_for_solution(a, seed=1)
    common = dict(tile=16, ratio_high=0.0, escalation="balanced",
                  balance_groups=2, nrhs_pad=32, max_sweeps=25)
    rep_d = solve(a, b, SolveConfig(summa_grid=(2, 2), local_path="grouped",
                                    **common), device="cpu")
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    rep_s = solve(a, b, SolveConfig(residual_path="grouped", **common),
                  device="cpu")
    assert rep_s.converged and rep_d.converged and rep_d.escalations >= 1
    np.testing.assert_array_equal(rep_s.final_map, rep_d.final_map)
    np.testing.assert_array_equal(rep_s.x, rep_d.x)
    assert rep_s.metric_history == rep_d.metric_history


def test_distributed_ref_path_matches_single_device():
    """The ref-local-path 2x2 solve agrees with the single-device solve to
    fp32 accumulation noise, with the same final map, and issues zero
    fresh resolutions under the prefetched summa plan keys (warm off: no
    table is built ahead, so the solve builds its rungs' tables)."""
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    n = 64
    a = graded_spd(n, cond=1e3, rho=0.9, seed=3)
    xt, b = rhs_for_solution(a, seed=4)
    common = dict(tile=8, ratio_high=0.0, escalation="balanced",
                  balance_groups=2, nrhs_pad=16, max_sweeps=25)
    rep_s = solve(a, b, SolveConfig(**common), device="cpu")
    rep_d = solve(a, b, SolveConfig(summa_grid=(2, 2), warm=False,
                                    **common), device="cpu")
    assert rep_d.converged and rep_d.fresh_resolutions == 0
    assert rep_d.summa_recompiles >= 1   # built in the solve, not ahead
    np.testing.assert_array_equal(rep_s.final_map, rep_d.final_map)
    assert float(np.abs(rep_s.x - rep_d.x).max()
                 / max(np.abs(rep_s.x).max(), 1e-30)) < 1e-3
    assert np.abs(rep_d.x - xt).max() <= 1e-3 * np.abs(xt).max()


def test_summa_grid_shape_validation():
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    a = graded_spd(48, cond=1e3, rho=0.9, seed=0)   # 48 % (2·16) != 0
    _, b = rhs_for_solution(a, seed=0)
    with pytest.raises(ValueError, match="incompatible"):
        solve(a, b, SolveConfig(tile=16, summa_grid=(2, 2),
                                escalation="balanced"), device="cpu")
    a = graded_spd(64, cond=1e3, rho=0.9, seed=0)
    _, b = rhs_for_solution(a, seed=0)
    with pytest.raises(ValueError, match="balanced"):
        solve(a, b, SolveConfig(tile=16, summa_grid=(2, 2),
                                escalation="tile"), device="cpu")
    with pytest.raises(ValueError, match="nrhs_pad"):
        solve(a, b, SolveConfig(tile=16, summa_grid=(2, 2),
                                escalation="balanced", nrhs_pad=16),
              device="cpu")   # not a multiple of tile·Q = 32
    with pytest.raises(ValueError, match="single-device"):
        solve(a, b, SolveConfig(tile=16, summa_grid=(2, 2),
                                escalation="balanced",
                                compute_escalation="split"), device="cpu")


def test_cli_summa_on_cpu(capsys):
    """``--summa 2x2 --device cpu`` names the placement before any work,
    defaults to the balanced ladder and solves on four spawned ranks."""
    from repro_torch.launch import solve as L
    rc = L.main(["--summa", "2x2", "--n", "128", "--device", "cpu",
                 "--local-path", "grouped"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.splitlines()[0] == "summa grid 2x2: ranks on cpu over gloo"
    assert "summa=2x2" in out and "converged=True" in out
    assert "SUMMA table rebuilds 0" in out
