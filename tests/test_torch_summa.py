"""Port parity: SUMMA over ``torch.distributed`` (``repro_torch.core.summa``
on ``repro_torch.launch.grid``) against the JAX ``repro.core.summa``, twins
of ``tests/test_summa_distributed.py`` and of the two SUMMA tests of
``tests/test_accuracy_bounds.py``.

The JAX side runs in this process on the forced host devices
(``host_grid_devices``); the port's ranks are spawned on the CPU over gloo
(``run_on_grid``).  Spawning costs seconds, so every grid call of the
module runs in two spawns made once (a module fixture): four ranks for the
2x2, 1x4 and 4x1 grids (``call_all`` picks each call's grid), one rank for
the 1x1 grid.  Inputs are numpy-seeded, M = N = K = 64 and t = 8 as in the
reference; invariant (a) takes 128 so that maps sorted in four segments
(which serve every grid) still hold every class.

Tolerances.  Across the frameworks (F3): within twice
``class_error_bounds`` per C class, as the reference's ``_assert_parity``
(each side carries its own rounding budget).  Inside the port: a P×Q grid
equals the 1x1 grid bit for bit, on both local paths, and the grouped
local update equals the single-device grouped path bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import MPMatrix as JMP
from repro.core import format_set as j_format_set
from repro.core.summa import summa_mp_gemm as j_summa
from repro.tune import dispatch as JTD
from repro_torch.core import schedule
from repro_torch.core.accuracy import (check_against_fp64,
                                       class_error_bounds, error_scale)
from repro_torch.core.formats import DEFAULT_FORMATS, format_set
from repro_torch.core.layout import MPMatrix, expand_map
from repro_torch.core.mp_gemm import mp_gemm_ref
from repro_torch.core.precision import Policy
from repro_torch.core.summa import (_panel_owner_steps,
                                    summa_collective_bytes, summa_selfcheck,
                                    summa_with_stats)
from repro_torch.launch import grid as G
from repro_torch.tune import costmodel as CM
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as D
from repro_torch.tune import search as S
from repro_torch.tune.costmodel import GemmPlan

M = K = N = 64
T = 8
#: invariant (a)'s edge: A and B sorted in four segments of four tiles
AM = 128
GRIDS = [(2, 2), (1, 4), (4, 1)]
FSETS = {
    "default": ("fp8_e4m3", "bf16", "fp32"),
    "fp8_e5m2": ("fp8_e5m2", "fp16", "fp32"),
    "fp16": ("fp16", "fp32"),
}
PATHS = ("ref", "grouped")
#: the 1x1 bound twin's draws: ratio + ratio8 <= 1 (the reference's
#: over-unity pair is a reference-side failure, ROADMAP.md queue 3)
PAIRS = ((0.0, 0.0), (0.0, 0.25), (0.5, 0.0), (0.5, 0.25), (1.0, 0.0))
SEEDS = (0, 1, 2)


def _plan(path):
    return GemmPlan(path=path, bm=T, bn=T, bk=T)


def _dense(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _operands(P, Q, fset, *, seed=0, ratio=0.5, ratio8=None, size=M,
              zero_c=False):
    """Numpy values and the reference's maps (A/B sorted-balanced in P/Q
    segments, C balanced); returns (dense, maps, port MPMatrices)."""
    if ratio8 is None:
        ratio8 = 0.25 if fset.low8 is not None else 0.0
    pol = Policy(kind="ratio", ratio_high=ratio, ratio_low8=ratio8,
                 seed=seed)
    mt = size // T
    maps = (schedule.sorted_balanced_map(mt, mt, pol, axis=0, groups=P,
                                         fset=fset),
            schedule.sorted_balanced_map(mt, mt, pol, axis=1, groups=Q,
                                         fset=fset),
            schedule.balanced_ratio_map(mt, mt, pol, P, Q, fset=fset))
    dense = _dense(seed, [(size, size)] * 3)
    if zero_c:
        dense[2] = np.zeros((size, size), np.float32)
    mats = [MPMatrix.from_dense(torch.from_numpy(d), p, T, fset)
            for d, p in zip(dense, maps)]
    return dense, maps, mats


def _jax(dense, maps, fs):
    jfs = j_format_set(*fs.names)
    return [JMP.from_dense(jnp.asarray(d), p, T, jfs)
            for d, p in zip(dense, maps)]


def _jnp(x) -> np.ndarray:
    return np.asarray(x.to_dense(), np.float64)


def _worst(out: np.ndarray, ref: np.ndarray, maps, dense, fs, beta=0.0,
           size=M) -> float:
    """Worst |out - ref| over twice the per-class bound (≤ 1 passes)."""
    bounds = class_error_bounds(maps[0], maps[1], maps[2], size, fs)
    scale = error_scale(dense[0], dense[1], dense[2], beta)
    err = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    sel = expand_map(maps[2], T)
    return max(float((err[sel == c] / (2 * b * scale[sel == c]
                                       + 1e-6)).max())
               for c, b in bounds.items() if (sel == c).any())


def _bound_operands(P, Q, fs, ratio, ratio8, seed):
    """The reference's ``_summa_within_bound`` operands (C zero)."""
    return _operands(P, Q, fs, seed=seed, ratio=ratio, ratio8=ratio8,
                     zero_c=True)


def _jobs():
    """Every grid call of the module: {name: (call, grid)} and the data
    the tests compare with."""
    calls, data = {}, {}
    for fs_name, names in FSETS.items():
        fs = format_set(*names)
        for P, Q in GRIDS:
            dense, maps, (A, B, C) = _operands(P, Q, fs)
            data[("parity", fs_name, P, Q)] = (dense, maps, (A, B, C))
            calls[("parity", fs_name, P, Q)] = (
                (summa_with_stats, (A, B, C), {"beta": 0.5}, (P, Q)), "4")
        # invariant (a): maps sorted in 4 segments serve every grid
        dense, maps, mats = _operands(4, 4, fs, size=AM, seed=5)
        data[("a", fs_name)] = (dense, maps, mats)
        for path in PATHS:
            for P, Q in GRIDS:
                calls[("a", fs_name, path, P, Q)] = (
                    (summa_with_stats, mats, {"plan": _plan(path)},
                     (P, Q)), "4")
            calls[("a", fs_name, path, 1, 1)] = (
                (summa_with_stats, mats, {"plan": _plan(path)}), "1")
        dense, maps, mats = _operands(2, 2, fs, zero_c=True)
        data[("grouped", fs_name)] = (dense, maps, mats)
        calls[("grouped", fs_name)] = (
            (summa_with_stats, mats, {"plan": _plan("grouped")}, (2, 2)),
            "4")
    fs = DEFAULT_FORMATS
    dense, maps, (A, B, _) = _operands(2, 2, fs)
    pc = np.full((M // T, N // T), fs.low, np.int8)
    pc[0, 0] = fs.high          # one HIGH tile on one shard only
    C = MPMatrix.from_dense(torch.from_numpy(dense[2]), pc, T, fs)
    data["unbalanced"] = (dense, (maps[0], maps[1], pc), (A, B, C))
    calls["unbalanced"] = ((summa_with_stats, (A, B, C), {}, (2, 2)), "4")
    calls["unbalanced grouped"] = (
        (summa_with_stats, (A, B, C), {"plan": _plan("grouped")}, (2, 2)),
        "4")
    dense, maps, mats = _operands(2, 2, fs, seed=3)
    data["alpha beta"] = (dense, maps, mats)
    calls["alpha beta"] = ((summa_with_stats, mats,
                            {"alpha": 2.0, "beta": -0.5}, (2, 2)), "4")
    calls["default c"] = ((summa_with_stats, mats[:2], {}, (2, 2)), "4")
    pol = Policy(kind="ratio", ratio_high=0.5)
    kx = 24   # kt = 3 panels, not divisible by Q = 2
    pa = schedule.sorted_balanced_map(M // T, kx // T, pol, 0, 2, fset=fs)
    pb = schedule.sorted_balanced_map(kx // T, N // T, pol, 1, 2, fset=fs)
    calls["indivisible k"] = ((summa_with_stats, (
        MPMatrix.from_dense(torch.ones((M, kx)), pa, T, fs),
        MPMatrix.from_dense(torch.ones((kx, N)), pb, T, fs)), {}, (2, 2)),
        "4")
    pol = Policy(kind="ratio", ratio_high=0.5, seed=1)
    pa = schedule.balanced_ratio_map(M // T, K // T, pol, 2, 1, fset=fs)
    pb = schedule.sorted_balanced_map(K // T, N // T, pol, 1, 2, fset=fs)
    calls["unsorted"] = ((summa_with_stats, (
        MPMatrix.from_dense(torch.ones((M, K)), pa, T, fs),
        MPMatrix.from_dense(torch.ones((K, N)), pb, T, fs)), {}, (2, 2)),
        "4")
    calls["too large"] = ((G.rank_report, (), {}, (64, 64)), "4")
    for P, Q in GRIDS:
        calls[("report", P, Q)] = ((G.rank_report, (), {}, (P, Q)), "4")
    calls[("report", 1, 1)] = ((G.rank_report, (), {}), "1")
    calls["selfcheck 2x2"] = ((summa_selfcheck, (), {"tile": T}, (2, 2)),
                              "4")
    calls["selfcheck 1x4"] = ((summa_selfcheck, (), {
        "tile": T, "fset": format_set("fp16", "fp32")}, (1, 4)), "4")
    # the accuracy-bound twins: 2x2 per format set, 1x1 per draw
    for fs_name, names in FSETS.items():
        fs = format_set(*names)
        r8 = 0.25 if fs.low8 is not None else 0.0
        dense, maps, mats = _bound_operands(2, 2, fs, 0.5, r8, 0)
        data[("bound", fs_name)] = (dense, maps, mats)
        calls[("bound", fs_name)] = ((summa_with_stats, mats, {}, (2, 2)),
                                     "4")
    for ratio, r8 in PAIRS:
        for seed in SEEDS:
            dense, maps, mats = _bound_operands(1, 1, DEFAULT_FORMATS, ratio,
                                                r8, seed)
            data[("bound1", ratio, r8, seed)] = (dense, maps, mats)
            calls[("bound1", ratio, r8, seed)] = (
                (summa_with_stats, mats, {}), "1")
    return calls, data


@pytest.fixture(scope="module")
def battery():
    """Run every job: one spawn of 4 ranks, one of 1 (CPU, gloo)."""
    calls, data = _jobs()
    out = {}
    for world, (P, Q) in (("4", (2, 2)), ("1", (1, 1))):
        names = [k for k, (_, w) in calls.items() if w == world]
        res = G.run_on_grid(P, Q, G.call_all, [calls[k][0] for k in names],
                            capture=True, device="cpu", backend="gloo")
        out.update(zip(names, res))
    return out, data


@pytest.fixture(autouse=True)
def _hermetic_tune(tmp_path, monkeypatch):
    """Isolate both packages' plan registries and caches per test."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jplans.json"))
    monkeypatch.setenv(S.CACHE_ENV, str(tmp_path / "plans.json"))
    monkeypatch.delenv(DV.DEVICE_ENV, raising=False)
    monkeypatch.setattr(S, "_default_cache", None)
    JTD.clear_registry()
    D.clear_registry()
    yield
    JTD.clear_registry()
    D.clear_registry()


def _ok(res):
    assert not isinstance(res, Exception), repr(res)
    return res


def _same_bits(x, y) -> bool:
    return all(torch.equal(a, b) for a, b in zip(x.bufs, y.bufs))


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{p}x{q}" for p, q in GRIDS])
@pytest.mark.parametrize("fs", sorted(FSETS))
def test_summa_matches_single_device(host_grid_devices, battery, grid, fs):
    """The port's SUMMA ≍ the JAX SUMMA on the same grid and the JAX
    single-device mp_matmul on the same tile maps, within twice the
    per-class bound, for every grid × format set."""
    runs, data = battery
    P, Q = grid
    fset = format_set(*FSETS[fs])
    dense, maps, (A, B, C) = data[("parity", fs, P, Q)]
    row = _ok(runs[("parity", fs, P, Q)])
    out = row["out"]
    assert out.fset == fset and np.array_equal(out.cls, C.cls)
    JA, JB, JC = _jax(dense, maps, fset)
    mesh = jax.make_mesh((P, Q), ("row", "col"))
    jout = j_summa(JA, JB, JC, mesh=mesh, alpha=1.0, beta=0.5)
    single = JTD.mp_matmul(JA, JB, JC, alpha=1.0, beta=0.5)
    got = out.to_dense().numpy()
    for want in (_jnp(jout), _jnp(single)):
        assert _worst(got, want, maps, dense, fset, beta=0.5) <= 1.0


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("fs", sorted(FSETS))
def test_grid_shape_does_not_change_bits(battery, fs, path):
    """Invariant (a): the 2x2, 1x4 and 4x1 SUMMA equal the 1x1 SUMMA bit
    for bit on the same operands (maps sorted in four segments, which
    serve every grid), on both local paths."""
    runs, _ = battery
    one = _ok(runs[("a", fs, path, 1, 1)])["out"]
    for P, Q in GRIDS:
        assert _same_bits(_ok(runs[("a", fs, path, P, Q)])["out"], one), (
            P, Q)


@pytest.mark.parametrize("fs", sorted(FSETS))
def test_grouped_local_update_bitwise_vs_single_grouped(battery, fs):
    """With a grouped plan (served from the registry) the SUMMA local
    update is the grouped kernel's accumulate-into form: bit for bit the
    single-device grouped path (same per-tile products in k order, one
    storage rounding)."""
    runs, data = battery
    dense, maps, (A, B, C) = data[("grouped", fs)]
    prob = D.summa_problem(A, B, C, (2, 2))
    key = S.plan_key(DV.detect_device(), prob)
    D.register_plan(key, _plan("grouped"))
    plan, source = D.resolve_summa_plan(prob)
    assert (plan.path, source) == ("grouped", "registry")
    single = D.execute_plan(_plan("grouped"), A, B, C)
    row = _ok(runs[("grouped", fs)])
    assert _same_bits(row["out"], single)


def test_grouped_plan_rejected_for_unbalanced_c_map(battery):
    """A C map with unequal per-shard class counts cannot take the
    grouped local update: resolution serves ref, the result is right, and
    an explicit grouped plan is refused loudly."""
    runs, data = battery
    dense, maps, (A, B, C) = data["unbalanced"]
    prob = D.summa_problem(A, B, C, (2, 2))
    assert prob.op.endswith("!ub")
    D.register_plan(S.plan_key(DV.detect_device(), prob), _plan("grouped"))
    plan, source = D.resolve_summa_plan(prob)
    assert (plan.path, source) == ("ref", "default")
    out = _ok(runs["unbalanced"])["out"]
    ref = mp_gemm_ref(A, B, C)
    assert _worst(out.to_dense().numpy(), ref.to_dense().numpy(), maps,
                  [dense[0], dense[1], np.zeros_like(dense[2])],
                  DEFAULT_FORMATS) <= 1.0
    err = runs["unbalanced grouped"]
    assert isinstance(err, ValueError) and "shard-balanced" in str(err)


def test_alpha_beta_general(battery):
    runs, data = battery
    dense, maps, (A, B, C) = data["alpha beta"]
    out = _ok(runs["alpha beta"])["out"].to_dense()
    ref = mp_gemm_ref(A, B, C, alpha=2.0, beta=-0.5).to_dense()
    assert float((out - ref).abs().max() / ref.abs().max()) < 2e-2


def test_default_c_is_uniform_low(battery):
    out = _ok(battery[0]["default c"])["out"]
    assert set(np.unique(out.cls)) == {DEFAULT_FORMATS.low}


def test_plan_key_carries_mesh_shape_and_formats():
    fset = format_set("fp8_e5m2", "fp16", "fp32")
    _, _, (A, B, C) = _operands(2, 2, fset)
    dev = DV.detect_device()
    keys = set()
    for P, Q in GRIDS:
        key = S.plan_key(dev, D.summa_problem(A, B, C, (P, Q)))
        assert f"summa{P}x{Q}" in key
        assert f"M{M // P}N{N // Q}K{K}" in key      # per-shard extents
        assert "fp8_e5m2+fp16+fp32" in key           # format-set tag
        keys.add(key)
    assert len(keys) == len(GRIDS)
    # the same anatomy as the reference's keys
    jfs = j_format_set(*fset.names)
    jp = JTD.summa_problem_from_maps(A.cls, B.cls, C.cls, T, 2, 2, jfs)
    pp = D.summa_problem_from_maps(A.cls, B.cls, C.cls, T, 2, 2, fset)
    assert (pp.op, pp.m, pp.n, pp.k, pp.formats, pp.ratio_key()) == (
        jp.op, jp.m, jp.n, jp.k, jp.formats, jp.ratio_key())


@pytest.mark.parametrize("kind,tile,valid", [
    ("cpu", T, True), ("cpu", 128, True), ("gpu-a100", 128, False),
    ("gpu-h100", T, False), ("gpu-h100", 128, True)])
def test_grouped_local_update_validity_by_device(kind, tile, valid):
    """The grouped local update takes its plain version only on the CPU
    (any tile); a card runs it only with the kernels, at their tiles, and
    is refused up front (plan validation, the solver's prefetch) rather
    than inside a spawned rank."""
    fs = DEFAULT_FORMATS
    pol = Policy(kind="ratio", ratio_high=0.5, ratio_low8=0.25, seed=0)
    a_cls = schedule.sorted_balanced_map(8, 8, pol, axis=0, groups=2,
                                         fset=fs)
    b_cls = schedule.sorted_balanced_map(8, 8, pol, axis=1, groups=2,
                                         fset=fs)
    c_cls = schedule.balanced_ratio_map(8, 8, pol, 2, 2, fset=fs)
    dev = DV.DEVICE_TABLE[kind]
    prob = D.summa_problem_from_maps(a_cls, b_cls, c_cls, tile, 2, 2, fs)
    bad = CM.validate_plan(GemmPlan("grouped", tile, tile, tile), prob, dev)
    assert (not bad) == valid, bad
    assert not CM.validate_plan(GemmPlan("ref", tile, tile, tile), prob, dev)
    hi = np.full((8, 8), fs.high, np.int8)
    if valid:
        D.resolve_solve_plans([hi], tile, fs, nrhs=2 * tile,
                              summa_grid=(2, 2), local_path="grouped",
                              dev=dev)
    else:
        with pytest.raises(ValueError, match="local path 'grouped'"):
            D.resolve_solve_plans([hi], tile, fs, nrhs=2 * tile,
                                  summa_grid=(2, 2), local_path="grouped",
                                  dev=dev)


def test_indivisible_k_panels_raise(battery):
    with pytest.raises(ValueError, match="divide evenly"):
        _panel_owner_steps(48, 8, 1, 4)
    err = battery[0]["indivisible k"]
    assert isinstance(err, ValueError) and "divide evenly" in str(err)


def test_unsorted_map_raises(battery):
    err = battery[0]["unsorted"]
    assert isinstance(err, ValueError) and "class-sorted" in str(err)


def test_grid_descriptive_errors(battery):
    """The twin of the reference's mesh errors: a grid needs an
    initialized process group of P·Q ranks, and run_on_grid checks the
    placement before it spawns."""
    runs, _ = battery
    with pytest.raises(RuntimeError, match="initialized process group"):
        G.Grid(2, 2, device="cpu", backend="gloo")
    err = runs["too large"]
    assert isinstance(err, RuntimeError) and "4096 ranks" in str(err)
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        G.run_on_grid(2, 2, G.rank_report, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        G.run_on_grid(2, 2, G.rank_report, device="cpu", backend="mpi")
    for P, Q in GRIDS + [(1, 1)]:
        rep = _ok(runs[("report", P, Q)])
        assert rep["shape"] == (P, Q) and (rep["p"], rep["q"]) == (0, 0)
        assert rep["backend"] == "gloo" and rep["device"] == "cpu"
        # a spawned rank imports neither jax nor the JAX package
        assert "jax" not in rep["packages"]
        assert "repro" not in rep["packages"]


def test_collective_bytes_follow_format_set(battery):
    # default set, 50D:25S:25Q → 4·.5 + 2·.25 + 1·.25 = 2.75 B/elem
    model = summa_collective_bytes(M, N, K, T, 2, 2, 0.5, 0.25)
    assert model["bytes_per_elem_model"] == pytest.approx(2.75)
    # 2-format fp16+fp32, 50D:50S → 4·.5 + 2·.5 = 3.0 B/elem
    fs = format_set("fp16", "fp32")
    model = summa_collective_bytes(M, N, K, T, 2, 2, 0.5, 0.0, fs)
    assert model["bytes_per_elem_model"] == pytest.approx(3.0)
    # each rank's broadcast bytes, counted per slab, are the model's: one
    # A panel and one B panel per step (A's and B's role fractions differ
    # where P != Q, so each panel takes its own operand's)
    runs, data = battery
    fs = DEFAULT_FORMATS
    for P, Q in GRIDS:
        row = _ok(runs[("parity", "default", P, Q)])
        pa, pb, _ = data[("parity", "default", P, Q)][1]
        ma, mb = (summa_collective_bytes(
            M, N, K, T, P, Q, float((p == fs.high).mean()),
            float((p == fs.low8).mean())) for p in (pa, pb))
        want = ma["steps"] * (ma["a_panel_bytes"] + mb["b_panel_bytes"])
        assert row["bytes"] == [want] * (P * Q)
        if P == Q:   # one ratio pair: the total is the model's
            assert sum(row["bytes"]) == ma["total_bytes"]


def test_summa_selfcheck_report(battery):
    rep = _ok(battery[0]["selfcheck 2x2"])
    assert rep["grid"] == "2x2" and rep["local_path"] == "ref"
    assert rep["rel_err"] < 1e-2
    rep16 = _ok(battery[0]["selfcheck 1x4"])
    assert rep16["formats"] == "fp16+fp32" and rep16["rel_err"] < 1e-2


def test_engine_summa_grid_wiring():
    """ArchConfig.summa_grid threads the distributed self-check through
    the serve engine's construction (ranks spawned on the CPU)."""
    import dataclasses

    from repro_torch.configs import get, reduced
    from repro_torch.models import transformer as Tm
    from repro_torch.serve import Engine, ServeConfig
    cfg = dataclasses.replace(reduced(get("internlm2-1.8b"), tp=2),
                              summa_grid=(2, 2))
    params = Tm.init_model(torch.Generator().manual_seed(0), cfg)
    eng = Engine(cfg, params, ServeConfig(max_batch=1, max_seq=16))
    assert eng.summa_report is not None
    assert eng.summa_report["grid"] == "2x2"
    assert eng.summa_report["rel_err"] < 1e-2


@pytest.mark.parametrize("fs", ["fp8_e4m3+bf16+fp32", "fp8_e5m2+fp16+fp32",
                                "fp16+fp32"])
def test_summa_multi_device_within_bound(battery, fs):
    """The 2x2 SUMMA inside the fp64 error bound (the twin of
    ``test_accuracy_bounds.py::test_summa_multi_device_within_bound``)."""
    name = next(k for k, v in FSETS.items() if "+".join(v) == fs)
    dense, maps, _ = battery[1][("bound", name)]
    out = _ok(battery[0][("bound", name)])["out"]
    rep = check_against_fp64(out.to_dense().numpy(), dense[0], dense[1],
                             np.zeros((M, M)), *maps, T, format_set(
                                 *fs.split("+")))
    assert rep["ok"], (fs, rep["worst_ratio"])


@settings(max_examples=6, deadline=None)
@given(pair=st.sampled_from(PAIRS), seed=st.sampled_from(SEEDS))
def test_summa_1x1_within_bound(battery, pair, seed):
    """A 1x1 grid runs the full slab machinery on one rank, inside the
    fp64 bound (draws with ratio + ratio8 <= 1 only)."""
    ratio, r8 = pair
    dense, maps, _ = battery[1][("bound1", ratio, r8, seed)]
    out = _ok(battery[0][("bound1", ratio, r8, seed)])["out"]
    rep = check_against_fp64(out.to_dense().numpy(), dense[0], dense[1],
                             np.zeros((M, M)), *maps, T, DEFAULT_FORMATS)
    assert rep["ok"], (pair, seed, rep["worst_ratio"])
