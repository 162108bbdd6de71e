"""The port's measuring search and plan-cache hygiene
(``repro_torch.tune.search`` / ``.hygiene``) against the JAX package's.

Twins of ``tests/test_tune.py``'s autotune round trip, cache-only mode,
the four hygiene tests (clean, drift, unregistered formats, canonical
writer) and ``tests/test_quant.py``'s int-format keys, plus the port's
measured ``tune_linear_params``, ``autotune_summa``, ``measure`` and the
schema-1 files of the cache's previous layout.  Parity: both packages'
autotune key the same problem alike (every segment but the device), and
both validators flag the same drift.  Tolerances: the cache-routed
``mp_matmul`` against ``mp_gemm_ref`` at 1e-4 absolute, as the
reference's test.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import metrics as JOM
from repro.tune import dispatch as JTD
from repro.tune import search as JTS
from repro_torch.core import layout as PL
from repro_torch.core.formats import registry_signatures
from repro_torch.core.mp_gemm import mp_gemm_ref
from repro_torch.core.precision import Policy, make_map
from repro_torch.obs import metrics as M
from repro_torch.tune import costmodel as CM
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as D
from repro_torch.tune import search as S
from repro_torch.tune.hygiene import validate_cache


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jplans.json"))
    monkeypatch.delenv("REPRO_TUNE_CACHE_ONLY", raising=False)
    monkeypatch.setattr(JTD, "_REGISTRY", {})
    monkeypatch.setattr(JTS, "_default_cache", None)
    monkeypatch.setattr(JOM, "_DEFAULT", JOM.MetricsRegistry())
    monkeypatch.setenv(S.CACHE_ENV, str(tmp_path / "plans.json"))
    monkeypatch.delenv(S.CACHE_ONLY_ENV, raising=False)
    monkeypatch.delenv(DV.DEVICE_ENV, raising=False)
    monkeypatch.setattr(D, "_REGISTRY", {})
    monkeypatch.setattr(S, "_default_cache", None)
    monkeypatch.setattr(M, "_DEFAULT", M.MetricsRegistry())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense(M_, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((M_, K), (K, N), (M_, N))]


def _operands(M_, K, N, t, ratio=0.5, seed=0):
    """The same values and maps as port MPMatrices and as the
    reference's."""
    from repro.core import MPMatrix as JMP
    dense = _dense(M_, K, N, seed)
    maps = [make_map(d.shape, t, Policy("ratio", ratio, seed=seed + i))
            for i, d in enumerate(dense)]
    port = [PL.MPMatrix.from_dense(torch.from_numpy(d), p, t)
            for d, p in zip(dense, maps)]
    ref = [JMP.from_dense(jnp.asarray(d), p, t) for d, p in zip(dense, maps)]
    return port, ref


def _spy(monkeypatch):
    calls = []
    real = S.measure

    def spy(fn, **kw):
        calls.append(kw)
        return real(fn, **kw)

    monkeypatch.setattr(S, "measure", spy)
    return calls


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------

def test_plan_cache_roundtrip_and_cache_only_dispatch(monkeypatch):
    (A, B, C), (JA, JB, JC) = _operands(32, 32, 32, 8)
    from repro_torch.tune import autotune, mp_matmul
    plan = autotune(A, B, C, warmup=1, iters=2, max_measure=2)
    path = S.cache_path()
    assert os.path.exists(path), "autotune must persist the plan cache"
    fresh = S.PlanCache(path)
    assert len(fresh) == 1
    key = fresh.keys()[0]
    assert fresh.get(key) == plan
    meta = fresh.meta(key)
    assert meta["source"] == "measured"
    assert meta["measured_us"] > 0 and meta["predicted_us"] > 0

    # the reference keys the same problem alike, device segment aside
    from repro.tune import autotune as jautotune
    jautotune(JA, JB, JC, warmup=1, iters=2, max_measure=2)
    jkey = JTS.PlanCache(JTS.cache_path()).keys()[0]
    assert key.split("|")[1:] == jkey.split("|")[1:]

    # cache-only mode: dispatch routes through the persisted plan
    monkeypatch.setenv(S.CACHE_ONLY_ENV, "1")
    D.clear_registry()
    S._default_cache = None
    calls = _spy(monkeypatch)
    got, source = D.resolve_plan(D.problem_of(A, B, C))
    assert got == plan and source == "cache"
    assert autotune(A, B, C) == plan and calls == []
    out = mp_matmul(A, B, C)
    ref = mp_gemm_ref(A, B, C)
    torch.testing.assert_close(out.to_dense(), ref.to_dense(), rtol=0,
                               atol=1e-4)


def test_cache_only_mode_never_measures(monkeypatch):
    (A, B, C), _ = _operands(16, 16, 16, 8)
    monkeypatch.setenv(S.CACHE_ONLY_ENV, "1")
    prob = D.problem_of(A, B, C)
    calls = _spy(monkeypatch)

    def boom(plan):
        raise RuntimeError("cache-only mode must not execute plans")

    plan, report = S.autotune_problem(prob, boom)
    assert report["source"] == "model" and calls == []
    assert not CM.validate_plan(plan, prob, DV.detect_device())
    # kept in memory only, never persisted
    assert not os.path.exists(S.cache_path())


def test_measured_candidates_and_failed_ones(monkeypatch):
    """Every model-valid candidate is measured (up to ``max_measure``),
    one that raises is kept as an error row, and the fastest persists."""
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    (A, B, C), _ = _operands(32, 32, 32, 16)
    prob = D.problem_of(A, B, C)
    cands = S.candidate_plans(prob)
    assert len(cands) >= 2

    def run(plan):
        if plan.path == cands[0].path:
            raise RuntimeError("refused")
        return D.execute_plan(plan, A, B, C)

    plan, rep = S.autotune_problem(prob, run, max_measure=len(cands),
                                   warmup=1, iters=1)
    errors = [r for r in rep["candidates"] if "error" in r]
    assert [r["plan"] for r in errors] == [cands[0].key()]
    assert plan.path != cands[0].path and rep["source"] == "measured"
    timed = [r for r in rep["candidates"] if "measured_us" in r]
    assert rep["measured_us"] == min(r["measured_us"] for r in timed)
    with pytest.raises(RuntimeError):
        S.autotune_problem(prob, lambda p: 1 / 0, force=True)


def test_measure_times_warmup_then_median(monkeypatch):
    """One warmup call, then the median of the timed calls."""
    steps = iter([5.0, 1.0, 3.0, 2.0])
    clock = [0.0]
    calls = []

    def fn():
        calls.append(1)
        clock[0] += next(steps)
        return torch.zeros(2)

    monkeypatch.setattr(S.time, "perf_counter", lambda: clock[0])
    t = S.measure(fn, warmup=1, iters=3)
    assert len(calls) == 4 and t == 2.0      # median of 1, 3, 2


def test_schema1_files_read_as_plans_without_meta(tmp_path):
    """A cache written before per-plan meta (schema 1) is still served;
    saving it rewrites schema 2."""
    dev = DV.DEVICE_TABLE["gpu-h100"]
    prob = CM.GemmProblem(m=4, n=64, k=64, tile=16, op="linear",
                          b_high=0.5, b_k_constant=True, c_classes=(1,),
                          formats="fp8_e4m3+bf16+fp32")
    key = S.plan_key(dev, prob)
    path = tmp_path / "old.json"
    path.write_text(json.dumps({
        "schema": 1, "formats": registry_signatures(),
        "plans": {key: {"path": "ksplit_cuda", "bm": 16, "bn": 16,
                        "bk": 16}}}, indent=1, sort_keys=True))
    cache = S.PlanCache(str(path))
    assert cache.get(key) == CM.GemmPlan("ksplit_cuda", 16, 16, 16)
    assert cache.meta(key) == {} and len(cache) == 1
    assert any("schema" in p for p in validate_cache(str(path)))
    cache.save()
    assert json.loads(path.read_text())["schema"] == S.CACHE_SCHEMA == 2
    assert validate_cache(str(path)) == []


# ---------------------------------------------------------------------------
# the measured linear tuning and the SUMMA autotuner
# ---------------------------------------------------------------------------

def _linear_params():
    from repro_torch.core.linear import init_mp_linear
    g = torch.Generator().manual_seed(0)
    pol = Policy("ratio", 0.5)
    return {"a": init_mp_linear(g, 64, 32, pol, tile=16, device="cpu"),
            "b": [init_mp_linear(g, 64, 32, pol, tile=16, device="cpu"),
                  init_mp_linear(g, 32, 64, pol, tile=16, device="cpu")]}


def test_tune_linear_params_measured(monkeypatch, tmp_path):
    """``measure=True`` times both linear paths and persists the winner
    (source "measured") into the given cache and the registry;
    ``measure=False`` stays the model's pick; cache-only mode never
    measures."""
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    params = _linear_params()
    model = D.tune_linear_params(params, m_hint=4)
    assert {p.path for p in model.values()} == {"ksplit_cuda"}
    D.clear_registry()
    cache = S.PlanCache(str(tmp_path / "measured.json"))
    calls = _spy(monkeypatch)
    plans = D.tune_linear_params(params, m_hint=4, measure=True,
                                 cache=cache, warmup=1, iters=1)
    assert len(plans) == 2 and len(calls) == 2 * len(D.LINEAR_PATHS)
    for key, plan in plans.items():
        assert cache.meta(key)["source"] == "measured"
        assert D._REGISTRY[key] == plan
    assert validate_cache(cache.path) == []
    # cache-only: the measured plans come back from the file, unmeasured
    monkeypatch.setenv(S.CACHE_ONLY_ENV, "1")
    D.clear_registry()
    calls.clear()
    again = D.tune_linear_params(params, m_hint=4, measure=True,
                                 cache=S.PlanCache(cache.path))
    assert calls == []
    assert set(again) == set(plans)


def test_autotune_summa_on_a_grid(tmp_path):
    """``autotune_summa`` on a 1x1 gloo grid measures SUMMA's local
    paths and persists the winner under the distributed key."""
    from repro_torch.core import schedule
    from repro_torch.launch import grid as G
    t, n = 8, 32
    pol = Policy(kind="ratio", ratio_high=0.5)
    maps = (schedule.sorted_balanced_map(n // t, n // t, pol, axis=0,
                                         groups=1),
            schedule.sorted_balanced_map(n // t, n // t, pol, axis=1,
                                         groups=1),
            schedule.balanced_ratio_map(n // t, n // t, pol, 1, 1))
    mats = [PL.MPMatrix.from_dense(torch.from_numpy(d), p, t)
            for d, p in zip(_dense(n, n, n), maps)]
    plan = G.run_on_grid(1, 1, G.call_all,
                         [(D.autotune_summa, mats,
                           {"warmup": 1, "iters": 1})],
                         device="cpu", backend="gloo")[0]
    assert plan.path in D.SUMMA_PATHS
    cache = S.PlanCache(S.cache_path())
    (key,) = cache.keys()
    assert key.split("|")[1] == "summa1x1"
    assert cache.get(key) == plan
    assert cache.meta(key)["source"] == "measured"


# ---------------------------------------------------------------------------
# plan-cache hygiene
# ---------------------------------------------------------------------------

def _tuned_cache(monkeypatch) -> str:
    """A cache written by the port's own search: one autotuned GEMM and
    measured linears."""
    (A, B, C), _ = _operands(32, 32, 32, 8)
    S.autotune(A, B, C, warmup=1, iters=1, max_measure=2)
    D.tune_linear_params(_linear_params(), m_hint=4, measure=True,
                         warmup=1, iters=1)
    return S.cache_path()


def test_hygiene_tuned_cache_is_clean(monkeypatch):
    path = _tuned_cache(monkeypatch)
    assert len(S.PlanCache(path)) == 3     # one GEMM, two linear shapes
    assert validate_cache(path) == []
    from repro_torch.tune import hygiene
    assert hygiene.main([path]) == 0


def test_hygiene_detects_drift(tmp_path, monkeypatch):
    from repro.tune.hygiene import validate_cache as j_validate
    path = _tuned_cache(monkeypatch)
    with open(path) as f:
        payload = json.load(f)

    cases = {}
    # stale v1 key (ratio segment where the format set belongs)
    key = next(iter(payload["plans"]))
    v1_key = "|".join(k for i, k in enumerate(key.split("|")) if i != 4)
    cases["v1"] = {**payload, "plans": {**payload["plans"],
                                        v1_key: payload["plans"][key]}}
    cases["schema"] = {**payload, "schema": 1}
    cases["stamps"] = {k: v for k, v in payload.items() if k != "formats"}
    for word, bad in cases.items():
        p = tmp_path / f"{word}.json"
        p.write_text(json.dumps(bad, indent=1, sort_keys=True))
        mine, theirs = validate_cache(str(p)), j_validate(str(p))
        assert any(word in msg for msg in mine), (word, mine)
        assert any(word in msg for msg in theirs), (word, theirs)
    # non-canonical ordering / formatting
    p = tmp_path / "order.json"
    p.write_text(json.dumps(payload, indent=2, sort_keys=False))
    assert any("canonical" in msg for msg in validate_cache(str(p)))
    assert any("canonical" in msg for msg in j_validate(str(p)))


def test_hygiene_rejects_unregistered_format_keys(tmp_path):
    key = ("cpu|mp_gemm|M64N64K64|t16|bf16+fp99_custom"
           "|50D50S|50D50S|50D50S|a1b1k0p1c1")
    payload = {"schema": 2,
               "formats": {"fp99_custom": "fp99_custom:sig"},
               "plans": {key: {"path": "ref", "bm": 16, "bn": 16,
                               "bk": 16}}}
    p = tmp_path / "unreg.json"
    p.write_text(json.dumps(payload, indent=1, sort_keys=True))
    msgs = validate_cache(str(p))
    assert any("not registered" in m and "fp99_custom" in m for m in msgs)
    # split compound formats ARE registered → no such problem
    ok_key = key.replace("bf16+fp99_custom", "fp16+split2_fp16")
    payload["plans"] = {ok_key: payload["plans"][key]}
    payload["formats"] = {"fp16": "x", "split2_fp16": "y"}
    p2 = tmp_path / "split.json"
    p2.write_text(json.dumps(payload, indent=1, sort_keys=True))
    assert not any("not registered" in m for m in validate_cache(str(p2)))
    # a shelved entry survives the round trip through PlanCache
    payload = {"schema": 2, "formats": {**registry_signatures(),
                                        "fp99_custom": "fp99_custom:sig"},
               "plans": {key: {"path": "ref", "bm": 16, "bn": 16,
                               "bk": 16}}}
    p.write_text(json.dumps(payload, indent=1, sort_keys=True))
    cache = S.PlanCache(str(p))
    assert len(cache) == 0
    out = cache.save_as(str(tmp_path / "rt.json"))
    assert json.loads(open(out.path).read())["plans"] == payload["plans"]


def test_hygiene_writer_emits_canonical_file(tmp_path):
    path = str(tmp_path / "cache.json")
    cache = S.PlanCache(path)
    (A, B, C), _ = _operands(64, 64, 64, 16)
    prob = D.problem_of(*D.canonical_operands(A, B, C))
    key = S.plan_key(S.detect_device(), prob)
    # insertion order deliberately unsorted: z-device first
    cache.put("z" + key, CM.GemmPlan(path="ref", bm=16, bn=16, bk=16))
    cache.put(key, CM.GemmPlan(path="ref", bm=16, bn=16, bk=16),
              source="measured", measured_us=3.5, predicted_us=2.0)
    assert validate_cache(path) == []


def test_hygiene_accepts_int_format_plan_keys(tmp_path):
    sigs = registry_signatures()
    key = ("cpu|mp_gemm|M64N64K64|t16|int8_pt+fp32"
           "|0D100S|0D100S|0D100S|a1b1k1p1c1")
    payload = {"schema": S.CACHE_SCHEMA,
               "formats": {n: sigs[n]
                           for n in ("int8_pt", "int4_pt", "fp32")},
               "plans": {key: {"path": "ksplit_torch", "bm": 16, "bn": 16,
                               "bk": 16}}}
    path = tmp_path / "tune_cache.json"
    path.write_text(json.dumps(payload, indent=1, sort_keys=True))
    assert validate_cache(str(path)) == []

    bad = dict(payload)
    bad["plans"] = {key.replace("int8_pt", "int9_pt"):
                    payload["plans"][key]}
    bad["formats"] = dict(payload["formats"],
                          int9_pt="int9_pt:fake-signature")
    path.write_text(json.dumps(bad, indent=1, sort_keys=True))
    problems = validate_cache(str(path))
    assert problems and any("int9_pt" in p and "not registered" in p
                            for p in problems)
