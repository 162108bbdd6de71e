"""The port's observability (``repro_torch.obs``): metrics registry,
tracer round trip, hygiene, the disabled no-op, and the emission sites
held against the JAX package's on the same inputs.

Twins of ``tests/test_obs.py`` except its engine-stats key test (those
keys count jit traces, which the port has none of) and its two bench
harness tests (the benchmark comes in its own work item).  Parity:

* the same small ``mp_matmul`` traced in both packages emits the same
  ``{(name, cat)}`` set, and the port's result is bitwise equal with
  tracing on and off;
* the same reduced ``graded_spd`` LU solve traced in both emits the same
  ordered ``solve.*`` names, with equal ``sweep``, ``rung`` and
  escalated-tile ``args``;
* a 2x2 gloo SUMMA emits ``summa.panel`` events whose steps and owners
  equal the reference's, once (rank 0's view), into the parent's file
  without truncating it.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as RO
from repro.obs import metrics as JOM
from repro.tune import dispatch as JTD
from repro.tune import search as JTS
from repro_torch import obs
from repro_torch.obs import hygiene as OH
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.obs.metrics import MetricsRegistry, label_key
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as TD
from repro_torch.tune import search as TS


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Both packages' registries, caches and metrics per test; every test
    leaves both tracers disabled."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jplans.json"))
    monkeypatch.setattr(JTD, "_REGISTRY", {})
    monkeypatch.setattr(JTS, "_default_cache", None)
    monkeypatch.setattr(JOM, "_DEFAULT", JOM.MetricsRegistry())
    monkeypatch.setenv(TS.CACHE_ENV, str(tmp_path / "plans.json"))
    monkeypatch.delenv(DV.DEVICE_ENV, raising=False)
    monkeypatch.setattr(TD, "_REGISTRY", {})
    monkeypatch.setattr(TS, "_default_cache", None)
    monkeypatch.setattr(OM, "_DEFAULT", OM.MetricsRegistry())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    obs.configure(enabled=False)
    RO.configure(enabled=False)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_label_key_canonical():
    assert label_key({}) == ""
    assert label_key({"b": "x", "a": 1}) == "a=1,b=x"


def test_counter_labels_are_distinct_series():
    reg = MetricsRegistry()
    reg.counter("dispatch.calls", path="grouped").inc()
    reg.counter("dispatch.calls", path="grouped").inc(2)
    reg.counter("dispatch.calls", path="ref").inc()
    assert reg.value("dispatch.calls", path="grouped") == 3
    assert reg.value("dispatch.calls", path="ref") == 1
    series = {label_key(lab): c.value
              for lab, c in reg.series("dispatch.calls")}
    assert series == {"path=grouped": 3.0, "path=ref": 1.0}


def test_gauge_and_histogram_semantics():
    reg = MetricsRegistry()
    h = reg.histogram("serve.request.latency_s")
    for v in (1.0, 3.0, 2.0):
        h.observe(v)
    assert h.count == 3 and h.sum == 6.0
    assert h.min == 1.0 and h.max == 3.0 and h.mean == 2.0
    assert reg.histogram("serve.request.latency_s").summary()["mean"] == 2.0
    empty = reg.histogram("other")
    assert empty.mean == 0.0
    assert empty.summary() == {"count": 0, "sum": 0.0, "mean": 0.0,
                               "min": 0.0, "max": 0.0}


def test_value_does_not_create_series():
    reg = MetricsRegistry()
    assert reg.value("nope", default=-1.0, path="x") == -1.0
    assert reg.names() == []


def test_kind_conflict_raises():
    for reg in (MetricsRegistry(), JOM.MetricsRegistry()):
        reg.counter("m")
        with pytest.raises(TypeError):
            reg.histogram("m")


def test_snapshot_and_reset():
    """The port's snapshot is the reference's, field for field."""
    snaps = []
    for reg in (MetricsRegistry(), JOM.MetricsRegistry()):
        reg.counter("a", k="1").inc()
        reg.histogram("b").observe(2.0)
        snaps.append(reg.snapshot())
        reg.reset("a")
        assert reg.value("a", default=0.0, k="1") == 0.0
        assert reg.names() == ["b"]
        reg.reset()
        assert reg.names() == []
    snap = snaps[0]
    assert snap["a"] == [{"labels": {"k": "1"}, "value": 1.0}]
    assert snap["b"][0]["value"]["count"] == 1
    json.dumps(snap)                      # plain JSON-able data
    assert snap == snaps[1]


# ---------------------------------------------------------------------------
# tracer: emit -> JSONL -> parse -> chrome export
# ---------------------------------------------------------------------------

def test_tracer_roundtrip_and_chrome_export(tmp_path):
    p = str(tmp_path / "trace.jsonl")
    obs.configure(enabled=True, trace_path=p)
    assert obs.is_enabled()
    with obs.span("solve.run", "solve", method="lu"):
        with obs.span("gemm.dispatch", "gemm", path="ref"):
            pass
        obs.event("plan.resolve", "plan", source="cache")
    obs.configure(enabled=False)          # closes + flushes the file
    assert not obs.is_enabled()

    events = OT.read_events(p)
    assert OH.validate_events(events) == []
    assert OT.span_types(events) == ["gemm.dispatch", "solve.run"]
    phases = sorted(e["ph"] for e in events)
    assert phases == ["X", "X", "i"]
    spans = {e["name"]: e for e in events if e["ph"] == "X"}
    parent, child = spans["solve.run"], spans["gemm.dispatch"]
    assert parent["ts"] <= child["ts"]
    assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 1
    # the schema is the reference's, key for key
    ref = RO.trace.Tracer()
    with ref.span("solve.run", "solve", method="lu"):
        ref.event("plan.resolve", "plan", source="cache")
    for mine in events:
        theirs = next(e for e in ref.buffer if e["ph"] == mine["ph"])
        assert set(mine) == set(theirs)

    chrome = OT.export_chrome(p)
    assert chrome.endswith(".trace.json")
    payload = json.load(open(chrome))
    assert payload["traceEvents"] == events
    assert OT.main([p, "--chrome", str(tmp_path / "x.json")]) == 0


def test_tracer_in_memory_buffer():
    tr = OT.Tracer()
    with tr.span("serve.microbatch", "serve", n_real=2):
        tr.event("serve.admit", "serve", bucket="S16/default")
    assert [e["name"] for e in tr.buffer] == ["serve.admit",
                                              "serve.microbatch"]
    assert OH.validate_events(tr.buffer) == []


def test_bad_category_rejected_at_emit():
    tr = OT.Tracer()
    with pytest.raises(ValueError):
        tr.event("x", "not-a-category")
    with pytest.raises(ValueError):
        tr.span("x", "not-a-category")
    assert set(OT.CATEGORIES) == set(RO.trace.CATEGORIES) | {"model"}
    assert OT.PHASES == RO.trace.PHASES
    assert OT.REQUIRED_FIELDS == RO.trace.REQUIRED_FIELDS


# ---------------------------------------------------------------------------
# disabled mode: strict no-op
# ---------------------------------------------------------------------------

def test_disabled_is_noop(tmp_path):
    obs.configure(enabled=False)
    with obs.span("gemm.dispatch", "gemm", path="ref"):
        obs.event("plan.resolve", "plan")
    assert obs.tracer() is OT.NULL_TRACER
    assert list(tmp_path.iterdir()) == []   # nothing written anywhere


def _tiny_operands(n=32, t=16):
    """The same numpy values and map for both packages."""
    from repro.core import MPMatrix as JMP
    from repro_torch.core import MPMatrix, make_map
    from repro_torch.core.precision import Policy
    a = np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)
    pa = make_map((n, n), t, Policy(kind="ratio", ratio_high=0.5))
    port = (MPMatrix.from_dense(torch.from_numpy(a), pa, t),
            MPMatrix.from_dense(torch.zeros((n, n)), pa, t))
    ref = (JMP.from_dense(jnp.asarray(a), pa, t),
           JMP.from_dense(jnp.zeros((n, n)), pa, t))
    return port, ref


def test_dispatch_bitwise_identical_with_tracing(tmp_path):
    """The port's mp_matmul gives the same bits traced and untraced, and
    emits the same (name, cat) set as the reference's on the same
    operands."""
    (A, C), (JA, JC) = _tiny_operands()
    obs.configure(enabled=False)
    base = TD.mp_matmul(A, A, C).to_dense()
    p = str(tmp_path / "t.jsonl")
    obs.configure(enabled=True, trace_path=p)
    TD.clear_registry()
    traced = TD.mp_matmul(A, A, C).to_dense()
    obs.configure(enabled=False)
    assert torch.equal(base, traced)
    mine = {(e["name"], e["cat"]) for e in OT.read_events(p)}
    assert ("gemm.dispatch", "gemm") in mine

    RO.configure(enabled=True)
    JTD.mp_matmul(JA, JA, JC)
    theirs = {(e["name"], e["cat"]) for e in RO.tracer().buffer}
    RO.configure(enabled=False)
    assert mine == theirs == {("gemm.dispatch", "gemm"),
                              ("plan.resolve", "plan")}


# ---------------------------------------------------------------------------
# dispatch resolution counters: registry-backed, compat API intact
# ---------------------------------------------------------------------------

def test_resolution_counters_compat():
    TD.reset_resolution_counters()
    assert TD.resolution_counters() == {}
    assert TD.fresh_resolutions() == 0
    (A, C), _ = _tiny_operands()
    TD.mp_matmul(A, A, C)
    c = TD.resolution_counters()
    assert sum(c.values()) >= 1
    assert set(c) <= {"registry", "cache", "model", "default",
                      "summa_registry", "summa_cache", "summa_model",
                      "summa_default"}
    reg = obs.metrics_registry()
    for src, n in c.items():
        assert reg.value(TD.RESOLUTION_METRIC, source=src) == n
    TD.reset_resolution_counters()
    assert TD.resolution_counters() == {}


# ---------------------------------------------------------------------------
# hygiene validator: negatives
# ---------------------------------------------------------------------------

def test_hygiene_rejects_schema_drift(tmp_path):
    from repro.obs import hygiene as RH
    ok = {"name": "s", "cat": "serve", "ph": "X", "ts": 1.0, "dur": 2.0,
          "pid": 1, "tid": 1}
    assert OH.validate_events([ok]) == []
    bad_cat = dict(ok, cat="rogue")
    bad_phase = dict(ok, ph="B")
    no_dur = {k: v for k, v in ok.items() if k != "dur"}
    missing = {"name": "s", "ph": "i"}
    bad_args = dict(ok, args=[1, 2])
    for ev in (bad_cat, bad_phase, no_dur, missing, bad_args):
        assert OH.validate_events([ev]), ev
        # the reference's messages, naming the port's taxonomy (its own
        # plus the "model" category)
        assert OH.validate_events([ev]) == [
            m.replace(str(RO.trace.CATEGORIES), str(OT.CATEGORIES))
            for m in RH.validate_events([ev])]
    p = tmp_path / "t.jsonl"
    p.write_text(json.dumps(ok) + "\n")
    assert OH.validate_trace(str(p)) == []
    assert OH.validate_trace(str(p), min_span_types=2)  # only 1 span type
    assert OH.main([str(p), "--min-span-types", "2"]) == 1
    assert OH.main([str(p)]) == 0
    p.write_text("not json\n")
    assert OH.validate_trace(str(p))
    assert OH.validate_trace(str(tmp_path / "absent.jsonl"))


# ---------------------------------------------------------------------------
# the solver: report records and traced decisions against the reference
# ---------------------------------------------------------------------------

def test_solve_report_sweep_and_promotion_stats():
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    a = graded_spd(64, cond=1e4, seed=0)
    _, b = rhs_for_solution(a, nrhs=1, seed=1)
    rep = solve(a, b, SolveConfig(tile=16, ratio_high=0.0, ratio_low8=0.2,
                                  max_sweeps=20), device="cpu")
    assert len(rep.sweep_seconds) == rep.sweeps
    assert all(s >= 0.0 for s in rep.sweep_seconds)
    assert len(rep.promotions) == rep.escalations
    for p in rep.promotions:
        assert p["tiles"] >= 1
        assert len(p["coords"]) == min(p["tiles"], 128)
        assert all(len(c) == 2 for c in p["coords"])
        assert {"escalation", "mode", "rung", "ratio"} <= set(p)
    json.dumps(rep.promotions)


def _solve_names(events):
    return [e for e in events if e["name"].startswith("solve.")]


def test_traced_solve_matches_reference(tmp_path, monkeypatch):
    """The same LU solve traced in both packages (the storage escalation
    at n = 128, tile 16 of ``test_torch_solve``): the same ordered
    ``solve.*`` events, equal sweep, rung and escalated-tile args (the
    port's escalate events carry the coordinates the reference's report
    records), the same report as the untraced run, and a clean trace."""
    from repro.solve import SolveConfig as JCfg, solve as jsolve
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    a = graded_spd(128, cond=1e4, rho=0.9, seed=0)
    _, b = rhs_for_solution(a, seed=1)
    kw = dict(tile=16, ratio_high=0.0, max_sweeps=30)
    plain = solve(a, b, SolveConfig(**kw), device="cpu")
    TD.clear_registry()
    p = str(tmp_path / "solve.jsonl")
    obs.configure(enabled=True, trace_path=p)
    pr = solve(a, b, SolveConfig(**kw), device="cpu")
    obs.configure(enabled=False)
    assert (pr.sweeps, pr.escalations, pr.ratio_history, pr.metric) == (
        plain.sweeps, plain.escalations, plain.ratio_history, plain.metric)
    np.testing.assert_array_equal(pr.x, plain.x)
    assert OH.validate_trace(p, min_span_types=4) == []

    RO.configure(enabled=True)
    jr = jsolve(a, b, JCfg(**kw))
    theirs = _solve_names(RO.tracer().buffer)
    RO.configure(enabled=False)
    mine = _solve_names(OT.read_events(p))
    assert [e["name"] for e in mine] == [e["name"] for e in theirs]
    assert {"solve.run", "solve.factor", "solve.sweep",
            "solve.escalate"} <= {e["name"] for e in mine}
    for m, t in zip(mine, theirs):
        for key in ("sweep", "rung", "escalation", "mode", "tiles",
                    "ratio", "factorization", "method"):
            assert m["args"].get(key) == t["args"].get(key), (m, t)
    esc = [e["args"] for e in mine if e["name"] == "solve.escalate"]
    assert [e["coords"] for e in esc] == [q["coords"]
                                          for q in jr.promotions]


# ---------------------------------------------------------------------------
# SUMMA: rank 0's panel events, merged into the parent's trace
# ---------------------------------------------------------------------------

def test_summa_panel_events_match_reference(host_grid_devices, tmp_path,
                                            monkeypatch):
    from repro.core import MPMatrix as JMP
    from repro.core import format_set as j_format_set
    from repro.core.summa import summa_mp_gemm as j_summa
    from repro_torch.core import schedule
    from repro_torch.core.formats import DEFAULT_FORMATS
    from repro_torch.core.layout import MPMatrix
    from repro_torch.core.precision import Policy
    from repro_torch.core.summa import summa_with_stats
    from repro_torch.launch import grid as G
    n, t, P, Q = 64, 8, 2, 2
    fs = DEFAULT_FORMATS
    pol = Policy(kind="ratio", ratio_high=0.5, ratio_low8=0.25)
    mt = n // t
    maps = (schedule.sorted_balanced_map(mt, mt, pol, axis=0, groups=P,
                                         fset=fs),
            schedule.sorted_balanced_map(mt, mt, pol, axis=1, groups=Q,
                                         fset=fs),
            schedule.balanced_ratio_map(mt, mt, pol, P, Q, fset=fs))
    rng = np.random.default_rng(0)
    dense = [rng.standard_normal((n, n)).astype(np.float32)
             for _ in range(3)]
    mats = [MPMatrix.from_dense(torch.from_numpy(d), m, t, fs)
            for d, m in zip(dense, maps)]
    path = str(tmp_path / "summa.jsonl")
    # a rank that inherited the variable would reopen (truncate) the file
    monkeypatch.setenv(obs.TRACE_ENV, path)
    obs.configure(enabled=True, trace_path=path)
    obs.event("serve.admit", "serve", marker=1)
    G.run_on_grid(P, Q, G.call_all, [(summa_with_stats, mats, {})],
                  device="cpu", backend="gloo")
    obs.configure(enabled=False)
    events = OT.read_events(path)
    assert events[0]["args"] == {"marker": 1}
    assert OH.validate_events(events) == []
    gemms = [e for e in events if e["name"] == "summa.gemm"]
    assert len(gemms) == 1 and gemms[0]["pid"] != events[0]["pid"]
    assert events[-1]["ts"] >= events[0]["ts"]     # the parent's timeline
    mine = [e["args"] for e in events if e["name"] == "summa.panel"]

    jfs = j_format_set(*fs.names)
    JA, JB, JC = [JMP.from_dense(jnp.asarray(d), m, t, jfs)
                  for d, m in zip(dense, maps)]
    RO.configure(enabled=True)
    j_summa(JA, JB, JC, mesh=jax.make_mesh((P, Q), ("row", "col")))
    theirs = [e["args"] for e in RO.tracer().buffer
              if e["name"] == "summa.panel"]
    RO.configure(enabled=False)
    assert mine == theirs and len(mine) == n // t
