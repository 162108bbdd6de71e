"""The port's multi-replica cluster (``repro_torch.serve.cluster``):
config validation, routing, backpressure, tokens against one engine,
stall re-routing and long prompts — twins of
``tests/test_serve_cluster.py`` on the port's reduced Llama-3-8B — and
the reference's ``Cluster`` placing the same submission sequence the
same way.

Tolerance: tokens are compared exactly (every replica has the same
weights and ``rng_seed``; a request's tokens do not depend on its
replica or its batch).
"""
import numpy as np
import pytest
import torch

from repro.obs import metrics as JM
from repro.tune import dispatch as JD
from repro.tune import search as JS
from repro_torch import obs
from repro_torch.configs import get, reduced
from repro_torch.models import transformer as PT
from repro_torch.obs import metrics as PM
from repro_torch.serve import Cluster, Engine, Request, ServeConfig
from repro_torch.serve.scheduler import QueueFullError
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setattr(JD, "_REGISTRY", {})
    monkeypatch.setattr(JS, "_default_cache", None)
    monkeypatch.setattr(JM, "_DEFAULT", JM.MetricsRegistry())
    monkeypatch.setenv(PS.CACHE_ENV, str(tmp_path / "torch.json"))
    monkeypatch.delenv(DV.DEVICE_ENV, raising=False)
    monkeypatch.setattr(PD, "_REGISTRY", {})
    monkeypatch.setattr(PS, "_default_cache", None)
    monkeypatch.setattr(PM, "_DEFAULT", PM.MetricsRegistry())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    obs.configure(enabled=False)


def _model(arch="llama3-8b"):
    cfg = reduced(get(arch), tp=2)
    return cfg, PT.init_model(torch.Generator().manual_seed(0), cfg)


def _reqs(prompts, max_new=2, seeds=None):
    return [Request(np.asarray(p, np.int64), max_new_tokens=max_new,
                    seed=(seeds[i] if seeds else 0))
            for i, p in enumerate(prompts)]


PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 2, 2], [5, 1], [9, 9, 9]]


# ---------------------------------------------------------------------------
# ServeConfig validation (host-side, no torch work)
# ---------------------------------------------------------------------------

def test_serve_config_validation():
    sc = ServeConfig(buckets=(16, 8, 8))
    assert sc.buckets == (8, 16)                 # sorted, deduped
    assert sc.pad_lens() == (8, 16)
    assert sc.pad_lens(None) == (8, 16)
    assert ServeConfig().pad_lens((4,)) == (4,)  # arch fallback
    assert (ServeConfig().replicas, ServeConfig().affinity,
            ServeConfig().stall_timeout_s) == (1, True, 10.0)
    for bad in (dict(replicas=0), dict(max_batch=0), dict(max_seq=1),
                dict(waste_cap=1.5), dict(stall_timeout_s=0.0),
                dict(prefix_pages=0), dict(page_tokens=0)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)
    with pytest.raises(Exception):
        sc.replicas = 4                          # frozen


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _route_only(cl, reqs):
    """Submit without draining; returns the placement sequence."""
    return [cl.submit(r) for r in reqs]


def test_routing_is_deterministic_and_load_aware():
    cfg, params = _model()
    sc = ServeConfig(buckets=(4,), max_batch=2, max_seq=32, replicas=2)
    placements = []
    for _ in range(2):
        cl = Cluster(cfg, params, sc)
        placements.append(_route_only(cl, _reqs(PROMPTS)))
    assert placements[0] == placements[1]
    assert set(placements[0]) == {0, 1}
    cl = Cluster(cfg, params, sc)
    for r in _reqs(PROMPTS):
        rid = cl.submit(r)
        assert r.replica == rid
    # replicas share the caller's tensors: nothing is copied per replica
    assert all(e.params is params for e in cl.replicas)


def test_affinity_keeps_equal_load_sticky():
    cfg, params = _model()
    cl = Cluster(cfg, params, ServeConfig(buckets=(4, 8), max_batch=2,
                                          max_seq=32, replicas=2))
    a = _reqs([[1, 2, 3], [3, 2, 1]], max_new=1)
    first = cl.submit(a[0])
    assert cl.submit(a[1]) == first
    b = Request(np.asarray([5] * 7, np.int64), max_new_tokens=1)
    assert cl.submit(b) != first


def test_cluster_queue_backpressure():
    cfg, params = _model()
    cl = Cluster(cfg, params, ServeConfig(buckets=(4,), max_batch=2,
                                          max_seq=32, max_queue=2,
                                          replicas=2))
    for r in _reqs([[1, 2]] * 4, max_new=1):
        cl.submit(r)                             # 2 per replica = cap
    with pytest.raises(QueueFullError):
        cl.submit(Request(np.asarray([1], np.int64), max_new_tokens=1))


# ---------------------------------------------------------------------------
# end-to-end: parity, stall re-route, long prompts
# ---------------------------------------------------------------------------

def test_cluster_serves_bit_exact_with_zero_recompiles():
    cfg, params = _model()
    sc = ServeConfig(buckets=(4,), max_batch=2, max_seq=32, replicas=2)
    cl = Cluster(cfg, params, sc)
    cl.warmup()
    reqs = _reqs(PROMPTS, max_new=3, seeds=list(range(6)))
    cl.generate(reqs)
    refs = cl.replicas[0].generate_reference(
        _reqs(PROMPTS, max_new=3, seeds=list(range(6))))
    for r, ref in zip(reqs, refs):
        assert r.done and r.error == ""
        assert r.out_tokens == ref.out_tokens
    st = cl.stats()
    assert st["requests"]["served"] == len(PROMPTS)
    assert st["post_warmup_fresh_resolutions"] == 0
    assert st["healthy"] == 2
    assert all(p["requests"]["served"] >= 1 for p in st["per_replica"])
    assert st["decode_steps"] == sum(p["decode_steps"]
                                     for p in st["per_replica"]) > 0


def test_stalled_replica_work_is_rerouted():
    cfg, params = _model()
    cl = Cluster(cfg, params, ServeConfig(buckets=(4,), max_batch=2,
                                          max_seq=32, replicas=2,
                                          stall_timeout_s=2.0))
    cl.warmup()
    reqs = _reqs(PROMPTS, max_new=2)
    for r in reqs:
        cl.submit(r)
    dead = next(rid for rid in (0, 1)
                if cl.replicas[rid].scheduler.pending())
    cl.replicas[dead].run = lambda: (_ for _ in ()).throw(
        RuntimeError("injected replica crash"))
    obs.configure(enabled=True)
    cl.run()
    names = [e["name"] for e in obs.tracer().buffer]
    obs.configure(enabled=False)
    live = 1 - dead
    assert cl.stats()["healthy"] == 1
    assert "serve.replica_stall" in names and "serve.reroute" in names
    refs = cl.replicas[live].generate_reference(_reqs(PROMPTS, max_new=2))
    for r, ref in zip(reqs, refs):
        assert r.done and r.error == ""          # nobody stranded
        assert r.out_tokens == ref.out_tokens
        assert r.replica == live                 # all re-routed
    assert cl.replicas[live].stats()["requests"]["served"] == len(PROMPTS)


def test_long_prompt_chunked_prefill_through_cluster():
    cfg, params = _model()
    cl = Cluster(cfg, params, ServeConfig(buckets=(4, 8), max_batch=2,
                                          max_seq=32, replicas=2))
    cl.warmup()
    long_prompt = list(range(1, 12))             # L=11 > max bucket 8
    prompts = [long_prompt, [7] * 10, [1, 2, 3], [4, 5]]
    reqs = _reqs(prompts, max_new=3)
    cl.generate(reqs)
    refs = cl.replicas[0].generate_reference(_reqs(prompts, max_new=3))
    for r, ref in zip(reqs, refs):
        assert r.done and r.out_tokens == ref.out_tokens
    assert reqs[0].bucket == "S16/default" and reqs[0].cold is False
    st = cl.stats()
    assert st["post_warmup_fresh_resolutions"] == 0
    assert sum(p["chunked_prefills"] for p in st["per_replica"]) >= 1


def test_placement_matches_reference_and_tokens_match_one_engine():
    """The reference's Cluster and the port's place the same submission
    sequence (mixed lengths, budgets and two format tags' worth of
    buckets) on the same replicas; the port's cluster then serves every
    request with the tokens its single Engine gives, sampled ones too."""
    from repro.configs import load_all, reduced as jreduced
    from repro.models import transformer as JT
    from repro.serve import Cluster as JCluster
    from repro.serve.engine import Request as JRequest
    import jax
    cfg, params = _model()
    jcfg = jreduced(load_all()["llama3-8b"], tp=2)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    sc = dict(buckets=(4, 8), max_batch=2, max_seq=32, replicas=2)
    rng = np.random.default_rng(3)
    lens = [3, 7, 2, 8, 5, 4, 6, 1, 8, 3]
    news = [2, 1, 3, 2, 1, 3, 2, 2, 1, 3]
    prompts = [rng.integers(0, cfg.vocab, L) for L in lens]
    from repro.serve import ServeConfig as JServeConfig
    jcl = JCluster(jcfg, jparams, JServeConfig(**sc))
    want = [jcl.submit(JRequest(np.asarray(p, np.int32), max_new_tokens=k))
            for p, k in zip(prompts, news)]
    cl = Cluster(cfg, params, ServeConfig(**sc))
    temps = [0.0, 0.8] * 5
    reqs = [Request(np.asarray(p, np.int64), max_new_tokens=k,
                    temperature=t, seed=i)
            for i, (p, k, t) in enumerate(zip(prompts, news, temps))]
    assert [cl.submit(r) for r in reqs] == want
    assert set(want) == {0, 1}
    cl.run()
    eng = Engine(cfg, params, ServeConfig(**{**sc, "replicas": 1}))
    alone = [Request(np.asarray(p, np.int64), max_new_tokens=k,
                     temperature=t, seed=i)
             for i, (p, k, t) in enumerate(zip(prompts, news, temps))]
    eng.generate(alone)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in alone]


def test_long_prefill_is_not_a_stall(monkeypatch):
    """A prefill that outlasts ``stall_timeout_s`` while every model step
    stays well inside it (a slowed ``forward_decode``) beats through
    ``serve.prefill_steps``: both replicas stay healthy and serve the
    single engine's tokens."""
    import time
    cfg, params = _model()
    sc = dict(buckets=(16,), max_batch=2, max_seq=32, replicas=2,
              stall_timeout_s=1.0, affinity=False, refill=False,
              prefix_cache=False)
    prompts = [list(range(1, 17)), list(range(2, 18))]
    eng = Engine(cfg, params, ServeConfig(**{**sc, "replicas": 1}))
    alone = eng.generate(_reqs(prompts, max_new=2))
    cl = Cluster(cfg, params, ServeConfig(**sc))
    cl.warmup()
    real = PT.forward_decode

    def slow(*a, **kw):
        time.sleep(0.1)                          # 16 positions: 1.6 s
        return real(*a, **kw)

    monkeypatch.setattr(PT, "forward_decode", slow)
    reqs = _reqs(prompts, max_new=2)
    for r in reqs:
        cl.submit(r)
    assert sorted(r.replica for r in reqs) == [0, 1]
    t0 = time.perf_counter()
    cl.run()
    assert time.perf_counter() - t0 > sc["stall_timeout_s"]
    assert cl.stats()["healthy"] == 2
    for r, a in zip(reqs, alone):
        assert r.done and r.error == ""
        assert r.out_tokens == a.out_tokens
    assert all(e.stats()["prefill_steps"] == 16 for e in cl.replicas)
