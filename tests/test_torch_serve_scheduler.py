"""Twins of ``tests/test_serve_scheduler.py`` for the port's serve stack.

* Host-only scheduler decisions: each test drives the reference's and the
  port's ``ShapeBucketScheduler`` through the same sequence and asserts
  equal keys, evictions and counters (and the reference test's values).
* Engine batteries of masked mode on reduced InternLM2 (refill, paged
  prefix reuse, chunked prefill, sampling): batched tokens equal
  ``generate_reference`` bit for bit and the counters count as the
  reference's do.
* Parity: the JAX ``Engine`` and the port's, both with the reference's
  defaults, on the same weights and a stream that triggers refill, prefix
  reuse and chunked prefill — equal greedy tokens and host decisions.
* The sampler's distribution, and a request's stream independent of its
  row and batch.

Equal mode (the MoE and local/global families) is tested in
``tests/test_torch_serve_equal.py``; the mixed-format stream is served in
``tests/test_torch_quant.py``.
"""
import numpy as np
import pytest
import torch

from repro.obs import metrics as JM
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import scheduler as JSch
from repro.tune import dispatch as JD
from repro.tune import search as JS
from repro_torch.configs import get, reduced
from repro_torch.models import transformer as PT
from repro_torch.obs import metrics as PM
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve import scheduler as PSch
from repro_torch.serve.engine import sample_tokens, stream_seed
from repro_torch.serve.scheduler import AdmissionError, BucketKey
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS
from test_torch_models import LOGIT_TOL_COMPILED, reduced_pair


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


# ---------------------------------------------------------------------------
# host-only scheduler decisions, reference and port side by side
# ---------------------------------------------------------------------------

def _both(mode="masked", **kw):
    """(reference scheduler, port scheduler) under the same config."""
    defaults = dict(pad_lens=(8, 16, 32), waste_cap=0.5, max_batch=4,
                    max_queue=8, max_dynamic=2)
    defaults.update(kw)
    return [mod.ShapeBucketScheduler(mod.SchedulerConfig(**defaults),
                                     mode=mode)
            for mod in (JSch, PSch)]


def _key(k):
    return (k.pad_len, k.fset)


def _counters(s):
    return (s.rejected, s.waste_redirects, s.evictions, s.pending(),
            sorted((_key(k), b.configured, b.warmed)
                   for k, b in s.buckets.items()),
            s.totals())


def _same(run, **kw):
    """Run ``run(sched, mod)`` on both schedulers; the returned decision
    records and the counters must be equal.  Returns the port's record."""
    out = []
    for s, mod in zip(_both(**kw), (JSch, PSch)):
        out.append((run(s, mod), _counters(s)))
    assert out[0] == out[1]
    return out[1][0]


def _try(fn):
    try:
        return ("ok", fn())
    except (JSch.AdmissionError, PSch.AdmissionError):
        return ("AdmissionError",)
    except (JSch.QueueFullError, PSch.QueueFullError):
        return ("QueueFullError",)


def _mb(s):
    mb = s.next_microbatch()
    return None if mb is None else (_key(mb[0].key), list(mb[1]))


def test_best_fit_bucket_selection():
    rec = _same(lambda s, mod: [_key(s.bucket_for(L, "default"))
                                for L in (8, 5, 9, 32)])
    assert rec == [(8, "default"), (8, "default"), (16, "default"),
                   (32, "default")]


def test_waste_cap_rejects_warm_bucket():
    def run(s, mod):
        k3 = s.bucket_for(3, "default")      # waste 5/8 > 0.5 → exact
        r1 = (s.waste_redirects, s.buckets[k3].configured)
        k4 = s.bucket_for(4, "default")      # waste 4/8 ≤ cap → warm
        return _key(k3), r1, _key(k4), s.waste_redirects
    assert _same(run) == ((3, "default"), (1, False), (8, "default"), 1)


def test_admission_rejects_oversized_and_unknown_fset():
    def run(s, mod):
        out = [_try(lambda: s.bucket_for(L, f))
               for L, f in ((33, "default"), (0, "default"), (4, "nope"))]
        out.append(_try(lambda: s.admit(object(), 33, "default")))
        return out, s.rejected
    out, rejected = _same(run)
    assert out == [("AdmissionError",)] * 4 and rejected == 1


def test_queue_overflow_backpressure():
    def run(s, mod):
        out = [_try(lambda i=i: _key(s.admit(f"r{i}", 8, "default")))
               for i in range(4)]
        out.append(_mb(s))
        out.append(_try(lambda: _key(s.admit("r4", 8, "default"))))
        return out
    rec = _same(run, max_queue=3)
    assert rec[3] == ("QueueFullError",)
    assert rec[4] == ((8, "default"), ["r0", "r1", "r2"])
    assert rec[5] == ("ok", (8, "default"))


def test_dynamic_bucket_lru_eviction():
    def run(s, mod):
        k1 = s.bucket_for(1, "default")
        k2 = s.bucket_for(2, "default")
        e0 = s.evictions
        s.bucket_for(1, "default")           # touch k1 → k2 becomes LRU
        k3 = s.bucket_for(3, "default")      # evicts k2
        e1 = s.evictions
        alive = (k2 in s.buckets, k1 in s.buckets, k3 in s.buckets)
        k2b = s.bucket_for(2, "default")     # recreated cold
        return e0, e1, alive, _key(k2b), s.buckets[k2b].warmed
    assert _same(run, max_dynamic=2) == (0, 1, (False, True, True),
                                          (2, "default"), False)


def test_eviction_spares_busy_buckets():
    def run(s, mod):
        k1 = s.bucket_for(1, "default")
        s.admit("r", 1, "default")           # k1 has pending work
        k2 = s.bucket_for(2, "default")      # would evict k1: busy
        return k1 in s.buckets, k2 in s.buckets, s.evictions
    assert _same(run, max_dynamic=1) == (True, True, 0)


def test_fifo_fair_microbatch_formation():
    def run(s, mod):
        for r, L in (("a1", 8), ("b1", 16), ("a2", 8), ("a3", 8)):
            s.admit(r, L, "default")
        return [_mb(s) for _ in range(4)], s.pending()
    rec, pending = _same(run, max_batch=2)
    assert rec == [((8, "default"), ["a1", "a2"]),
                   ((16, "default"), ["b1"]),
                   ((8, "default"), ["a3"]), None]
    assert pending == 0


def test_equal_mode_buckets_are_exact_length():
    def run(s, mod):
        k8 = s.bucket_for(8, "default")
        k5 = s.bucket_for(5, "default")
        return (_key(k8), s.buckets[k8].configured, _key(k5),
                s.buckets[k5].configured)
    assert _same(run, mode="equal", pad_lens=(8, 16)) == (
        (8, "default"), True, (5, "default"), False)


def test_duplicate_admission_rejected():
    def run(s, mod):
        r = "req"
        out = [_try(lambda: _key(s.admit(r, 8, "default"))),
               _try(lambda: _key(s.admit(r, 8, "default"))),
               _mb(s), _mb(s),
               _try(lambda: _key(s.admit(r, 8, "default")))]
        return out
    rec = _same(run)
    assert rec[1] == ("AdmissionError",)
    assert rec[2] == ((8, "default"), ["req"]) and rec[3] is None
    assert rec[4] == ("ok", (8, "default"))


def test_eviction_folds_counters_into_totals():
    def run(s, mod):
        k1 = s.bucket_for(1, "default")
        b1 = s.buckets[k1]
        b1.misses, b1.served, b1.real_tokens, b1.padded_tokens = 1, 2, 5, 0
        s.bucket_for(2, "default")         # evicts k1
        return s.evictions, s.totals(), s.stats()["evicted_totals"]
    ev, totals, evicted = _same(run, max_dynamic=1)
    assert ev == 1
    assert (totals["misses"], totals["served"], totals["real_tokens"]) \
        == (1, 2, 5)
    assert evicted["served"] == 2


def test_pop_pending_and_drain_pending():
    """The refill hook pulls a bucket's oldest pending request out of
    turn; the drain hook takes back every undrained request, oldest
    first; both leave the FIFO bookkeeping consistent."""
    def run(s, mod):
        for r, L in (("a1", 8), ("b1", 16), ("a2", 8), ("b2", 16),
                     ("a3", 8)):
            s.admit(r, L, "default")
        k8 = BucketKey(8, "default") if mod is PSch \
            else JSch.BucketKey(8, "default")
        out = [s.pop_pending(k8), s.pending(), _mb(s)]
        out.append(s.drain_pending())
        out += [s.pending(), _mb(s), s.pop_pending(k8)]
        s.admit("a1", 8, "default")         # drained ids re-admissible
        out.append(_mb(s))
        return out
    rec = _same(run, max_batch=2)
    assert rec == ["a1", 4, ((16, "default"), ["b1", "b2"]),
                   ["a2", "a3"], 0, None, None, ((8, "default"), ["a1"])]


def test_engine_filters_buckets_that_cannot_fit_max_seq():
    jcfg, jp, pcfg, pp = reduced_pair()
    kw = dict(max_batch=2, max_seq=16, buckets=(4, 8, 16, 128))
    jeng = JEngine(jcfg, jp, JServeConfig(**kw))
    eng = Engine(pcfg, pp, ServeConfig(**kw))
    assert sorted(k.pad_len for k in eng.scheduler.buckets) == \
        sorted(k.pad_len for k in jeng.scheduler.buckets) == [4, 8]
    eng.warmup()          # must not raise
    with pytest.raises(ValueError):
        Engine(pcfg, pp, ServeConfig(max_batch=2, max_seq=4,
                                     buckets=(16, 32)))


# ---------------------------------------------------------------------------
# engine batteries (port, reduced InternLM2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = reduced(get("internlm2-1.8b"))
    return cfg, PT.init_model(torch.Generator().manual_seed(0), cfg)


def _engine(model, **kw):
    cfg, params = model
    return Engine(cfg, params, ServeConfig(**kw))


def _reqs(prompts, max_new=3, **kw):
    return [Request(np.asarray(p, np.int64), max_new_tokens=max_new, **kw)
            for p in prompts]


def _exact(reqs, refs, n=None):
    for i, (r, ref) in enumerate(zip(reqs, refs)):
        assert r.done and r.error == "", i
        if n is not None:
            assert len(r.out_tokens) == n[i]
        assert r.out_tokens == ref.out_tokens, i


PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 2, 2]]


def test_warmed_mixed_shape_stream_exact_and_no_fresh_resolutions(model):
    eng = _engine(model, max_batch=3, max_seq=32, buckets=(4,),
                  waste_cap=0.75)
    assert eng.mode == "masked"
    eng.warmup()
    reqs = _reqs(PROMPTS)
    eng.generate(reqs)
    _exact(reqs, eng.generate_reference(_reqs(PROMPTS)), [3] * 4)
    st = eng.stats()
    assert st["plans"]["post_warmup_fresh_resolutions"] == 0
    assert st["microbatches"]["multi_request"] >= 1
    assert st["bucket_misses"] == 0 and st["bucket_hits"] >= 1


def test_cold_bucket_fallback_records_miss_not_crash(model):
    eng = _engine(model, max_batch=2, max_seq=32, buckets=(4, 8),
                  waste_cap=0.5)
    eng.warmup([BucketKey(4, "default")])   # bucket 8 deliberately skipped
    prompts = [[1, 2, 3, 4], [9, 8, 7, 6, 5]]
    reqs = _reqs(prompts)
    eng.generate(reqs)
    _exact(reqs, eng.generate_reference(_reqs(prompts)))
    assert reqs[0].cold is False and reqs[1].cold is True
    st = eng.stats()
    assert st["bucket_misses"] == 1
    # the port has no compile: bucket 8 shares bucket 4's plans
    assert st["plans"]["post_warmup_fresh_resolutions"] == 0
    more = _reqs([[3, 3, 3, 3, 3]])
    eng.generate(more)
    assert eng.stats()["bucket_misses"] == 1
    assert more[0].cold is False


def test_engine_rejects_unservable_requests(model):
    eng = _engine(model, max_batch=2, max_seq=16, buckets=(4, 8))
    with pytest.raises(AdmissionError):
        eng.submit(Request(np.arange(12)))          # 12 + 16 - 1 > 16
    with pytest.raises(AdmissionError):
        eng.submit(Request(np.ones(8, np.int64), max_new_tokens=12))
    assert eng.scheduler.rejected == 2
    assert all(b.configured for b in eng.scheduler.buckets.values())
    # longer than every bucket, chunk pad 16 + 4 - 1 > 16: exact length
    assert eng.submit(Request(np.arange(1, 11), max_new_tokens=4)) == \
        BucketKey(10, "default")
    assert eng.submit(Request(np.arange(1, 4), max_new_tokens=13)) == \
        BucketKey(4, "default")                     # at the KV bound
    key = eng.submit(Request(np.ones(7, np.int64), max_new_tokens=10))
    assert key == BucketKey(7, "default")
    assert not eng.scheduler.buckets[key].configured
    assert eng.scheduler.rejected == 2


def test_generate_serves_admissible_and_flags_rejects(model):
    eng = _engine(model, max_batch=2, max_seq=16, buckets=(4,))
    good = Request(np.asarray([1, 2, 3]), max_new_tokens=2)
    bad = Request(np.arange(12), max_new_tokens=8)
    eng.generate([good, bad])
    assert good.done and len(good.out_tokens) == 2 and good.error == ""
    assert not bad.done and bad.out_tokens == []
    assert bad.error.startswith("AdmissionError")
    assert eng.scheduler.pending() == 0


def test_stats_counter_correctness(model):
    eng = _engine(model, max_batch=2, max_seq=32, buckets=(4,))
    eng.warmup()
    reqs = _reqs(PROMPTS, max_new=2)
    eng.generate(reqs)
    st = eng.stats()
    assert st["requests"]["served"] == 4
    assert st["microbatches"]["total"] == 1
    assert st["microbatches"]["multi_request"] == 1
    assert st["microbatches"]["max_size"] == 2
    assert st["microbatches"]["refills"] == 2
    assert st["tokens"]["generated"] == 8
    assert st["tokens"]["prompt"] == sum(len(p) for p in PROMPTS)
    assert st["tokens"]["padded"] == sum(4 - len(p) for p in PROMPTS)
    assert 0.0 < st["padding_waste"] < 1.0
    assert st["bucket_hits"] == 1 and st["bucket_misses"] == 0
    assert st["bucket_hit_rate"] == 1.0
    assert st["decode_steps"] == 2
    assert all(r.latency_s > 0 for r in reqs)
    assert all(r.bucket == "S4/default" and r.padded_to == 4 for r in reqs)
    sched = st["scheduler"]
    assert sched["pending"] == 0 and sched["mode"] == "masked"
    assert sched["buckets"]["S4/default"]["served"] == 4


def test_refill_disabled_restores_microbatch_per_wave(model):
    eng = _engine(model, max_batch=2, max_seq=32, refill=False,
                  buckets=(4,))
    assert not eng.refill_enabled
    eng.warmup()
    reqs = _reqs(PROMPTS, max_new=2)
    eng.generate(reqs)
    _exact(reqs, eng.generate_reference(_reqs(PROMPTS, max_new=2)))
    st = eng.stats()
    assert st["microbatches"]["total"] == 2
    assert st["microbatches"]["multi_request"] == 2
    assert st["microbatches"]["refills"] == 0
    assert st["plans"]["post_warmup_fresh_resolutions"] == 0


def test_mixed_max_new_early_retirement_and_refill(model):
    eng = _engine(model, max_batch=2, max_seq=32, buckets=(4,))
    eng.warmup()
    max_news = [1, 5, 2, 3]

    def mk():
        return [Request(np.asarray(p), max_new_tokens=n)
                for p, n in zip(PROMPTS, max_news)]

    reqs = mk()
    eng.generate(reqs)
    _exact(reqs, eng.generate_reference(mk()), max_news)
    st = eng.stats()
    assert st["microbatches"]["total"] == 1
    assert st["microbatches"]["refills"] == 2
    assert st["requests"]["served"] == 4
    assert st["tokens"]["generated"] == sum(max_news)
    # prefill retires r0 (refill r2) → step 1 retires r2 (refill r3) →
    # step 2 → step 3 retires r3 → step 4 retires r1
    assert st["decode_steps"] == 4
    lat = eng.metrics.histogram("serve.request.latency_s")
    assert lat.count == 4
    assert lat.max == max(r.latency_s for r in reqs)
    assert all(reqs[i].latency_s < reqs[1].latency_s for i in (0, 2, 3))


def test_double_refill_with_instant_retire_stays_exact(model):
    # both slots retire at prefill and are refilled; the refill in slot 0
    # retires at once (max_new 1) and its own refill must not revert
    # slot 1's fresh first token
    eng = _engine(model, max_batch=2, max_seq=32, buckets=(4,))
    eng.warmup()
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 2, 2], [3, 1]]
    max_news = [1, 1, 1, 3, 2]

    def mk():
        return [Request(np.asarray(p), max_new_tokens=n)
                for p, n in zip(prompts, max_news)]

    reqs = mk()
    eng.generate(reqs)
    _exact(reqs, eng.generate_reference(mk()), max_news)
    st = eng.stats()
    assert st["microbatches"]["total"] == 1
    assert st["microbatches"]["refills"] == 3
    assert st["requests"]["served"] == 5


def test_prefix_reuse_prefill_exact_and_counted(model):
    eng = _engine(model, max_batch=2, max_seq=32, buckets=(8,))
    eng.warmup()
    sys_prefix = [9, 8, 7, 6]     # P = 8 // 2 = 4
    wave1 = [sys_prefix + [1, 2], sys_prefix + [3]]
    wave2 = [sys_prefix + [5, 5, 5], sys_prefix + [2, 9]]
    r1 = _reqs(wave1)
    eng.generate(r1)
    assert eng.prefix.stats()["inserts"] == 1
    r2 = _reqs(wave2)
    eng.generate(r2)
    _exact(r1 + r2, eng.generate_reference(_reqs(wave1 + wave2)))
    st = eng.stats()
    pc = st["prefix_cache"]
    assert pc["hits"] >= 2 and pc["hit_rate"] > 0.0
    assert int(eng.metrics.value("serve.prefix.reused_prefills")) >= 1
    assert st["kv_pages"]["in_use"] == pc["entries"]


def test_prefix_cache_accounting_mixed_wave(model):
    eng = _engine(model, max_batch=3, max_seq=32, buckets=(8,))
    eng.warmup()
    pre_a, pre_b = [9, 8, 7, 6], [5, 5, 5, 5]
    eng.generate(_reqs([pre_a + [1, 2]]))           # miss → inserts A
    pc = eng.prefix.stats()
    assert (pc["hits"], pc["misses"], pc["inserts"]) == (0, 1, 1)
    # A cached (1 hit), B uncached on two rows (1 miss, 1 insert)
    eng.generate(_reqs([pre_a + [3], pre_b + [1], pre_b + [2, 2]]))
    pc = eng.prefix.stats()
    assert (pc["hits"], pc["misses"], pc["inserts"]) == (1, 2, 2)


def test_sampled_decode_batched_unbatched_parity(model):
    eng = _engine(model, max_batch=3, max_seq=32, buckets=(4,))
    eng.warmup()

    def mk():
        return [Request(np.asarray(p), max_new_tokens=4, temperature=t,
                        seed=s)
                for p, t, s in [([1, 2, 3], 0.8, 1), ([1, 2, 3], 0.8, 2),
                                ([4, 5], 0.0, 3), ([2, 2, 2], 1.3, 4)]]

    reqs = mk()
    eng.generate(reqs)        # 3 rows + a refill
    _exact(reqs, eng.generate_reference(mk()))
    assert reqs[0].out_tokens != reqs[1].out_tokens
    assert eng.stats()["microbatches"]["refills"] == 1
    # a sampled refill into a page-reused slot, beside greedy rows
    eng2 = _engine(model, max_batch=2, max_seq=32, buckets=(8,))
    eng2.warmup()
    pre = [9, 8, 7, 6]

    def mk2():
        return [Request(np.asarray(pre + tail), max_new_tokens=n,
                        temperature=t, seed=s)
                for tail, n, t, s in [([1], 2, 0.0, 0), ([2, 2], 5, 0.9, 7),
                                      ([3, 3, 3], 4, 0.9, 8)]]

    reqs2 = mk2()
    eng2.generate(reqs2)
    _exact(reqs2, eng2.generate_reference(mk2()))
    st = eng2.stats()
    assert st["microbatches"]["refills"] == 1
    assert st["microbatches"]["reused_refills"] == 1


def test_chunked_long_prompt_prefill_exact_and_page_reused(model):
    eng = _engine(model, max_batch=2, max_seq=32, buckets=(4, 8))
    eng.warmup()
    prompts = [list(range(1, 12)), [7] * 10]       # L = 11, 10 > pad 8
    reqs = _reqs(prompts, max_new=3)
    eng.generate(reqs)
    refs = eng.generate_reference(_reqs(prompts, max_new=3))
    _exact(reqs, refs)
    for r in reqs:
        assert r.bucket == "S16/default" and r.padded_to == 16
        assert r.cold is False         # chunk path warm from warmup
    st = eng.stats()
    assert st["plans"]["post_warmup_fresh_resolutions"] == 0
    assert st["chunked_prefills"] >= 1
    assert st["chunks"] == {"run": 2, "skipped": 0}
    again = _reqs(prompts, max_new=3)
    eng.generate(again)
    _exact(again, refs)
    st = eng.stats()
    assert st["prefix_cache"]["hits"] >= 2
    assert st["chunks"] == {"run": 3, "skipped": 1}
    assert st["kv_pages"]["in_use"] == st["prefix_cache"]["entries"]
    assert st["kv_pages"]["in_use"] <= eng.config.prefix_pages


def test_chunked_refill_skips_a_chunk_and_stays_exact(model):
    """A refill into a chunked bucket: its chain covers the first chunk,
    so the refill prefill starts at the second."""
    eng = _engine(model, max_batch=1, max_seq=40, buckets=(4, 8))
    eng.warmup()
    long_a = list(range(1, 12))                     # L = 11 → pad 16
    long_b = list(range(1, 10)) + [5, 5, 5]         # shares 9 tokens
    reqs = _reqs([long_a, long_b], max_new=2)
    eng.generate(reqs)
    _exact(reqs, eng.generate_reference(_reqs([long_a, long_b],
                                              max_new=2)))
    st = eng.stats()
    assert st["microbatches"]["refills"] == 1
    assert st["microbatches"]["reused_refills"] == 1
    assert st["chunked_prefills"] == 2
    assert st["chunks"] == {"run": 3, "skipped": 1}
    assert st["kv_pages"]["in_use"] == st["prefix_cache"]["entries"]


def test_refill_without_prefix_cache_serves(model):
    """``refill=True, prefix_cache=False``: the reference's masked engine
    adds to a None prefix cache here; the port serves it."""
    eng = _engine(model, max_batch=2, max_seq=40, buckets=(4, 8),
                  prefix_cache=False)
    eng.warmup()
    prompts = [[9, 8, 7, 6, 1], [9, 8, 7, 6, 2, 2], [9, 8, 7, 6, 3],
               list(range(1, 12))]
    reqs = _reqs(prompts, max_new=3)
    eng.generate(reqs)
    _exact(reqs, eng.generate_reference(_reqs(prompts, max_new=3)))
    st = eng.stats()
    assert st["microbatches"]["refills"] == 1
    assert st["chunked_prefills"] == 1
    assert st["prefix_cache"] is None and st["kv_pages"] is None


# ---------------------------------------------------------------------------
# parity with the JAX engine, both at the reference's defaults
# ---------------------------------------------------------------------------

def _decisions(reqs, st):
    return {
        "requests": [(r.bucket, r.padded_to, r.cold, r.done,
                      len(r.out_tokens)) for r in reqs],
        "refills": st["microbatches"]["refills"],
        "microbatches": st["microbatches"]["total"],
        "multi": st["microbatches"]["multi_request"],
        "prefix": {k: st["prefix_cache"][k]
                   for k in ("hits", "misses", "inserts", "entries")},
        "pages_in_use": st["kv_pages"]["in_use"],
        "chunked": st["chunked_prefills"],
        "tokens": st["tokens"],
        "bucket_hits": (st["bucket_hits"], st["bucket_misses"]),
    }


def _min_margin(cfg, params, prompt, n_new) -> float:
    """Smallest top-2 logit margin along a request's greedy path, served
    alone through the port's decode step."""
    caches = PT.init_cache(cfg, 1, len(prompt) + n_new, "cpu")
    seq, out = list(prompt), []
    for s in range(len(prompt) + n_new - 1):
        logits, _ = PT.forward_decode(params, cfg, torch.tensor([[seq[s]]]),
                                      caches, s)
        if s >= len(prompt) - 1:
            top = torch.topk(logits[0, 0].double(), 2).values
            out.append(float(top[0] - top[1]))
            seq.append(int(torch.argmax(logits[0, 0])))
    return min(out)


def test_engine_defaults_match_jax_engine():
    """Refill, paged prefix reuse and chunked prefill all fire; greedy
    tokens and every host decision equal the reference engine's.  Tokens
    of two frameworks are comparable only where the logits' top-2 margin
    exceeds their drift (``LOGIT_TOL_COMPILED``, fault F4), so every
    compared step must clear it: a near-tie fails here, not as a token
    mismatch."""
    jcfg, jp, pcfg, pp = reduced_pair()
    kw = dict(max_batch=2, max_seq=40, buckets=(4, 8))
    pre = [9, 8, 7, 6]
    long_a = [23, 115, 102, 108, 15, 50, 80, 63, 85, 86, 85]
    long_b = long_a[:9] + [8, 122, 71]
    waves = [
        [pre + [1], pre + [6, 6], [4, 4], pre + [3, 3, 3], [5, 5], long_a],
        [pre + [5], pre + [1, 1, 1], pre + [3, 3, 3], long_a, long_b],
    ]
    max_new = [[2, 5, 1, 3, 4, 3], [3, 2, 3, 2, 2]]
    for wave, news in zip(waves, max_new):
        for p, n in zip(wave, news):
            assert _min_margin(pcfg, pp, p, n) > LOGIT_TOL_COMPILED, p
    jeng = JEngine(jcfg, jp, JServeConfig(**kw))
    jeng.warmup()
    eng = Engine(pcfg, pp, ServeConfig(**kw))
    assert (eng.config.refill, eng.config.prefix_cache,
            eng.config.chunked_prefill) == (True, True, True)
    eng.warmup()
    jall, pall = [], []
    for wave, news in zip(waves, max_new):
        jall += jeng.generate([JRequest(np.asarray(p, np.int32),
                                        max_new_tokens=n)
                               for p, n in zip(wave, news)])
        pall += eng.generate(_reqs_n(wave, news))
    assert [r.out_tokens for r in pall] == [r.out_tokens for r in jall]
    pst, jst = eng.stats(), jeng.stats()
    assert _decisions(pall, pst) == _decisions(jall, jst)
    assert pst["microbatches"]["refills"] >= 2
    assert pst["microbatches"]["reused_refills"] >= 1
    assert pst["prefix_cache"]["hits"] >= 1
    assert pst["chunked_prefills"] >= 2
    assert pst["chunks"]["skipped"] >= 1
    assert pst["plans"]["post_warmup_fresh_resolutions"] == 0


def _reqs_n(prompts, news):
    return [Request(np.asarray(p, np.int64), max_new_tokens=n)
            for p, n in zip(prompts, news)]


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

#: total-variation bound of the sampler's empirical distribution over
#: 24,000 draws of 16 categories (expected TV about 0.01)
SAMPLE_TV = 0.03


def test_sampler_distribution_matches_softmax():
    rng = np.random.default_rng(0)
    V, B, calls, T_ = 16, 8, 3000, 0.7
    row = torch.from_numpy(rng.normal(0, 1.5, V).astype(np.float32))
    logits = row[None].expand(B, V).contiguous()
    temps = np.full(B, T_, np.float32)
    draw = np.ones(B, bool)
    counts = np.zeros(V)
    for c in range(calls):
        seeds = np.arange(B, dtype=np.int64) + B * c
        toks = sample_tokens(logits, temps, seeds, np.full(B, c % 7), draw,
                             rng_seed=3)
        np.add.at(counts, toks.numpy(), 1)
    p = torch.softmax(row / np.float32(T_), -1).double().numpy()
    tv = 0.5 * np.abs(counts / counts.sum() - p).sum()
    assert counts.sum() == B * calls >= 20_000
    assert tv < SAMPLE_TV, tv


def test_sampler_stream_independent_of_row_and_batch():
    rng = np.random.default_rng(1)
    V = 64
    row = torch.from_numpy(rng.normal(0, 1, V).astype(np.float32))
    alone = sample_tokens(row[None], np.float32([0.9]), np.int64([11]),
                          np.int64([5]), np.ones(1, bool), rng_seed=0)
    other = torch.from_numpy(rng.normal(0, 1, (4, V)).astype(np.float32))
    for i in range(4):
        batch = other.clone()
        batch[i] = row
        temps = np.float32([0.9 if j == i else 0.5 for j in range(4)])
        seeds = np.int64([11 if j == i else 99 + j for j in range(4)])
        n = np.int64([5 if j == i else 1 for j in range(4)])
        got = sample_tokens(batch, temps, seeds, n, np.ones(4, bool),
                            rng_seed=0)
        assert int(got[i]) == int(alone[0])
    # greedy and non-drawing rows take the argmax
    g = sample_tokens(other, np.float32([0, 0.9, 0.9, 0]),
                      np.int64([1, 2, 3, 4]), np.zeros(4, np.int64),
                      np.array([True, False, True, True]), rng_seed=0)
    am = torch.argmax(other, -1)
    assert int(g[0]) == int(am[0]) and int(g[1]) == int(am[1])
    assert int(g[3]) == int(am[3])
    # the stream seed depends on all three integers
    s = {stream_seed(a, b, c) for a in (0, 1) for b in (0, 1)
         for c in (0, 1)}
    assert len(s) == 8
