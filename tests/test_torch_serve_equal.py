"""The port's equal-mode serving (twins of the equal-mode tests of
``tests/test_serve_scheduler.py``, and parity with the JAX engine).

* gemma3 (local/global attention) serves in equal mode: only
  same-length requests share a microbatch, and every request's tokens
  equal ``generate_reference``'s.
* Reduced qwen2-moe at the published ``capacity_factor`` 1.25: the
  port's greedy tokens equal the JAX engine's (its ops run one by one,
  so the logits agree to ``LOGIT_TOL_EAGER`` and every greedy step of
  the stream must clear 10x that margin) on the same weights and
  batches, and both drop the same number of (token, expert) pairs per
  microbatch (the reference's batched behaviour, drops included: equal
  mode is not batch-invariant under capacity routing, ``ROADMAP.md``
  queue 3, F7).  The JAX engine's drops are read with a
  ``jax.debug.callback`` wrapped around its ``moe_block``.
* At ``capacity_factor`` 16 (C ≥ B at every step) nothing drops and
  batched equals ``generate_reference`` bit for bit, greedy and sampled.
* Refill, the prefix cache and chunked prefill are off in equal mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMoE
from repro.obs import metrics as JM
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.tune import dispatch as JD
from repro.tune import search as JS
from repro_torch.configs import get, reduced
from repro_torch.models import transformer as PT
from repro_torch.obs import metrics as PM
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS
from test_torch_families import _pair
from test_torch_models import LOGIT_TOL_EAGER


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


def _engine(name, capacity_factor=None, **kw):
    cfg = reduced(get(name))
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    return cfg, Engine(cfg, params, ServeConfig(**kw))


def _reqs(prompts, max_new=3, **kw):
    return [Request(np.asarray(p, np.int64), max_new_tokens=max_new, **kw)
            for p in prompts]


def test_equal_mode_family_parity():
    """Twin of the reference's test: local:global attention cannot mask
    padding, so only same-length requests share a microbatch."""
    cfg, eng = _engine("gemma3-4b", max_batch=2, max_seq=32, buckets=(4,))
    assert eng.mode == "equal"
    eng.warmup()
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 9]]
    reqs = _reqs(prompts)
    eng.generate(reqs)
    refs = eng.generate_reference(_reqs(prompts))
    for r, ref in zip(reqs, refs):
        assert r.done and r.out_tokens == ref.out_tokens
    st = eng.stats()
    assert st["microbatches"]["multi_request"] == 1   # the two L=4 requests
    assert st["scheduler"]["buckets"]["S2/default"]["misses"] == 1
    assert st["plans"]["post_warmup_fresh_resolutions"] == 0
    assert st["moe"] is None


def test_equal_mode_past_the_window_stays_exact():
    """Prompts and decode run past the reduced window (8): the local
    layers' ring buffers wrap in the batch and in the reference alike."""
    cfg, eng = _engine("gemma3-4b", max_batch=3, max_seq=32, buckets=(16,))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 16) for _ in range(3)]
    reqs = _reqs(prompts, max_new=10)
    eng.generate(reqs)
    refs = eng.generate_reference(_reqs(prompts, max_new=10))
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in refs]
    assert eng.stats()["microbatches"]["total"] == 1


def test_equal_mode_disables_refill_prefix_and_chunking():
    for name in ("gemma3-4b", "qwen2-moe-a2.7b"):
        cfg, eng = _engine(name, max_batch=2, max_seq=64, buckets=(4, 8))
        assert eng.config.refill and eng.config.prefix_cache
        assert eng.config.chunked_prefill
        assert eng.mode == "equal" and not eng.refill_enabled
        assert eng.prefix is None and eng.pool is None and eng._chunk == 0
        long = np.arange(20) % cfg.vocab        # longer than every bucket
        reqs = eng.generate(_reqs([long, long[:5], long[:5]], max_new=4))
        st = eng.stats()
        assert all(r.done for r in reqs)
        assert reqs[0].bucket == "S20/default"  # exact length, no chunks
        assert st["chunked_prefills"] == 0 and st["prefix_cache"] is None
        assert st["microbatches"]["refills"] == 0
        refs = eng.generate_reference(_reqs([long, long[:5]], max_new=4))
        assert reqs[0].out_tokens == refs[0].out_tokens


def test_moe_equal_mode_exact_when_nothing_drops():
    """capacity_factor 16: C = ceil(B·k/E·16) >= B, so no pair drops and
    batched equals the unbatched reference, greedy and sampled."""
    cfg, eng = _engine("qwen2-moe-a2.7b", capacity_factor=16.0,
                       max_batch=4, max_seq=40, buckets=(8, 16))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, L) for L in (8, 8, 8, 8, 16, 16,
                                                       16)]
    kw = [dict(), dict(), dict(temperature=0.8, seed=1), dict(),
          dict(), dict(temperature=0.8, seed=2), dict()]

    def stream():
        return [Request(np.asarray(p, np.int64), max_new_tokens=n, **k)
                for p, n, k in zip(prompts, (6, 3, 6, 5, 6, 6, 2), kw)]

    reqs = eng.generate(stream())
    refs = eng.generate_reference(stream())
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in refs]
    st = eng.stats()
    assert st["moe"]["dropped_per_microbatch"] == [0, 0]
    assert st["microbatches"]["total"] == 2


def _jax_drop_counter(monkeypatch) -> list:
    """Wrap the reference's ``moe_block`` so every call (inside jit and
    scan) reports its dropped (token, expert) pairs to the host."""
    counts = []
    orig = JMoE.moe_block

    def counting(params, x, *, top_k, capacity_factor=1.25,
                 return_aux=False):
        B, S, d = x.shape
        keep = JMoE._dispatch_tables(x.reshape(B * S, d), params["router"],
                                     top_k, capacity_factor)[4]
        jax.debug.callback(lambda n: counts.append(int(n)),
                           jnp.sum(~keep))
        return orig(params, x, top_k=top_k, capacity_factor=capacity_factor,
                    return_aux=return_aux)

    monkeypatch.setattr(JMoE, "moe_block", counting)
    return counts


def _min_margin(cfg, params, prompt, n_new) -> float:
    """Smallest top-2 logit margin along a request's greedy path, served
    alone through the port's decode step at batch 4."""
    caches = PT.init_cache(cfg, 4, len(prompt) + n_new, "cpu")
    seq, out = list(prompt), []
    for s in range(len(prompt) + n_new - 1):
        tok = torch.full((4, 1), int(seq[s]))
        logits, _ = PT.forward_decode(params, cfg, tok, caches, s)
        if s >= len(prompt) - 1:
            top = torch.topk(logits[0, 0].double(), 2).values
            out.append(float(top[0] - top[1]))
            seq.append(int(torch.argmax(logits[0, 0])))
    return min(out)


def test_moe_equal_mode_matches_jax_engine_with_drops(monkeypatch):
    """Published capacity 1.25: the port serves what the JAX engine
    serves, drops included; the same microbatches drop the same number of
    pairs, and some request differs from its unbatched reference (F7)."""
    jcounts = _jax_drop_counter(monkeypatch)
    jcfg, jp, pcfg, pp = _pair("qwen2-moe-a2.7b")
    assert jcfg.capacity_factor == pcfg.capacity_factor == 1.25
    kw = dict(max_batch=4, max_seq=32, buckets=(4, 8))
    rng = np.random.default_rng(2)
    calls = [[rng.integers(0, pcfg.vocab, 4) for _ in range(4)],
             [rng.integers(0, pcfg.vocab, 8) for _ in range(3)]]
    n_new = 5
    for call in calls:
        for p in call:
            assert _min_margin(pcfg, pp, p, n_new) > 10 * LOGIT_TOL_EAGER, p
    jeng = JEngine(jcfg, jp, JServeConfig(**kw))
    assert jeng.mode == "equal"
    eng = Engine(pcfg, pp, ServeConfig(**kw))
    eng.warmup()
    jdrops, jtoks, ptoks = [], [], []
    for call in calls:
        jcounts.clear()
        with jax.disable_jit():       # the reference's ops one by one
            out = jeng.generate([JRequest(np.asarray(p, np.int32),
                                          max_new_tokens=n_new)
                                 for p in call])
        jax.effects_barrier()
        jdrops.append(sum(jcounts))
        jtoks += [r.out_tokens for r in out]
        ptoks += [r.out_tokens for r in eng.generate(_reqs(call, n_new))]
    assert ptoks == jtoks
    assert eng.stats()["moe"]["dropped_per_microbatch"] == jdrops
    assert sum(jdrops) > 0
    refs = eng.generate_reference(
        _reqs([p for call in calls for p in call], n_new))
    assert [r.out_tokens for r in refs] != ptoks


def test_serve_launcher_new_archs(capsys):
    """``launch.serve --arch`` serves the MoE and windowed configs
    (reduced, on the CPU) in equal mode, and ``--quantize`` on an MoE
    config serves its int8 variant there too."""
    from repro_torch.launch import serve as L
    for arch in ("qwen2-moe-a2.7b", "gemma3-4b"):
        assert L.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--max-new", "2"]) == 0
        assert "mode=equal" in capsys.readouterr().out
    assert L.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--device",
                   "cpu", "--quantize", "int8:d", "--max-new", "2"]) == 0
    assert "mode=equal" in capsys.readouterr().out
