"""Serving the Mamba-hybrid family through the port's engine (equal
mode), and its checkpoint round trip.

* Mode selection is the reference's: Jamba (``block_type`` mamba_hybrid,
  with experts) serves in equal mode.
* At the published ``capacity_factor`` 1.25, on the same reduced weights
  and batches, the port's greedy tokens equal the JAX engine's (its ops
  run one by one, so the logits agree to ``LOGIT_TOL_EAGER``; every
  greedy step of the stream clears 10x that margin) and both drop the
  same number of (token, expert) pairs per microbatch: equal mode
  reproduces the reference's batched behaviour, drops included
  (``ROADMAP.md`` queue 3, F7).
* At ``capacity_factor`` 16 nothing drops, and batched equals
  ``generate_reference`` bit for bit, greedy and sampled: the Mamba
  state and the KV cache are per row.
* A port checkpoint of the reduced model restores into freshly
  initialised weights that serve the same tokens.
* ``launch.serve --arch jamba-v0.1-52b --smoke --device cpu`` serves in
  equal mode and exits 0.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.obs import metrics as JM
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.tune import dispatch as JD
from repro.tune import search as JS
from repro_torch.checkpoint import ckpt
from repro_torch.models import transformer as PT
from repro_torch.obs import metrics as PM
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS
from test_torch_mamba import _pair
from test_torch_models import LOGIT_TOL_EAGER
from test_torch_serve_equal import _jax_drop_counter, _min_margin, _reqs


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


def test_jamba_serves_equal_and_matches_jax_engine(monkeypatch):
    """Two calls (four 4-token prompts, then three 8-token ones) at the
    published capacity: the port's tokens and per-microbatch drops equal
    the JAX engine's."""
    jcounts = _jax_drop_counter(monkeypatch)
    jcfg, jp, pcfg, pp = _pair()
    assert jcfg.capacity_factor == pcfg.capacity_factor == 1.25
    kw = dict(max_batch=4, max_seq=24, buckets=(4, 8))
    rng = np.random.default_rng(3)
    calls = [[rng.integers(0, pcfg.vocab, 4) for _ in range(4)],
             [rng.integers(0, pcfg.vocab, 8) for _ in range(3)]]
    n_new = 5
    for call in calls:
        for p in call:
            assert _min_margin(pcfg, pp, p, n_new) > 10 * LOGIT_TOL_EAGER, p
    jeng = JEngine(jcfg, jp, JServeConfig(**kw))
    assert jeng.mode == "equal"
    eng = Engine(pcfg, pp, ServeConfig(**kw))
    assert eng.mode == "equal" and not eng.refill_enabled
    assert eng.prefix is None and eng._chunk == 0
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
    st = eng.stats()
    assert st["moe"]["dropped_per_microbatch"] == jdrops
    assert sum(jdrops) > 0
    assert st["microbatches"]["total"] == 2
    assert st["plans"]["post_warmup_fresh_resolutions"] == 0


def test_jamba_batched_equals_unbatched_when_nothing_drops():
    """capacity_factor 16: C = ceil(B·k/E·16) >= B, so no pair drops and
    batched equals the unbatched reference, greedy and sampled."""
    _, _, pcfg, pp = _pair()
    cfg = dataclasses.replace(pcfg, capacity_factor=16.0)
    eng = Engine(cfg, pp, ServeConfig(max_batch=4, max_seq=24,
                                      buckets=(4, 8)))
    eng.warmup()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, L) for L in (4, 4, 4, 8, 8, 8)]

    def stream():
        return [Request(np.asarray(p, np.int64), max_new_tokens=n,
                        temperature=0.8 if i in (1, 4) else 0.0, seed=i)
                for i, (p, n) in enumerate(zip(prompts, (5, 3, 5, 4, 5, 2)))]

    got = eng.generate(stream())
    refs = eng.generate_reference(stream())
    assert [r.out_tokens for r in got] == [r.out_tokens for r in refs]
    st = eng.stats()
    assert st["moe"]["dropped_per_microbatch"] == [0, 0]
    assert st["microbatches"]["total"] == 2


def test_checkpoint_restore_serves_same_tokens(tmp_path):
    _, _, pcfg, pp = _pair()
    ckpt.save(str(tmp_path / "ck"), {"params": pp}, step=1)
    fresh = PT.init_model(torch.Generator().manual_seed(7), pcfg)
    got, _ = ckpt.restore(str(tmp_path / "ck"), {"params": fresh})
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8]]
    kw = dict(max_batch=2, max_seq=16, buckets=(4,))
    out = [[r.out_tokens for r in Engine(pcfg, params, ServeConfig(**kw))
            .generate(_reqs(prompts, 4))]
           for params in (pp, got["params"])]
    assert out[0] == out[1]


def test_serve_launcher_jamba(capsys):
    from repro_torch.launch import serve as L
    assert L.main(["--arch", "jamba-v0.1-52b", "--smoke", "--device", "cpu",
                   "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "mode=equal" in out and "served=2" in out
