"""The serve engine of ``repro_torch`` at reduced size: batched tokens
equal the unbatched reference's (inside the port), and equal the JAX
package's ``Engine`` on the same weights and requests; warmup leaves no
fresh plan resolution for serving; what the port does not serve yet
raises.

The JAX engine runs with ``prefix_cache=True``: its masked path with the
prefix cache off fails on a ``None`` cache (a reference-side fault), and
prefix reuse is bit-exact, so the tokens it serves are the same.
"""
import numpy as np
import pytest
import torch

from repro.obs import metrics as JM
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.tune import dispatch as JD
from repro.tune import search as JS
from repro_torch.configs import get, reduced
from repro_torch.kernels import ops
from repro_torch.models import transformer as PT
from repro_torch.obs import metrics as PM
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve.scheduler import AdmissionError
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS
from test_torch_models import reduced_pair

PORTED = dict(refill=False, prefix_cache=False, chunked_prefill=False)


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


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, L) for L in lengths]


def _engine(cfg=None, params=None, **kw):
    if cfg is None:
        cfg = reduced(get("internlm2-1.8b"))
        params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    return cfg, Engine(cfg, params, ServeConfig(**{**PORTED, **kw}))


@pytest.mark.parametrize("forced", [None, "gpu-h100"])
def test_batched_equals_unbatched_and_no_fresh_resolutions(monkeypatch,
                                                           forced):
    """Mixed lengths share padded microbatches; every request's tokens
    equal serving it alone.  With the H100 spec forced, every KSplit
    linear takes the kernel route (its plain version on CPU tensors)."""
    if forced:
        monkeypatch.setenv(DV.DEVICE_ENV, forced)
    cfg, eng = _engine(max_batch=3, max_seq=48)
    report = eng.warmup()
    lengths = (3, 7, 12, 5, 16, 2, 9)
    reqs = [Request(p, max_new_tokens=5)
            for p in _prompts(cfg.vocab, lengths)]
    ops.reset_launch_counts()
    eng.generate(reqs)
    refs = eng.generate_reference(
        [Request(p, max_new_tokens=5) for p in _prompts(cfg.vocab, lengths)])
    for r, ref in zip(reqs, refs):
        assert r.done and len(r.out_tokens) == 5
        assert r.out_tokens == ref.out_tokens
    st = eng.stats()
    assert st["plans"]["post_warmup_fresh_resolutions"] == 0
    assert st["microbatches"]["multi_request"] >= 1
    assert st["bucket_misses"] == 0
    want = "ksplit_cuda" if forced else "ksplit_torch"
    assert set(st["linear_dispatch_since_warmup"]) == {want}
    assert all(want in b["paths"] for k, b in report.items()
               if k != "fresh_resolutions")
    assert ops.launch_counts()["ksplit_gemm"] == 0   # CPU: plain versions


def test_tokens_equal_jax_engine():
    jcfg, jp, pcfg, pp = reduced_pair()
    kw = dict(max_batch=2, max_seq=32, buckets=(8,))
    lengths = (3, 5, 8, 6)
    jeng = JEngine(jcfg, jp, JServeConfig(**kw, refill=False,
                                          chunked_prefill=False))
    jreqs = jeng.generate([JRequest(np.asarray(p, np.int32),
                                    max_new_tokens=6)
                           for p in _prompts(pcfg.vocab, lengths)])
    _, eng = _engine(pcfg, pp, **kw)
    eng.warmup()
    reqs = eng.generate([Request(p, max_new_tokens=6)
                         for p in _prompts(pcfg.vocab, lengths)])
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]


def test_admission_and_unported_options():
    cfg, eng = _engine(max_batch=2, max_seq=16, buckets=(4, 8))
    with pytest.raises(AdmissionError):
        eng.submit(Request(np.arange(12), max_new_tokens=16))
    with pytest.raises(NotImplementedError):
        eng.submit(Request(np.arange(3), temperature=0.7))
    assert eng.scheduler.rejected == 1
    # longer than every bucket but within the KV bound: exact-length bucket
    key = eng.submit(Request(np.arange(1, 11), max_new_tokens=4))
    assert key.pad_len == 10
    eng.run()
    params = eng.params
    for flag in PORTED:
        with pytest.raises(NotImplementedError):
            Engine(cfg, params, ServeConfig(**{flag: True}))


def test_generate_marks_inadmissible_requests():
    cfg, eng = _engine(max_batch=2, max_seq=16, buckets=(4, 8))
    reqs = [Request(np.arange(3), max_new_tokens=3),
            Request(np.arange(15), max_new_tokens=8)]
    eng.generate(reqs)
    assert reqs[0].done and len(reqs[0].out_tokens) == 3
    assert not reqs[1].done and reqs[1].error.startswith("AdmissionError")
