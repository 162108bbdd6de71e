"""The serve engine of ``repro_torch`` at reduced size: batched tokens
equal the unbatched reference's (inside the port), and equal the JAX
package's ``Engine`` on the same weights and requests; warmup leaves no
fresh plan resolution for serving; sampled requests and the refill,
prefix-cache and chunked-prefill options are served; the serve launcher
serves on the CPU and refuses the options it does not port.

``PORTED`` pins refill, the prefix cache and chunked prefill off for the
tests of the plain microbatch path (the serve state has its own battery,
``tests/test_torch_serve_scheduler.py``).

The JAX engine runs with ``prefix_cache=True``: its masked path with the
prefix cache off fails on a ``None`` cache (a reference-side fault), and
prefix reuse is bit-exact, so the tokens it serves are the same.
"""
import json
import os
import subprocess
import sys

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
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as PT
from repro_torch.obs import metrics as PM
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve.scheduler import AdmissionError
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS
from test_torch_models import reduced_pair

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
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
    """What the engine once refused is served: a sampled request, and an
    engine with each of refill, the prefix cache and chunked prefill on
    alone; each serves the tokens of its unbatched reference."""
    cfg, eng = _engine(max_batch=2, max_seq=16, buckets=(4, 8))
    with pytest.raises(AdmissionError):
        eng.submit(Request(np.arange(12), max_new_tokens=16))
    sampled = Request(np.arange(3), temperature=0.7, max_new_tokens=4,
                      seed=5)
    assert eng.submit(sampled).pad_len == 4
    assert eng.scheduler.rejected == 1
    # longer than every bucket but within the KV bound: exact-length bucket
    key = eng.submit(Request(np.arange(1, 11), max_new_tokens=4))
    assert key.pad_len == 10
    eng.run()
    ref = eng.generate_reference([Request(np.arange(3), temperature=0.7,
                                          max_new_tokens=4, seed=5)])[0]
    assert sampled.done and sampled.out_tokens == ref.out_tokens
    prompts = [[9, 8, 7, 6, 1], [9, 8, 7, 6, 2, 2], [9, 8, 7, 6, 3],
               list(range(1, 12))]
    for flag in PORTED:
        e = Engine(cfg, eng.params, ServeConfig(
            max_batch=2, max_seq=40, buckets=(4, 8),
            **{**PORTED, flag: True}))
        e.warmup()
        reqs = e.generate([Request(np.asarray(p), max_new_tokens=3)
                           for p in prompts])
        refs = e.generate_reference([Request(np.asarray(p),
                                             max_new_tokens=3)
                                     for p in prompts])
        assert [r.out_tokens for r in reqs] == [r.out_tokens for r in refs]
        st = e.stats()
        assert (st["microbatches"]["refills"] > 0) == (flag == "refill")
        assert (st["chunked_prefills"] > 0) == (flag == "chunked_prefill")
        assert (st["prefix_cache"] is not None) == (flag == "prefix_cache")


def test_generate_marks_inadmissible_requests():
    cfg, eng = _engine(max_batch=2, max_seq=16, buckets=(4, 8))
    reqs = [Request(np.arange(3), max_new_tokens=3),
            Request(np.arange(15), max_new_tokens=8)]
    eng.generate(reqs)
    assert reqs[0].done and len(reqs[0].out_tokens) == 3
    assert not reqs[1].done and reqs[1].error.startswith("AdmissionError")


def _serve_cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        capture_output=True, text=True, timeout=300)


def test_serve_launcher_smoke_on_cpu():
    """``python -m repro_torch.launch.serve --smoke --device cpu`` serves
    with the reference's defaults: a long prompt goes through chunked
    prefill, a third request through a refill."""
    out = _serve_cli("--smoke", "--device", "cpu", "--max-batch", "2",
                     "--temperature", "0.5", "--stats", "--prompts",
                     "1 2 3", "4 5 6 7", "8 9", " ".join(["3"] * 40))
    assert out.returncode == 0, out.stderr
    assert "refill=True prefix_cache=True chunk=32" in out.stdout
    served = [ln for ln in out.stdout.splitlines()
              if ln.startswith("request ")]
    assert len(served) == 4 and all("out=[" in ln for ln in served)
    st = json.loads(out.stdout[out.stdout.index("\n{") + 1:])
    assert st["requests"]["served"] == 4
    assert st["microbatches"]["refills"] == 1
    assert st["chunked_prefills"] == 1
    assert st["plans"]["post_warmup_fresh_resolutions"] == 0


@pytest.mark.parametrize("flags", [["--replicas", "2"],
                                   ["--replicas", "2", "--trace", "TRACE"],
                                   ["--replicas", "2", "--quantize",
                                    "int8:d"],
                                   ["--trace", "TRACE"]])
def test_serve_launcher_refuses_unported_options(flags, tmp_path, capsys):
    """The reference launcher's ``--replicas`` and ``--trace`` are served
    now (a cluster of engines; a JSONL trace with its Chrome export that
    the hygiene validator accepts); what the reference refuses,
    ``--replicas`` with ``--quantize``, the port refuses before any model
    is built, with the reference's message."""
    from repro_torch.obs import hygiene
    trace = str(tmp_path / "t.jsonl")
    flags = [trace if f == "TRACE" else f for f in flags]
    argv = ["--smoke", "--device", "cpu", "--max-new", "2", *flags]
    if "--quantize" in flags:
        with pytest.raises(SystemExit) as exc:
            serve_cli.main(argv)
        assert "not supported with --replicas" in str(exc.value.code)
        return
    assert serve_cli.main(argv) == 0
    out = capsys.readouterr().out
    if "--replicas" in flags:
        assert "cluster of 2 replicas" in out
        assert "over 2/2 healthy replicas" in out
    if "--trace" in flags:
        assert hygiene.validate_trace(trace, min_span_types=3) == []
        assert os.path.exists(trace[:-len(".jsonl")] + ".trace.json")
