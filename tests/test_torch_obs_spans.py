"""The port's spans inside a serving burst and a train step
(``repro_torch.obs``): one ``model.forward`` per model step (a training
forward's with a mixer and an FFN span per layer and ``model.head`` as
its children, a served step's with none), one ``serve.drain`` inside
each ``serve.retire_pass`` and one pass per step that retires a row, a
request's ``req_id`` on its admit and retire events, ``train.step``
around the forward, the backward and the optimizer, and the same
outputs traced and untraced.  Port only: nothing here is compared with
the JAX package."""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch import tree as TR
from repro_torch.configs import get, reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer as PT
from repro_torch.obs import hygiene as OH
from repro_torch.obs import metrics as PM
from repro_torch.obs import trace as OT
from repro_torch.optim import adamw
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.train.train_step import make_train_step
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv(PS.CACHE_ENV, str(tmp_path / "plans.json"))
    monkeypatch.delenv(DV.DEVICE_ENV, raising=False)
    monkeypatch.setattr(PD, "_REGISTRY", {})
    monkeypatch.setattr(PS, "_default_cache", None)
    monkeypatch.setattr(PM, "_DEFAULT", PM.MetricsRegistry())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    obs.configure(enabled=False)


def _traced(fn):
    """(fn's result, the events it emitted) under an in-memory tracer."""
    obs.configure(enabled=True)
    try:
        out = fn()
        events = list(obs.tracer().buffer)
    finally:
        obs.configure(enabled=False)
    assert OH.validate_events(events) == []
    return out, events


def _spans(events, name):
    return [e for e in events if e["ph"] == "X" and e["name"] == name]


def _children(events, parent, name):
    return [e for e in _spans(events, name)
            if e["args"]["parent_id"] == parent["args"]["span_id"]]


def _check_model_steps(cfg, events, steps: int, layers: bool) -> None:
    """One ``model.forward`` per model step; with ``layers`` each the
    parent of one mixer span and one FFN span per layer and of one
    ``model.head``, else of no span."""
    fwd = _spans(events, "model.forward")
    assert len(fwd) == steps
    kinds = cfg.layer_kinds()
    model = [e for e in events if e["ph"] == "X" and e["cat"] == "model"]
    for f in fwd:
        for span in {PT.MIXER_SPAN[m] for m, _ in kinds} | \
                {PT.FFN_SPAN[x] for _, x in kinds if x != "none"}:
            got = [e["args"]["layer"] for e in _children(events, f, span)]
            assert got == [i for i, (m, x) in enumerate(kinds)
                           if layers and span in (PT.MIXER_SPAN[m],
                                                  PT.FFN_SPAN.get(x))]
        assert len(_children(events, f, "model.head")) == int(layers)
        inner = [e for e in model
                 if e["args"]["parent_id"] == f["args"]["span_id"]]
        assert len(inner) == (2 * len(kinds) + 1 if layers else 0)
    ids = [e["args"]["span_id"] for e in events if e["ph"] == "X"]
    assert len(set(ids)) == len(ids)


def _check_retirements(events, reqs) -> None:
    """One pass per step that retires a row, one drain inside each, and
    each request's ``req_id`` on its admit and its retire event."""
    passes = _spans(events, "serve.retire_pass")
    steps = {r.max_new_tokens for r in reqs}
    assert len(passes) == len(steps)
    assert sorted(p["args"]["rows"] for p in passes) == sorted(
        sum(r.max_new_tokens == n for r in reqs) for n in steps)
    for p in passes:
        assert len(_children(events, p, "serve.drain")) == 1
    assert len(_spans(events, "serve.drain")) == len(passes)
    admit = {e["args"]["req_id"] for e in events
             if e["name"] == "serve.admit"}
    retire = {e["args"]["req_id"] for e in events
              if e["name"] == "serve.retire"}
    assert admit == retire == {r.req_id for r in reqs}
    assert len(admit) == len(reqs)
    mb = _spans(events, "serve.microbatch")
    assert sorted(i for m in mb for i in m["args"]["req_ids"]) == \
        sorted(r.req_id for r in reqs)


def _serve(name, prompts, max_new, **kw):
    """(cfg, requests, events, engine stats) of one burst served traced,
    its tokens checked against the same burst served untraced on an
    engine of its own."""
    cfg = reduced(get(name))
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)

    def burst():
        eng = Engine(cfg, params, ServeConfig(**kw))
        eng.warmup()
        reqs = [Request(np.asarray(p, np.int64), max_new_tokens=n)
                for p, n in zip(prompts, max_new)]
        return eng, reqs, eng.generate(reqs)

    _, plain, _ = burst()
    (eng, reqs, _), events = _traced(burst)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in plain]
    assert all(r.done and not r.error for r in reqs)
    return cfg, reqs, events, eng.stats()


def test_masked_burst_spans():
    prompts = [[5, 9, 2], [7, 1, 4, 4, 8], [3, 3], [6, 2, 8, 1]]
    cfg, reqs, events, st = _serve("internlm2-1.8b", prompts, [2, 5, 3, 5],
                                   buckets=(8,), max_batch=4, max_seq=32)
    assert st["mode"] == "masked"
    _check_model_steps(cfg, events, st["prefill_steps"] + st["decode_steps"],
                       layers=False)
    _check_retirements(events, reqs)


def test_equal_burst_spans():
    prompts = [[5, 9, 2, 7], [7, 1, 4, 4]]
    cfg, reqs, events, st = _serve("gemma3-4b", prompts, [2, 4],
                                   buckets=(4,), max_batch=2, max_seq=32)
    assert st["mode"] == "equal"
    _check_model_steps(cfg, events, st["prefill_steps"] + st["decode_steps"],
                       layers=False)
    _check_retirements(events, reqs)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_spans(microbatches):
    """``train.step`` holds the forward, the backward and the optimizer
    (through ``train.accumulate`` with microbatches), and the step's
    weights are bitwise those of the untraced step."""
    cfg = reduced(get("internlm2-1.8b"))
    ocfg = adamw.AdamWConfig(warmup_steps=0, total_steps=10)
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    batch = make_batch(cfg, 16, 2, seed=0, device="cpu")
    step = make_train_step(cfg, ocfg, microbatches)

    def run():
        p = TR.map_tensors(torch.clone, params)
        p, _, m = step(p, adamw.init(p, ocfg), batch)
        return p, m

    plain, m0 = run()
    (traced, m1), events = _traced(run)
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(TR.tensors(plain), TR.tensors(traced)):
        assert torch.equal(a, b)
    (top,) = _spans(events, "train.step")
    assert top["args"]["parent_id"] is None
    inner = top
    if microbatches > 1:
        (inner,) = _children(events, top, "train.accumulate")
    assert len(_children(events, inner, "model.forward")) == microbatches
    assert len(_children(events, inner, "train.backward")) == microbatches
    assert len(_children(events, top, "train.optimizer")) == 1
    assert {"model.attention", "model.mlp"} == {
        PT.MIXER_SPAN[m] for m, _ in cfg.layer_kinds()} | {
        PT.FFN_SPAN[x] for _, x in cfg.layer_kinds()}
    _check_model_steps(cfg, events, microbatches, layers=True)


def test_untraced_burst_emits_nothing(tmp_path):
    """Off, the tracer is the shared no-op: a burst leaves no event and no
    file, and its requests still get their ids."""
    obs.configure(enabled=False)
    cfg = reduced(get("internlm2-1.8b"))
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    eng = Engine(cfg, params, ServeConfig(buckets=(8,), max_batch=2,
                                          max_seq=32))
    reqs = eng.generate([Request(np.asarray([1, 2, 3], np.int64),
                                 max_new_tokens=2) for _ in range(2)])
    assert obs.tracer() is OT.NULL_TRACER
    assert not hasattr(obs.tracer(), "buffer")
    assert [r.req_id for r in reqs] == [0, 1]
    assert list(tmp_path.iterdir()) == []
