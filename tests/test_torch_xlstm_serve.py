"""Serving the xLSTM family through the port's engine (equal mode).

* Mode selection is the reference's: masked only for full attention
  with ``block_type == "attn"``, no experts, no frontend and not
  encoder-only; so xLSTM serves in equal mode and InternLM2 keeps masked
  mode.
* On the same reduced weights the port's greedy tokens equal the JAX
  engine's (its ops run one by one, so the logits agree to
  ``LOGIT_TOL_EAGER``; every greedy step of the stream clears 10x that
  margin), and batched tokens equal ``generate_reference``'s, greedy and
  sampled: the recurrent state is per row, so equal mode is exact.
* ``launch.serve --arch xlstm-1.3b --smoke --device cpu`` serves in
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
from repro_torch.configs import get, reduced
from repro_torch.obs import metrics as PM
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS
from test_torch_models import LOGIT_TOL_EAGER
from test_torch_serve_equal import _min_margin, _reqs
from test_torch_xlstm_models import _pair


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


def test_mode_selection_is_the_reference_rule():
    from repro_torch.models import transformer as PT
    for name, mode in (("xlstm-1.3b", "equal"), ("internlm2-1.8b",
                                                 "masked"),
                       ("gemma3-4b", "equal"), ("qwen2-moe-a2.7b", "equal")):
        cfg = reduced(get(name))
        params = PT.init_model(torch.Generator().manual_seed(0), cfg)
        assert Engine(cfg, params, ServeConfig(max_batch=2,
                                               max_seq=16)).mode == mode
        for field, value in (("encoder_only", True), ("frontend", "audio"),
                             ("block_type", "mamba_hybrid")):
            odd = dataclasses.replace(cfg, **{field: value})
            assert Engine(odd, params, ServeConfig(max_batch=2, max_seq=16)
                          ).mode == "equal", (name, field)


def test_xlstm_serves_equal_and_matches_jax_engine():
    """Two calls (four 4-token prompts, then three 8-token ones, one of
    them sampled in the batched-vs-reference check): the port's tokens
    equal the JAX engine's, and batched equals unbatched."""
    jcfg, jp, pcfg, pp = _pair()
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
    jtoks, ptoks = [], []
    for call in calls:
        with jax.disable_jit():       # the reference's ops one by one
            out = jeng.generate([JRequest(np.asarray(p, np.int32),
                                          max_new_tokens=n_new)
                                 for p in call])
        jtoks += [r.out_tokens for r in out]
        ptoks += [r.out_tokens for r in eng.generate(_reqs(call, n_new))]
    assert ptoks == jtoks
    st = eng.stats()
    assert st["microbatches"]["total"] == 2
    assert st["plans"]["post_warmup_fresh_resolutions"] == 0
    prompts = [p for call in calls for p in call]

    def stream():
        return [Request(np.asarray(p, np.int64), max_new_tokens=n_new,
                        temperature=0.8 if i == 5 else 0.0, seed=i)
                for i, p in enumerate(prompts)]

    got = eng.generate(stream())
    refs = eng.generate_reference(stream())
    assert [r.out_tokens for r in got] == [r.out_tokens for r in refs]
    greedy = [i for i in range(len(prompts)) if i != 5]
    assert [got[i].out_tokens for i in greedy] == [ptoks[i] for i in greedy]


def test_serve_launcher_xlstm(capsys):
    from repro_torch.launch import serve as L
    assert L.main(["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu",
                   "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "mode=equal" in out and "served=2" in out
