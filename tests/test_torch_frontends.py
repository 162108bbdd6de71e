"""Port parity of the frontends and the last three configs: reduced
HuBERT-XLarge (encoder-only, audio frames), LLaVA-NeXT-34B (patch
embeddings ahead of the text) and Llama-3-405B on the JAX package's own
weights (``repro_torch.bridge.params_from_numpy``) and the same
numpy-seeded batches.

Tolerances, as in ``tests/test_torch_models.py`` and
``tests/test_torch_train.py``:

* prefill logits against the reference's ops run one by one within
  ``LOGIT_TOL_EAGER`` (1e-4), against its compiled run within
  ``LOGIT_TOL_COMPILED`` (0.05, F4).  The reference's attention is an
  online softmax over 1024-key chunks, the port's a one-pass softmax:
  at these lengths (one chunk) they differ by fp32 summation order only;
* the training loss within ``LOSS_RTOL_EAGER`` (1e-5) of the op-by-op
  reference (its gradients: ``tests/test_torch_frontends_train.py``);
* the non-gated MLP (GELU, tanh form, on the ksplit's fp32 output, then
  the bf16 cast) within one bf16 rounding of the reference's, op by op;
* greedy tokens equal, every compared step clearing 10x the tolerance
  it is compared under.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import load_all
from repro.configs.base import reduced as jreduced
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import common as JC
from repro.models import transformer as JT
from repro.obs import metrics as JM
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.tune import dispatch as JD
from repro.tune import search as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get, reduced
from repro_torch.configs import load_all as pload_all
from repro_torch.data.pipeline import make_batch
from repro_torch.models import common as PC
from repro_torch.models import transformer as PT
from repro_torch.obs import metrics as PM
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS
from test_torch_models import (LOGIT_TOL_COMPILED, LOGIT_TOL_EAGER,
                               _check_greedy, _decode_both, numpy_tree)
from test_torch_train import LOSS_RTOL_EAGER

ARCHS = ["hubert-xlarge", "llava-next-34b", "llama3-405b"]
SEQ, BATCH = 16, 2
#: full configs whose attention keeps the reference's padded geometry
#: (``tp`` = 16); the others keep their published heads at ``tp`` = 1
PADDED = {"llava-next-34b", "llama3-405b"}


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


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(jax cfg, jax params, port cfg, port params) of the reduced arch
    with the same weights."""
    jcfg = jreduced(load_all()[name], tp=2)
    pcfg = reduced(get(name))
    jp = jax.jit(JT.init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jcfg)
    return jcfg, jp, pcfg, params_from_numpy(numpy_tree(jp), pcfg, "cpu")


def _batches(name, kind, seed=0, step=0):
    """(reference batch, port batch): the same draws."""
    jcfg, _, pcfg, _ = _pair(name)
    jb = jmake_batch(jcfg, SEQ, BATCH, kind=kind, seed=seed, step=step)
    pb = make_batch(pcfg, SEQ, BATCH, kind=kind, seed=seed, step=step,
                    device="cpu")
    for k, v in jb.items():
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(v))
    return jb, pb


def _all_logits_jax(jp, jcfg, batch):
    x, pos = JT._embed_inputs(jp, jcfg, batch)
    x, _ = JT._run_segments(jp, jcfg, x, pos, remat=False)
    x = JC.rms_norm(x, jp["final_norm"], jcfg.norm_eps)
    return np.asarray(jp["lm_head"](x), np.float32)


def _all_logits_port(pp, pcfg, batch):
    with torch.no_grad():
        x, _ = PT._run_layers(pp, pcfg, batch)
        x = PC.rms_norm(x, pp["final_norm"], pcfg.norm_eps)
        return pp["lm_head"](x).numpy()


def test_configs_and_frontend_layout():
    """The three configs field for field (with the reduced shrink of
    ``frontend_dim``/``n_patches``), and the frontend's projection at the
    reference's default tile and format set: reduced, one K-block of 32."""
    for name in ARCHS:
        jcfg, jp, pcfg, pp = _pair(name)
        for f in ("frontend", "frontend_dim", "n_patches", "encoder_only",
                  "gated_mlp", "use_rope", "family", "n_layers", "tp"):
            assert getattr(pcfg, f) == getattr(jcfg, f), (name, f)
        if pcfg.frontend == "none":
            assert "frontend_proj" not in pp
            continue
        w, jw = pp["frontend_proj"].w, jp["frontend_proj"].w
        assert (w.tile, w.shape, w.fset.key()) == (jw.tile, jw.shape,
                                                   jw.fset.key())
        assert w.shape == (32, 64) and len(w.k_cls) == 1
        np.testing.assert_array_equal(w.k_cls, np.asarray(jw.k_cls.arr))
    assert set(_pair("hubert-xlarge")[3]) >= {"frontend_proj", "pos_embed"}
    assert _pair("hubert-xlarge")[3]["pos_embed"].shape == (65536, 64)
    assert "pos_embed" not in _pair("llava-next-34b")[3]


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_match_reference(name):
    jcfg, jp, pcfg, pp = _pair(name)
    jb, pb = _batches(name, "prefill", seed=1)
    compiled = jax.jit(lambda p, b: JT.forward_prefill(p, jcfg, b))(jp, jb)
    with jax.disable_jit():
        eager = JT.forward_prefill(jp, jcfg, jb)
    with torch.no_grad():
        port = PT.forward_prefill(pp, pcfg, pb).numpy()
    assert port.shape == (BATCH, 1, pcfg.vocab)
    assert np.abs(port - np.asarray(eager, np.float32)).max() \
        <= LOGIT_TOL_EAGER
    assert np.abs(port - np.asarray(compiled, np.float32)).max() \
        <= LOGIT_TOL_COMPILED


def test_gelu_mlp_matches_reference_op_by_op():
    """HuBERT's non-gated MLP on the same weights and input: GELU (tanh
    form) on the ksplit's fp32 output, then the bf16 cast, within one
    bf16 rounding of the reference's."""
    jcfg, jp, pcfg, pp = _pair("hubert-xlarge")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    jmlp = jax.tree.map(lambda a: a[0], jp["blocks"][0]["pos0"]["mlp"])
    with jax.disable_jit():
        want = np.asarray(JC.mlp_block(
            jmlp, jnp.asarray(x).astype(jnp.bfloat16)), np.float32)
    assert "gate" not in pp["layers"][0]["mlp"]
    with torch.no_grad():
        got = PC.mlp_block(pp["layers"][0]["mlp"],
                           torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** -7 * np.abs(want)
    assert np.all(np.abs(got - want) <= ulp + 1e-30)
    assert np.mean(got == want) > 0.99


def test_encoder_attends_both_ways():
    """Changing only the last frame moves position 0's logits, in both
    packages; in the causal LLaVA decoder a change to the last token
    leaves position 0 alone."""
    jcfg, jp, pcfg, pp = _pair("hubert-xlarge")
    jb, pb = _batches("hubert-xlarge", "prefill", seed=3)
    frames = pb["frames"].clone()
    frames[:, -1] += 1.0
    moved = {"frames": frames}
    jl0 = _all_logits_jax(jp, jcfg, jb)
    jl1 = _all_logits_jax(jp, jcfg, {"frames": jnp.asarray(frames.numpy())})
    pl0 = _all_logits_port(pp, pcfg, pb)
    pl1 = _all_logits_port(pp, pcfg, moved)
    assert np.abs(jl1[:, 0] - jl0[:, 0]).max() > 1e-3
    assert np.abs(pl1[:, 0] - pl0[:, 0]).max() > 1e-3
    assert np.abs(pl0 - jl0).max() <= LOGIT_TOL_COMPILED
    assert np.abs(pl1 - jl1).max() <= LOGIT_TOL_COMPILED
    _, _, lcfg, lp = _pair("llava-next-34b")
    _, lb = _batches("llava-next-34b", "prefill", seed=3)
    toks = lb["tokens"].clone()
    toks[:, -1] = (toks[:, -1] + 1) % lcfg.vocab
    a = _all_logits_port(lp, lcfg, lb)
    b = _all_logits_port(lp, lcfg, dict(lb, tokens=toks))
    np.testing.assert_array_equal(a[:, :-1], b[:, :-1])


def test_vision_puts_patches_first_and_labels_on_text():
    """LLaVA's sequence is [patches, text]: its loss is the cross entropy
    of the last S - P positions against ``labels`` [B, S - P], equal to
    the reference's; changing the patch embeddings moves the last text
    position's logits."""
    jcfg, jp, pcfg, pp = _pair("llava-next-34b")
    jb, pb = _batches("llava-next-34b", "train", seed=4)
    P = pcfg.n_patches
    assert pb["labels"].shape == (BATCH, SEQ - P)
    assert pb["tokens"].shape == (BATCH, SEQ - P)
    assert pb["patch_embeds"].shape == (BATCH, P, pcfg.frontend_dim)
    with torch.no_grad():
        x, _ = PT._embed_inputs(pp, pcfg, pb)
        pe = pp["frontend_proj"](pb["patch_embeds"].to(torch.bfloat16))
        assert torch.equal(x[:, :P], pe.to(torch.bfloat16))
        assert torch.equal(x[:, P:], pp["embed"][pb["tokens"].long()])
        loss, _ = PT.forward_train(pp, pcfg, pb)
    logits = _all_logits_port(pp, pcfg, pb)[:, P:]
    want = PC.cross_entropy(torch.from_numpy(logits), pb["labels"])
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    with jax.disable_jit():
        jloss = JT.forward_train(jp, jcfg, jb)[0]
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=LOSS_RTOL_EAGER)
    moved = dict(pb, patch_embeds=pb["patch_embeds"] * 0.5)
    with torch.no_grad():
        a = PT.forward_prefill(pp, pcfg, pb)
        b = PT.forward_prefill(pp, pcfg, moved)
    assert float((a - b).abs().max()) > 1e-3


def test_inputs_the_frontends_refuse():
    """No decode step for the encoder (ValueError, as in the reference);
    a bare token tensor stands for a batch only without a frontend."""
    for name in ("hubert-xlarge", "llava-next-34b"):
        _, _, pcfg, pp = _pair(name)
        with pytest.raises(ValueError, match="batch dict"):
            PT.forward_prefill(pp, pcfg, torch.zeros((1, 4),
                                                     dtype=torch.long))
    _, jp, pcfg, pp = _pair("hubert-xlarge")
    with pytest.raises(ValueError, match="no decode step"):
        PT.forward_decode(pp, pcfg, torch.zeros((1, 1), dtype=torch.long),
                          [], 0)
    with pytest.raises(ValueError):
        JT.forward_decode(jp, _pair("hubert-xlarge")[0],
                          jnp.zeros((1, 1), jnp.int32),
                          JT.init_cache(_pair("hubert-xlarge")[0], 1, 8), 0)


def test_llava_engine_matches_jax_engine():
    """Reduced LLaVA served in equal mode on text tokens (the reference's
    engine embeds tokens alone): the port's greedy tokens equal the JAX
    engine's, its ops run one by one."""
    jcfg, jp, pcfg, pp = _pair("llava-next-34b")
    kw = dict(max_batch=2, max_seq=16, buckets=(4, 8))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, pcfg.vocab, n) for n in (4, 4, 6)]
    jeng = JEngine(jcfg, jp, JServeConfig(**kw))
    eng = Engine(pcfg, pp, ServeConfig(**kw))
    assert jeng.mode == eng.mode == "equal"
    eng.warmup()
    with jax.disable_jit():
        jout = jeng.generate([JRequest(np.asarray(p, np.int32),
                                       max_new_tokens=4) for p in prompts])
    pout = eng.generate([Request(np.asarray(p, np.int64), max_new_tokens=4)
                         for p in prompts])
    assert [r.out_tokens for r in pout] == [r.out_tokens for r in jout]
    # every greedy step clears 10x the op-by-op tolerance
    for p, r in zip(prompts, pout):
        seq = list(p) + r.out_tokens
        cache = PT.init_cache(pcfg, 1, len(seq), "cpu")
        for s in range(len(seq) - 1):
            logits, _ = PT.forward_decode(
                pp, pcfg, torch.tensor([[int(seq[s])]]), cache, s)
            if s >= len(p) - 1:
                top = torch.topk(logits[0, 0].double(), 2).values
                assert float(top[0] - top[1]) > 10 * LOGIT_TOL_EAGER


def test_llama405b_decode_matches_reference_ops():
    jcfg, jp, pcfg, pp = _pair("llama3-405b")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 6))
    with jax.disable_jit():
        steps = _decode_both(jcfg, jp, pcfg, pp, toks)
    _check_greedy(steps, LOGIT_TOL_EAGER)


@pytest.mark.parametrize("name", sorted(load_all()))
def test_attention_geometry_against_reference(name):
    """LLaVA (64 q / 16 kv) and Llama-3-405B (128 / 16) keep the
    reference's padded and duplicated heads at its 16-way axis; the other
    configs keep their published heads (the port's ``tp`` = 1), which is
    the reference's geometry at an axis of 1."""
    jcfg, pcfg = load_all()[name], pload_all()[name]
    axis = jcfg.tp if name in PADDED else 1
    jd = JC.attn_dims(jcfg.n_heads, jcfg.n_kv_heads, jcfg.d_model, axis,
                      jcfg.head_dim, jcfg.kv_dup_to_tp)
    assert dataclasses.astuple(PT.dims_of(pcfg)) == dataclasses.astuple(jd)
    if name == "llava-next-34b":
        assert (jd.n_q, jd.n_kv, jd.group) == (64, 16, 4)
    if name == "llama3-405b":
        assert (jd.n_q, jd.n_kv, jd.group) == (128, 16, 8)
    r = reduced(pcfg)
    rj = JC.attn_dims(r.n_heads, r.n_kv_heads, r.d_model, 2, r.head_dim,
                      r.kv_dup_to_tp)
    assert dataclasses.astuple(PT.dims_of(r)) == dataclasses.astuple(rj)
