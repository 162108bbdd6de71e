"""Port parity of the MoE and local/global families
(``repro_torch.configs``, ``models.transformer``, ``bridge``, ``tree``,
``checkpoint``) with the JAX package.

* Config schedules: ``layer_kinds``, ``pattern_period``, ``segments``,
  ``moe_ep`` and ``param_count`` equal the reference's for every config
  the port registers, full and reduced (the twin of
  ``test_param_counts_match_published`` for the ported names); the
  expert-parallel decision stays at the reference's model axis.
* The bridge carries reduced qwen2-moe, phi3.5-moe, gemma3 and llama3-8b
  parameters across; ``forward_prefill`` (within gemma3's window) agrees
  with the reference as it runs (compiled) within ``LOGIT_TOL_COMPILED``
  (fault F4: its flash attention and XLA's folded bf16 round trips), and
  a decode that runs past the window (the ring buffer wraps) agrees with
  the reference's ops run one by one within ``LOGIT_TOL_EAGER``.  A
  routing flip between the frameworks would show as a logit gap far
  above either.  Past the window the port's bulk forward is held to the
  reference's decode: the reference's bulk band is wider (fault F8).
* Decode through the caches agrees with the bulk forward inside the
  port, as the reference's ``test_decode_consistent_with_prefill`` (its
  tolerances; MoE archs at ``capacity_factor=8.0`` as there, since bulk
  routing drops what single-token decode keeps).
* (A checkpoint of each family written by either package restores in
  the other: ``tests/test_torch_moe_models.py``.)
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DEFAULT_TP, load_all
from repro.configs.base import reduced as jreduced
from repro.models import common as JC
from repro.models import transformer as JT
from repro_torch import tree as TR
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as PB
from repro_torch.configs import get, reduced
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.quant import quantize_params
from test_torch_models import (LOGIT_TOL_COMPILED, LOGIT_TOL_EAGER,
                               numpy_tree)

ARCHS = ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "gemma3-4b",
         "llama3-8b"]
#: every field the port's ArchConfig shares with the reference's
SHARED_FIELDS = [f.name for f in dataclasses.fields(PB.ArchConfig)
                 if f.name not in ("ep_axis", "tp", "name")]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _value(cfg, field):
    v = getattr(cfg, field)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _schedule(cfg):
    return (cfg.layer_kinds(), cfg.pattern_period(), cfg.segments(),
            cfg.moe_ep, cfg.param_count())


def test_registered_configs_match_reference():
    ref = load_all()
    ported = PB.load_all()
    assert set(ported) == set(ref)
    assert PB.REFERENCE_TP == DEFAULT_TP
    for name, pcfg in ported.items():
        jcfg = ref[name]
        for f in SHARED_FIELDS:
            assert _value(pcfg, f) == _value(jcfg, f), (name, f)
        assert _schedule(pcfg) == _schedule(jcfg), name
        rp, rj = reduced(pcfg), jreduced(jcfg, tp=2)
        for f in SHARED_FIELDS + ["name", "tp"]:
            assert _value(rp, f) == _value(rj, f), (name, f)
        assert _schedule(rp) == _schedule(rj), name


def test_param_counts_match_published():
    expect = {"llama3-8b": 8.0e9, "phi3.5-moe-42b-a6.6b": 41.9e9,
              "qwen2-moe-a2.7b": 14.3e9}
    for name, want in expect.items():
        got = get(name).param_count()
        assert abs(got - want) / want < 0.03, (name, got, want)


def test_expert_parallel_decision_at_reference_axis():
    """The port's tp is 1, yet the down layout follows the reference's
    16-way axis: qwen2 (60 % 16 != 0) N-split, phi3.5 (16 % 16 == 0)
    K-split."""
    assert get("qwen2-moe-a2.7b").tp == 1
    assert not get("qwen2-moe-a2.7b").moe_ep
    assert get("phi3.5-moe-42b-a6.6b").moe_ep
    cfg = dataclasses.replace(reduced(get("qwen2-moe-a2.7b")), n_layers=1,
                              ep_axis=DEFAULT_TP)
    down = PT.init_model(torch.Generator().manual_seed(0), cfg)[
        "layers"][0]["moe"]["down"]
    assert isinstance(down, PM.MoENSplit)


def test_gemma3_segments_map_layers():
    """34 layers of period 6: five repeats of the pattern and a 4-layer
    tail, as the reference scans them."""
    cfg = get("gemma3-4b")
    assert [(len(p), r) for p, r in cfg.segments()] == [(6, 5), (4, 1)]
    segs = TR.segment_layers(cfg.n_layers, cfg.pattern_period())
    assert segs[0][5] == [5, 11, 17, 23, 29]
    assert segs[1] == [[30], [31], [32], [33]]
    kinds = cfg.layer_kinds()
    assert all(kinds[i][0] == "attn_full" for i in segs[0][5])


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(jax cfg, jax params, port cfg, port params) of the reduced arch
    with the same weights (built once per module)."""
    jcfg = jreduced(load_all()[name], tp=2)
    pcfg = reduced(get(name))
    jp = jax.jit(JT.init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jcfg)
    return jcfg, jp, pcfg, params_from_numpy(numpy_tree(jp), pcfg, "cpu")


def check_prefill_and_decode(name):
    """The bulk forward against the compiled reference, then 12 decode
    steps against the reference's ops one by one."""
    jcfg, jp, pcfg, pp = _pair(name)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 12))
    # the bulk forward within gemma3's window (8); past it see
    # test_windowed_bulk_matches_reference_decode
    jl = jax.jit(lambda p, t: JT.forward_prefill(p, jcfg, {"tokens": t}))(
        jp, jnp.asarray(toks[:, :8], jnp.int32))
    pl = PT.forward_prefill(pp, pcfg, torch.from_numpy(toks[:, :8]))
    assert np.abs(np.asarray(jl, np.float32) - pl.numpy()).max() \
        <= LOGIT_TOL_COMPILED
    # 12 steps through a 32-slot cache: gemma3's local layers (window 8)
    # hold 8 slots, so their ring buffer wraps
    jc = JT.init_cache(jcfg, 2, 32)
    pc = PT.init_cache(pcfg, 2, 32, "cpu")
    if jcfg.attn_pattern == "local_global":
        assert pc[0]["k"].shape[1] == 8 and pc[5]["k"].shape[1] == 32
    with jax.disable_jit():
        for s in range(toks.shape[1]):
            jl, jc = JT.forward_decode(
                jp, jcfg, jnp.asarray(toks[:, s:s + 1], jnp.int32), jc, s)
            pl, pc = PT.forward_decode(pp, pcfg, torch.from_numpy(
                toks[:, s:s + 1]), pc, s)
            assert np.abs(np.asarray(jl, np.float32) - pl.numpy()).max() \
                <= LOGIT_TOL_EAGER, s


@pytest.mark.parametrize("name", ["gemma3-4b", "llama3-8b"])
def test_prefill_and_decode_match_reference(name):
    """(The MoE archs: ``tests/test_torch_moe_models.py``.)"""
    check_prefill_and_decode(name)


def test_windowed_bulk_matches_reference_decode():
    """Past the window the port's bulk forward attends the last w keys,
    as the reference's decode (ring buffer) does; the reference's own
    bulk band admits the whole previous block (``ROADMAP.md`` queue 3,
    F8), so the port is held to the reference's decode here."""
    jcfg, jp, pcfg, pp = _pair("gemma3-4b")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (1, 24))
    step = jax.jit(lambda p, t, c, s: JT.forward_decode(p, jcfg, t, c, s))
    jc = JT.init_cache(jcfg, 1, 32)
    for s in range(toks.shape[1]):
        jl, jc = step(jp, jnp.asarray(toks[:, s:s + 1], jnp.int32), jc,
                      jnp.int32(s))
    pl = PT.forward_prefill(pp, pcfg, torch.from_numpy(toks))
    assert np.abs(np.asarray(jl, np.float32) - pl.numpy()).max() \
        <= LOGIT_TOL_COMPILED


@pytest.mark.parametrize("name", ARCHS)
def test_decode_consistent_with_prefill(name):
    """Teacher-forced decode over 24 tokens (three gemma3 windows) agrees
    with the bulk forward (its sliding-window attention); the reference
    test's tolerances."""
    cfg = reduced(get(name))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (1, 24)))
    bulk = PT.forward_prefill(params, cfg, toks)
    caches = PT.init_cache(cfg, 1, 32, "cpu")
    for s in range(toks.shape[1]):
        logits, caches = PT.forward_decode(params, cfg, toks[:, s:s + 1],
                                           caches, s)
    np.testing.assert_allclose(logits.numpy(), bulk.numpy(), rtol=0.1,
                               atol=0.15)


def test_window_refuses_per_row_masks():
    cfg = reduced(get("gemma3-4b"))
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    caches = PT.init_cache(cfg, 2, 16, "cpu")
    pos = torch.tensor([3, 5])
    valid = torch.arange(16)[None, :] <= pos[:, None]
    with pytest.raises(ValueError, match="full-attention only"):
        PT.forward_decode(params, cfg, torch.zeros((2, 1), dtype=torch.long),
                          caches, pos, slot=pos, kv_valid=valid)


def test_windowed_training_past_window_matches_reference_decode():
    """F8, decided for the decode's band: past the window the port trains
    on the w-key band the reference's own decode computes.  At S = 3w its
    ``forward_train`` loss equals the cross-entropy (the reference's
    ``cross_entropy``, z-loss included) of the reference's teacher-forced
    decode logits on the same weights and labels, within the loss that a
    logit drift of ``LOGIT_TOL_COMPILED`` can move (2·tol on lse − ll,
    plus the z-loss's 2·z·|lse|·tol); and it lies nearer that than the
    reference's own bulk training loss (its 2w − 1 band) does."""
    jcfg, jp, pcfg, pp = _pair("gemma3-4b")
    S = 3 * pcfg.local_window
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, S))
    labels = np.random.default_rng(5).integers(0, jcfg.vocab, (2, S))
    step = jax.jit(lambda p, t, c, s: JT.forward_decode(p, jcfg, t, c, s))
    jc = JT.init_cache(jcfg, 2, S)
    logits = []
    for s in range(S):
        lg, jc = step(jp, jnp.asarray(toks[:, s:s + 1], jnp.int32), jc,
                      jnp.int32(s))
        logits.append(lg)
    logits = jnp.concatenate(logits, axis=1)
    jlabels = jnp.asarray(labels, jnp.int32)
    want = float(JC.cross_entropy(logits, jlabels))
    lse = float(jnp.abs(jax.nn.logsumexp(logits.astype(jnp.float32),
                                         -1)).max())
    tol = 2 * LOGIT_TOL_COMPILED * (1 + 2 * 1e-4 * lse)
    loss, _ = PT.forward_train(pp, pcfg, {"tokens": torch.from_numpy(toks),
                                          "labels": torch.from_numpy(labels)})
    assert torch.isfinite(loss)
    assert abs(float(loss) - want) <= tol
    ref_bulk = float(jax.jit(lambda p, b: JT.forward_train(p, jcfg, b))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32), "labels": jlabels})[0])
    assert abs(float(loss) - want) < abs(ref_bulk - want)


def test_walk_takes_the_period_from_the_layer_list():
    """gemma3's layers all have one structure, so only the LayerList's
    period places them in the reference's segments; a plain list is
    refused rather than walked as period 1."""
    cfg = reduced(get("gemma3-4b"))
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    period = cfg.pattern_period()
    def segments(tree):
        return {"/".join(leaf.key.split("/")[1:3])
                for leaf in TR.walk(tree) if leaf.key.startswith("blocks/")}

    tail = cfg.n_layers % period
    want = {f"[0]/pos{q}" for q in range(period)} | {
        f"[1]/pos{q}" for q in range(tail)}
    assert segments(params) == want
    assert segments(quantize_params(params)) == want   # a rebuilt list
    with pytest.raises(TypeError, match="LayerList"):
        TR.walk(dict(params, layers=list(params["layers"])))
