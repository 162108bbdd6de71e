"""Port parity of the xLSTM family's pieces (``repro_torch.models.xlstm``,
``models.mamba._conv1d_causal``, the xLSTM config) with the JAX package,
and twins of the reference's model smoke tests for ``xlstm-1.3b``.

Weights come from the reference's reduced model through the bridge;
inputs are drawn from numpy seeds.  The reference runs op by op
(``jax.disable_jit``), which the port follows operation for operation;
what is left is summation order:

* bf16 block outputs: each element within one bf16 rounding of the
  reference's (``BF16_FLIP`` = 2^-7 of the larger magnitude): the fp32
  sums before the cast add in another order and can flip a rounding;
* fp32 scan outputs and states: within ``2·n·2^-24·max|ref|`` with n the
  longest chain of summed terms (the cumsum of log forget gates over the
  sequence, then a dot over the head width).
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
from repro.models import mamba as JM
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get, reduced
from repro_torch.models import mamba as PMB
from repro_torch.models import transformer as PT
from repro_torch.models import xlstm as PX
from test_torch_families import SHARED_FIELDS, _schedule, _value
from test_torch_models import numpy_tree

ARCH = "xlstm-1.3b"
#: one bf16 rounding of an element, relative to the larger magnitude
BF16_FLIP = 2.0 ** -7
U32 = 2.0 ** -24


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = jreduced(load_all()[ARCH], tp=2)
    pcfg = reduced(get(ARCH))
    jp = jax.jit(JT.init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jcfg)
    return jcfg, jp, pcfg, params_from_numpy(numpy_tree(jp), pcfg, "cpu")


def _cell(pos: int, name: str):
    """(reference cell params, port cell params) of layer ``pos``."""
    _, jp, _, pp = _pair()
    jcell = jax.tree.map(lambda a: a[0], jp["blocks"][0][f"pos{pos}"][name])
    return jcell, pp["layers"][pos][name]


def _bf16(rng, shape):
    """The same bf16 values as a JAX and a torch array."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(
        jnp.bfloat16)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)


def _f32(a) -> np.ndarray:
    a = a.float().numpy() if torch.is_tensor(a) else a
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _within_bf16_flip(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    gap = np.abs(got - want)
    ok = gap <= BF16_FLIP * np.maximum(np.abs(got), np.abs(want))
    assert ok.all(), (gap.max(), int((~ok).sum()))


def _within_order(got, want, n_terms: int):
    got, want = _f32(got), _f32(want)
    tol = 2 * n_terms * U32 * max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    """Every shared field, the layer schedule and the parameter count of
    xlstm-1.3b and its reduced twin equal the reference's."""
    jcfg, pcfg = load_all()[ARCH], get(ARCH)
    for f in SHARED_FIELDS:
        assert _value(pcfg, f) == _value(jcfg, f), f
    assert _schedule(pcfg) == _schedule(jcfg)
    assert pcfg.param_count() == jcfg.param_count()
    kinds = pcfg.layer_kinds()
    assert kinds[0] == ("slstm", "none") and kinds[1] == ("mlstm", "none")
    assert sum(m == "mlstm" for m, _ in kinds) == 42
    assert pcfg.segments() == [(kinds[:8], 6)]
    rp, rj = reduced(pcfg), jreduced(jcfg, tp=2)
    for f in SHARED_FIELDS + ["name", "tp"]:
        assert _value(rp, f) == _value(rj, f), f
    assert _schedule(rp) == _schedule(rj)


def test_mamba_hybrid_schedule_matches_reference():
    """The hybrid fields are ported with the xLSTM ones: a jamba-shaped
    config lays out and counts its layers as the reference's does."""
    jcfg = load_all()["jamba-v0.1-52b"]
    pcfg = dataclasses.replace(
        get("llama3-8b"), **{f: _value(jcfg, f) for f in SHARED_FIELDS})
    assert _schedule(pcfg) == _schedule(jcfg)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_causal_matches_reference(with_state):
    """Elementwise work in the reference's tap order: bit for bit."""
    rng = np.random.default_rng(0)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 8, 16), (4, 16), (16,)))
    st = rng.standard_normal((2, 3, 16)).astype(np.float32) \
        if with_state else None
    jy, js = JM._conv1d_causal(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
    py, ps = PMB._conv1d_causal(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b),
                                None if st is None else torch.from_numpy(st))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("S", [8, 64, 512])
def test_mlstm_chunk_matches_reference(S):
    """The chunked scan (chunk 256: S = 512 is two chunks, so the
    inter-chunk carry runs) and its final state."""
    rng = np.random.default_rng(S)
    B, nh, dh = 2, 4, 32
    (jq, pq), (jk, pk), (jv, pv) = (_bf16(rng, (B, S, nh, dh))
                                    for _ in range(3))
    li = rng.standard_normal((B, S, nh)).astype(np.float32)
    lf = np.array(jax.nn.log_sigmoid(
        jnp.asarray(rng.standard_normal((B, S, nh)).astype(np.float32) + 3)))
    st = (np.zeros((B, nh, dh, dh), np.float32),
          np.zeros((B, nh, dh), np.float32), np.zeros((B, nh), np.float32))
    with jax.disable_jit():
        jh, jst = JX._mlstm_chunk(jq, jk, jv, jnp.asarray(li),
                                  jnp.asarray(lf),
                                  tuple(jnp.asarray(a) for a in st),
                                  chunk=256)
    ph, pst = PX._mlstm_chunk(pq, pk, pv, torch.from_numpy(li),
                              torch.from_numpy(lf),
                              tuple(torch.from_numpy(a.copy()) for a in st),
                              chunk=256)
    n = min(S, 256) + dh
    _within_order(ph, jh, n)
    for got, want in zip(pst, jst):
        _within_order(got, want, n)


def test_mlstm_chunk_rule():
    """S must be a multiple of min(chunk, S): at S = 300 the port raises
    a ValueError naming the rule where the reference's assert fails."""
    z = np.zeros((1, 300, 4, 8), np.float32)
    g = np.zeros((1, 300, 4), np.float32)
    st = (np.zeros((1, 4, 8, 8), np.float32), np.zeros((1, 4, 8), np.float32),
          np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError, match="S % chunk == 0"):
        PX._mlstm_chunk(*(torch.from_numpy(a) for a in (z, z, z, g, g)),
                        tuple(torch.from_numpy(a) for a in st), chunk=256)
    with pytest.raises(AssertionError):
        JX._mlstm_chunk(*(jnp.asarray(a) for a in (z, z, z, g, g)),
                        tuple(jnp.asarray(a) for a in st), chunk=256)


def _block_parity(pos, name, S):
    jcell, pcell = _cell(pos, name)
    jf, pf = getattr(JX, name + "_block"), getattr(PX, name + "_block")
    rng = np.random.default_rng(S)
    xj, xt = _bf16(rng, (2, S, 64))
    with jax.disable_jit():
        want = jf(jcell, xj, n_heads=4)
    _within_bf16_flip(pf(pcell, xt, n_heads=4), want)
    # decode: six steps through the state, the outputs and every state leaf
    js = (JX.init_mlstm_state(2, 64, 4) if name == "mlstm"
          else JX.init_slstm_state(2, 64, 4))
    ps = (PX.init_mlstm_state(2, 64, 4, device="cpu") if name == "mlstm"
          else PX.init_slstm_state(2, 64, 4, device="cpu"))
    assert set(ps) == set(js)
    assert all(t.dtype == torch.float32 for t in ps.values())
    for s in range(6):
        with jax.disable_jit():
            jo, js = jf(jcell, xj[:, s:s + 1], n_heads=4, state=js)
        po, new = pf(pcell, xt[:, s:s + 1], n_heads=4, state=ps)
        ps.update(new)
        _within_bf16_flip(po, jo)
        for key in js:
            _within_order(ps[key], js[key], s + 1 + 32)


@pytest.mark.parametrize("S", [8, 64])
def test_mlstm_block_matches_reference(S):
    _block_parity(1, "mlstm", S)


@pytest.mark.parametrize("S", [8, 64])
def test_slstm_block_matches_reference(S):
    _block_parity(0, "slstm", S)


def test_mlstm_decode_updates_state_in_place():
    """A decode step writes the cache's C in place (no copy of the
    largest state) and replaces n, m and conv."""
    _, pcell = _cell(1, "mlstm")
    st = PX.init_mlstm_state(2, 64, 4, device="cpu")
    c_ptr = st["C"].data_ptr()
    x = torch.randn((2, 1, 64), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    _, new = PX.mlstm_block(pcell, x, n_heads=4, state=st)
    assert new["C"].data_ptr() == c_ptr and st["C"].abs().sum() > 0


# ---------------------------------------------------------------------------
# twins of tests/test_models_smoke.py for xlstm-1.3b
# ---------------------------------------------------------------------------

def test_decode_consistent_with_prefill():
    """Teacher-forced decode over 8 tokens agrees with the bulk forward,
    at the reference test's tolerances."""
    cfg = reduced(get(ARCH))
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (1, 8)))
    bulk = PT.forward_prefill(params, cfg, toks)
    caches = PT.init_cache(cfg, 1, 16, "cpu")
    for s in range(toks.shape[1]):
        logits, caches = PT.forward_decode(params, cfg, toks[:, s:s + 1],
                                           caches, s)
    np.testing.assert_allclose(logits.numpy(), bulk.numpy(), rtol=0.1,
                               atol=0.15)


def test_prefill_shapes():
    cfg = reduced(get(ARCH))
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)))
    logits = PT.forward_prefill(params, cfg, toks)
    assert logits.shape == (2, 1, cfg.vocab)
    assert torch.isfinite(logits).all()


def test_decode_steps():
    cfg = reduced(get(ARCH))
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    caches = PT.init_cache(cfg, 2, 32, "cpu")
    tok = torch.zeros((2, 1), dtype=torch.long)
    for pos in range(3):
        logits, caches = PT.forward_decode(params, cfg, tok, caches, pos)
        assert logits.shape == (2, 1, cfg.vocab)
        assert torch.isfinite(logits).all(), pos
        tok = logits.argmax(-1)


def test_port_tree_has_reference_leaves():
    """The bridged tree and a port-initialised one have the reference's
    leaf paths, order and shapes (``repro_torch.tree.walk``)."""
    from repro_torch import tree as TR
    jcfg, jp, pcfg, pp = _pair()
    own = PT.init_model(torch.Generator().manual_seed(0), pcfg)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    for tree in (pp, own):
        leaves = TR.walk(tree)
        assert [leaf.name for leaf in leaves] == [
            "/".join(str(k) for k in p) for p, _ in jleaves]
        for leaf, (_, a) in zip(leaves, jleaves):
            shape = tuple(leaf.parts[0].shape)
            if leaf.stacked:
                shape = (len(leaf.parts),) + shape
            assert shape == tuple(a.shape), leaf.name
