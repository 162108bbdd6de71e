"""Port parity of the Mamba-hybrid family's pieces (``repro_torch.models.
mamba``, the Jamba config) with the JAX package, and twins of the
reference's model smoke tests for ``jamba-v0.1-52b``.

Weights come from the reference's reduced model through the bridge;
inputs are drawn from numpy seeds.  The reference runs op by op
(``jax.disable_jit``), which the port follows operation for operation;
what is left is summation order:

* the associative scan inside a chunk is ``lax.associative_scan``'s
  recursion with the reference's ``combine``: elementwise products and
  sums in the same tree, so bit for bit;
* fp32 scan outputs and states: within ``2·n·2^-24·max|ref|`` with n the
  longest chain of rounded operations (the state's S multiply-adds, then
  the contraction over d_state);
* bf16 block outputs: each element within one bf16 rounding of its
  row's largest magnitude (``BF16_FLIP`` = 2^-7): the fp32 sums before
  a cast add in another order and can flip a rounding of the output, or
  of an element of ``out_proj``'s input, which moves every output of
  the row by a share of the row's scale.
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
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get, reduced
from repro_torch.models import mamba as PMB
from repro_torch.models import transformer as PT
from test_torch_families import SHARED_FIELDS, _schedule, _value
from test_torch_models import numpy_tree
from test_torch_xlstm import BF16_FLIP, _bf16, _f32, _within_order

ARCH = "jamba-v0.1-52b"


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


def _mixer(layer: int):
    """(reference Mamba params, port Mamba params) of reduced layer
    ``layer`` (main segment, repeat 0)."""
    _, jp, _, pp = _pair()
    jcell = jax.tree.map(lambda a: a[0],
                         jp["blocks"][0][f"pos{layer}"]["mamba"])
    return jcell, pp["layers"][layer]["mamba"]


def _within_bf16_flip(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    gap = np.abs(got - want)
    scale = np.maximum(np.abs(got), np.abs(want)).max(-1, keepdims=True)
    ok = gap <= BF16_FLIP * scale
    assert ok.all(), (gap.max(), int((~ok).sum()))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    """Every shared field, the layer schedule and the parameter count of
    jamba-v0.1-52b and its reduced twin equal the reference's: attention
    at layer 4 of every 8, MoE on odd layers, no RoPE."""
    jcfg, pcfg = load_all()[ARCH], get(ARCH)
    for f in SHARED_FIELDS:
        assert _value(pcfg, f) == _value(jcfg, f), f
    assert _schedule(pcfg) == _schedule(jcfg)
    assert pcfg.param_count() == jcfg.param_count()
    kinds = pcfg.layer_kinds()
    assert [i for i, (m, _) in enumerate(kinds) if m == "attn_full"] == [
        4, 12, 20, 28]
    assert all(m == "mamba" for i, (m, _) in enumerate(kinds) if i % 8 != 4)
    assert all(f == ("moe" if i % 2 else "mlp")
               for i, (_, f) in enumerate(kinds))
    assert pcfg.segments() == [(kinds[:8], 4)] and not pcfg.use_rope
    assert pcfg.tp == 1 and PT.dims_of(pcfg).n_kv == 8
    rp, rj = reduced(pcfg), jreduced(jcfg, tp=2)
    for f in SHARED_FIELDS + ["name", "tp"]:
        assert _value(rp, f) == _value(rj, f), f
    assert _schedule(rp) == _schedule(rj)


def test_param_counts_match_published():
    """Twin of the reference's test for the jamba case."""
    got = get(ARCH).param_count()
    assert abs(got - 51.6e9) / 51.6e9 < 0.03, got


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

def _combine(left, right):
    return left[0] * right[0], left[1] * right[0] + right[1]


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 128])
def test_associative_scan_is_the_references_tree(n):
    """Odd and even lengths: the same products and sums in the same tree
    as ``lax.associative_scan`` op by op, so the same bits."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)
    with jax.disable_jit():
        ja, jb = jax.lax.associative_scan(
            _combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    pa, pb = PMB._associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))


def _scan_inputs(S: int, B: int = 2, d: int = 32, n: int = 4):
    rng = np.random.default_rng(S)
    u = rng.standard_normal((B, S, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, d)) - 4.6)).astype(
        np.float32)
    Bt = rng.standard_normal((B, S, n)).astype(np.float32)
    Ct = rng.standard_normal((B, S, n)).astype(np.float32)
    A = -np.tile(np.arange(1, n + 1, dtype=np.float32), (d, 1))
    D = np.ones(d, np.float32)
    h0 = rng.standard_normal((B, d, n)).astype(np.float32)
    return u, dt, Bt, Ct, A, D, h0


@pytest.mark.parametrize("S", [8, 128, 256])
def test_ssm_chunked_matches_reference(S):
    """Bulk (chunk 128: at S = 256 two chunks, so the carry between them
    runs) and stepped at chunk 1 from the same h0, each against the
    reference's same call (the bulk op by op; the stepped one compiled,
    its S steps one by one would take a minute), and the stepped scan
    against the bulk one."""
    arrs = _scan_inputs(S)
    n_terms = S + arrs[2].shape[-1]
    with jax.disable_jit():
        jy, jh = JM._ssm_chunked(*map(jnp.asarray, arrs), chunk=128)
    jsy, jsh = jax.jit(JM._ssm_chunked, static_argnames="chunk")(
        *map(jnp.asarray, arrs), chunk=1)
    py, ph = PMB._ssm_chunked(*(torch.from_numpy(a.copy()) for a in arrs),
                              chunk=128)
    h0 = torch.from_numpy(arrs[-1].copy())
    sy, sh = PMB._ssm_chunked(*(torch.from_numpy(a.copy())
                                for a in arrs[:-1]), h0, chunk=1)
    assert sh is h0                   # decode updates the state in place
    for got, want in ((py, jy), (ph, jh), (sy, jsy), (sh, jsh), (sy, py),
                      (sh, ph)):
        _within_order(got, want, n_terms)


def test_ssm_chunk_rule_matches_reference():
    """S = 200 is neither at most one chunk nor a multiple of 128: both
    packages refuse it."""
    arrs = _scan_inputs(200)
    with pytest.raises(AssertionError):
        JM._ssm_chunked(*map(jnp.asarray, arrs), chunk=128)
    with pytest.raises(ValueError, match="multiple of the chunk 128"):
        PMB._ssm_chunked(*map(torch.from_numpy, arrs), chunk=128)


# ---------------------------------------------------------------------------
# the block and its state
# ---------------------------------------------------------------------------

def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` on both sides of torch's
    threshold of 20; the port's form agrees to the libraries' exp/log1p
    (two fp32 ulps)."""
    x = np.linspace(-40.0, 40.0, 4001, dtype=np.float32)
    got = PMB._softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2 * 2.0 ** -23, atol=0)


@pytest.mark.parametrize("S", [8, 256])
def test_mamba_block_matches_reference(S):
    jcell, pcell = _mixer(0)
    jx, px = _bf16(np.random.default_rng(S), (2, S, 64))
    with jax.disable_jit():
        jy = JM.mamba_block(jcell, jx)
    py = PMB.mamba_block(pcell, px)
    assert py.dtype == torch.bfloat16
    _within_bf16_flip(py, jy)


def test_mamba_block_decode_matches_reference():
    """Six steps through the state: outputs within a bf16 flip, the
    states within the order bound, h updated in place."""
    jcell, pcell = _mixer(2)
    jst = JM.init_mamba_state(2, 64, d_state=4)
    pst = PMB.init_mamba_state(2, 64, d_state=4, device="cpu")
    h = pst["h"]
    rng = np.random.default_rng(5)
    for _ in range(6):
        jx, px = _bf16(rng, (2, 1, 64))
        with jax.disable_jit():
            jy, jst = JM.mamba_block(jcell, jx, state=jst)
        py, pst = PMB.mamba_block(pcell, px, state=pst)
        _within_bf16_flip(py, jy)
        assert pst["h"] is h
    _within_order(pst["h"], jst["h"], 6 + 4)
    _within_order(pst["conv"], jst["conv"], 1)


def test_init_mamba_state_matches_reference():
    j = JM.init_mamba_state(3, 64, expand=2, d_state=4)
    p = PMB.init_mamba_state(3, 64, expand=2, d_state=4, device="cpu")
    assert set(p) == set(j)
    for k in j:
        assert tuple(p[k].shape) == j[k].shape
        assert p[k].dtype == torch.float32 and j[k].dtype == jnp.float32
        assert not p[k].any()


def test_init_mamba_matches_reference_layout():
    """A port-initialised mixer has the reference's leaves, shapes and
    dtypes, and its constants (conv_b, dt_bias, A_log, D) bit for bit."""
    jcell, _ = _mixer(0)
    own = PMB.init_mamba(torch.Generator().manual_seed(0), 64, None,
                         d_state=4, tile=16, )
    assert set(own) == set(jcell)
    for k in ("conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log",
              "D"):
        assert tuple(own[k].shape) == jcell[k].shape, k
        assert str(own[k].dtype).split(".")[-1] == str(jcell[k].dtype), k
    for k in ("conv_b", "dt_bias", "A_log", "D"):
        np.testing.assert_array_equal(own[k].numpy(), np.asarray(jcell[k]))
    assert own["in_proj"].w.shape == (64, 256)
    assert own["out_proj"].w.shape == (128, 64)


# ---------------------------------------------------------------------------
# twins of tests/test_models_smoke.py for jamba-v0.1-52b
# ---------------------------------------------------------------------------

def _own():
    cfg = reduced(get(ARCH))
    return cfg, PT.init_model(torch.Generator().manual_seed(0), cfg)


def test_prefill_shapes():
    cfg, params = _own()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    logits = PT.forward_prefill(params, cfg, toks)
    assert logits.shape == (2, 1, cfg.vocab)
    assert torch.isfinite(logits).all()


def test_decode_steps():
    cfg, params = _own()
    caches = PT.init_cache(cfg, 2, 32, "cpu")
    tok = torch.zeros((2, 1), dtype=torch.long)
    for pos in range(3):
        logits, caches = PT.forward_decode(params, cfg, tok, caches, pos)
        assert logits.shape == (2, 1, cfg.vocab)
        assert torch.isfinite(logits).all(), pos
        tok = logits.argmax(-1)


def test_decode_consistent_with_prefill():
    """Teacher-forced decode over 8 tokens agrees with the bulk forward at
    the reference test's tolerances, capacity 8.0 as there."""
    cfg = dataclasses.replace(reduced(get(ARCH)), capacity_factor=8.0)
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

