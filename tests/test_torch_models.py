"""Port parity: the dense decoder of ``repro_torch`` on the JAX package's
own weights (``reduced`` InternLM2-1.8B, handed over through
``repro_torch.bridge.params_from_numpy``).

Two references, two tolerances:

* the reference's ops, run op by op (``jax.disable_jit`` inside the
  test): every bf16 activation is rounded where the reference's code
  rounds it, so only fp32 summation order differs — logits agree to
  ``LOGIT_TOL_EAGER`` (1e-4 on logits of magnitude ~3);
* the reference as it runs (its decode ``scan`` is compiled, and XLA
  folds some bf16 round trips inside the fused loop): logits agree to
  ``LOGIT_TOL_COMPILED`` (0.05 — measured drift 0.015–0.035 at this
  size).

Greedy tokens must be equal, and every compared step must have a top-2
logit margin above 10× the tolerance it is compared under, so a near-tie
fails loudly instead of flaking.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import load_all
from repro.configs.base import reduced as jreduced
from repro.core.layout import KSplitWeight as JKSplit
from repro.core.layout import NSplitWeight as JNSplit
from repro.core.linear import MPLinear as JMPLinear
from repro.models import transformer as JT
from repro.models.moe import MoEKSplit as JMoEKSplit
from repro.models.moe import MoENSplit as JMoENSplit
from repro.obs import metrics as JM
from repro.tune import dispatch as JD
from repro.tune import search as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get, reduced
from repro_torch.models import common as PC
from repro_torch.models import transformer as PT
from repro_torch.obs import metrics as PM
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS

LOGIT_TOL_EAGER = 1e-4
LOGIT_TOL_COMPILED = 0.05


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Both packages' tune state confined to this test (their own plan
    caches under tmp_path, fresh registries and metrics)."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setattr(JD, "_REGISTRY", {})
    monkeypatch.setattr(JS, "_default_cache", None)
    monkeypatch.setattr(JM, "_DEFAULT", JM.MetricsRegistry())
    monkeypatch.setenv(PS.CACHE_ENV, str(tmp_path / "torch.json"))
    monkeypatch.setattr(PD, "_REGISTRY", {})
    monkeypatch.setattr(PS, "_default_cache", None)
    monkeypatch.setattr(PM, "_DEFAULT", PM.MetricsRegistry())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(node):
    """The reference's parameter tree as numpy arrays plus class maps (the
    bridge's input format)."""
    if isinstance(node, (JMoEKSplit, JMoENSplit)):
        ks = isinstance(node, JMoEKSplit)
        return {"kind": "moe_ksplit" if ks else "moe_nsplit",
                "w_hi": np.asarray(node.w_hi), "w_lo": np.asarray(node.w_lo),
                "cls": np.asarray((node.k_cls if ks else node.n_cls).arr),
                "tile": node.tile, "shape": node.shape}
    if isinstance(node, JMPLinear):
        w = node.w
        b = None if node.b is None else np.asarray(node.b)
        if isinstance(w, (JKSplit, JNSplit)):
            cls = w.k_cls.arr if isinstance(w, JKSplit) else w.n_cls.arr
            return {"kind": "ksplit" if isinstance(w, JKSplit) else "nsplit",
                    "bufs": [np.asarray(x) for x in w.bufs],
                    "cls": np.asarray(cls), "tile": w.tile,
                    "shape": w.shape, "formats": w.fset.key(), "b": b}
        return {"kind": "dense", "w": np.asarray(w), "b": b}
    if isinstance(node, dict):
        return {k: numpy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [numpy_tree(v) for v in node]
    return np.asarray(node)


def reduced_pair(seed=0):
    """(jax cfg, jax params, port cfg, port params) of reduced
    InternLM2-1.8B with the same weights."""
    jcfg = jreduced(load_all()["internlm2-1.8b"], tp=2)
    jparams = JT.init_model(jax.random.PRNGKey(seed), jcfg)
    pcfg = reduced(get("internlm2-1.8b"))
    pparams = params_from_numpy(numpy_tree(jparams), pcfg, "cpu")
    return jcfg, jparams, pcfg, pparams


@pytest.fixture(scope="module")
def pair():
    return reduced_pair()


def test_reduced_configs_agree(pair):
    jcfg, _, pcfg, pparams = pair
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "head_dim", "rope_theta", "norm_eps", "mp_tile",
              "mp_formats", "serve_buckets"):
        assert getattr(pcfg, f) == getattr(jcfg, f), f
    from repro.models.common import attn_dims
    jd = attn_dims(jcfg.n_heads, jcfg.n_kv_heads, jcfg.d_model, jcfg.tp,
                   jcfg.head_dim, jcfg.kv_dup_to_tp)
    assert (PT.dims_of(pcfg).n_q, PT.dims_of(pcfg).n_kv) == (jd.n_q, jd.n_kv)
    assert len(pparams["layers"]) == jcfg.n_layers


def _decode_both(jcfg, jp, pcfg, pp, toks):
    B, S = toks.shape
    jc = JT.init_cache(jcfg, B, 32)
    pc = PT.init_cache(pcfg, B, 32, "cpu")
    out = []
    for s in range(S):
        jl, jc = JT.forward_decode(jp, jcfg,
                                   jnp.asarray(toks[:, s:s + 1], jnp.int32),
                                   jc, s)
        pl, pc = PT.forward_decode(pp, pcfg,
                                   torch.from_numpy(toks[:, s:s + 1]), pc, s)
        out.append((np.asarray(jl, np.float32)[:, 0], pl.numpy()[:, 0]))
    return out


def _check_greedy(steps, tol):
    for jl, pl in steps:
        assert np.abs(jl - pl).max() <= tol
        top2 = np.sort(jl, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        assert np.all(margin > 10 * tol), (
            f"near-tie: top-2 margin {margin.min():.3g} <= 10 x {tol}")
        np.testing.assert_array_equal(jl.argmax(-1), pl.argmax(-1))


def test_decode_logits_and_greedy_tokens_match_reference_ops(pair):
    jcfg, jp, pcfg, pp = pair
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 6))
    with jax.disable_jit():
        steps = _decode_both(jcfg, jp, pcfg, pp, toks)
    _check_greedy(steps, LOGIT_TOL_EAGER)


def test_decode_logits_match_compiled_reference(pair):
    jcfg, jp, pcfg, pp = pair
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 6))
    steps = _decode_both(jcfg, jp, pcfg, pp, toks)
    for jl, pl in steps:
        assert np.abs(jl - pl).max() <= LOGIT_TOL_COMPILED


def test_prefill_matches_stepped_decode(pair):
    """Causal prefill attention and the stepped decode give the same
    last-position logits (inside the port)."""
    _, _, pcfg, pp = pair
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, pcfg.vocab, (2, 7)))
    last = PT.forward_prefill(pp, pcfg, toks)[:, 0]
    cache = PT.init_cache(pcfg, 2, 16, "cpu")
    for s in range(7):
        logits, cache = PT.forward_decode(pp, pcfg, toks[:, s:s + 1], cache,
                                          s)
    torch.testing.assert_close(last, logits[:, 0], rtol=0, atol=0.05)


def test_masked_decode_with_per_row_positions(pair):
    """Per-row positions + kv_valid (right-padded rows) give each row the
    same logits it gets decoding alone."""
    _, _, pcfg, pp = pair
    rng = np.random.default_rng(2)
    a = rng.integers(0, pcfg.vocab, 3)
    b = rng.integers(0, pcfg.vocab, 5)
    # batched: right-pad a to 5, step the prompt, then one masked decode
    toks = np.zeros((2, 5), np.int64)
    toks[0, :3], toks[1] = a, b
    cache = PT.init_cache(pcfg, 2, 16, "cpu")
    for s in range(5):
        _, cache = PT.forward_decode(pp, pcfg, torch.from_numpy(
            toks[:, s:s + 1]), cache, s)
    pos = torch.tensor([3, 5])
    nxt = torch.tensor([[7], [9]])
    valid = torch.arange(16)[None, :] <= pos[:, None]
    batched, _ = PT.forward_decode(pp, pcfg, nxt, cache, pos, slot=pos,
                                   kv_valid=valid)
    for row, prompt, tok in ((0, a, 7), (1, b, 9)):
        c1 = PT.init_cache(pcfg, 2, 16, "cpu")
        for s in range(len(prompt)):
            _, c1 = PT.forward_decode(pp, pcfg, torch.from_numpy(
                np.tile(prompt[s:s + 1], (2, 1))), c1, s)
        alone, _ = PT.forward_decode(pp, pcfg, torch.full((2, 1), tok), c1,
                                     len(prompt))
        assert torch.equal(alone[0, 0], batched[row, 0])
    with pytest.raises(ValueError):
        PT.forward_decode(pp, pcfg, nxt, cache, pos)


def test_attn_dims_pad_and_duplicate():
    d = PC.attn_dims(16, 8, 2048)
    assert (d.n_q, d.n_kv, d.group) == (16, 8, 2)
    d = PC.attn_dims(16, 8, 2048, model_axis=16, kv_dup_to_tp=True)
    assert (d.n_q, d.n_kv) == (16, 16)
