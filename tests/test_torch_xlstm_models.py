"""The reduced xLSTM model through the bridge against the JAX package:
the port's ``forward_prefill`` and ``forward_decode`` against the
reference's op-by-op logits (within ``LOGIT_TOL_EAGER``: the port
follows the reference operation for operation) and against its compiled
logits.  The compiled reference differs from its own op-by-op run (fault
F4: XLA folds bf16 round trips; for xLSTM by ~0.13 on logits of ~3, more
than the dense family's ``LOGIT_TOL_COMPILED``), so the compiled
comparison is held to that gap, measured on the same inputs, plus
``LOGIT_TOL_EAGER``: the triangle inequality through the op-by-op run.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import load_all
from repro.configs.base import reduced as jreduced
from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get, reduced
from repro_torch.models import transformer as PT
from test_torch_models import LOGIT_TOL_EAGER, numpy_tree

ARCH = "xlstm-1.3b"


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


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _check(port, eager, compiled):
    assert _gap(port, eager) <= LOGIT_TOL_EAGER
    assert _gap(port, compiled) <= _gap(compiled, eager) + LOGIT_TOL_EAGER


def test_prefill_matches_reference():
    jcfg, jp, pcfg, pp = _pair()
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 12))
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    compiled = jax.jit(lambda p, b: JT.forward_prefill(p, jcfg, b))(jp, batch)
    with jax.disable_jit():
        eager = JT.forward_prefill(jp, jcfg, batch)
    port = PT.forward_prefill(pp, pcfg, torch.from_numpy(toks))
    _check(port.numpy(), eager, compiled)


def test_decode_matches_reference():
    """Eight steps through the recurrent caches, every step's logits."""
    jcfg, jp, pcfg, pp = _pair()
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 8))
    step = jax.jit(lambda p, t, c, s: JT.forward_decode(p, jcfg, t, c, s))
    je = jc = JT.init_cache(jcfg, 2, 16)
    pc = PT.init_cache(pcfg, 2, 16, "cpu")
    for s in range(toks.shape[1]):
        t = jnp.asarray(toks[:, s:s + 1], jnp.int32)
        with jax.disable_jit():
            eager, je = JT.forward_decode(jp, jcfg, t, je, s)
        compiled, jc = step(jp, t, jc, jnp.int32(s))
        port, pc = PT.forward_decode(pp, pcfg, torch.from_numpy(
            toks[:, s:s + 1]), pc, s)
        _check(port.numpy(), eager, compiled)
