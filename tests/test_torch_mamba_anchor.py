"""The anchor of the Jamba decode-vs-bulk drift: on the same reduced
weights (the reference's, through the bridge), capacity 8.0 (nothing
drops, as in the reference's ``test_decode_consistent_with_prefill``)
and the same three prompts, the port's |decode − bulk| on the last
logits may be at most twice the JAX package's own gap, floored at one
bf16 rounding of the largest logit (2^-8·max|logit|).

The reference's gap is measured as its own
``test_decode_consistent_with_prefill`` runs it (compiled bulk forward,
compiled decode step).  At S = 128 the bulk forward is one chunk of the
Mamba scan; at S = 256 it is two, so the carry between chunks runs.  The
test prints both gaps, each also as a share of that test's tolerance
(atol 0.15 + rtol 0.1·|bulk|): on the card, ``chip_smoke.py`` phase 11
prints the same share for the full-width first period, and this is what
ties it to the reference's own behaviour.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.models import transformer as PT
from test_torch_mamba import _pair
from test_torch_xlstm_anchor import RATIO, ROWS, _gaps

CAPACITY = 8.0


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("S", [128, 256])
def test_decode_drift_within_twice_the_reference(S):
    jcfg, jp, pcfg, pp = _pair()
    jcfg = dataclasses.replace(jcfg, capacity_factor=CAPACITY)
    pcfg = dataclasses.replace(pcfg, capacity_factor=CAPACITY)
    toks = np.random.default_rng(S).integers(0, jcfg.vocab, (ROWS, S))
    jbulk = jax.jit(lambda p, b: JT.forward_prefill(p, jcfg, b))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    step = jax.jit(lambda p, t, c, s: JT.forward_decode(p, jcfg, t, c, s))
    jc = JT.init_cache(jcfg, ROWS, S)
    pbulk = PT.forward_prefill(pp, pcfg, torch.from_numpy(toks))
    pc = PT.init_cache(pcfg, ROWS, S, "cpu")
    for s in range(S):
        jdec, jc = step(jp, jnp.asarray(toks[:, s:s + 1], jnp.int32), jc,
                        jnp.int32(s))
        pdec, pc = PT.forward_decode(pp, pcfg,
                                     torch.from_numpy(toks[:, s:s + 1]),
                                     pc, s)
    ref, ref_share = _gaps(jdec, jbulk)
    port, port_share = _gaps(pdec.numpy(), pbulk.numpy())
    floor = 2.0 ** -8 * float(np.abs(np.asarray(jbulk, np.float32)).max())
    allow = max(RATIO * ref, floor)
    print(f"jamba reduced, S = {S}, {ROWS} rows: reference |decode - bulk| "
          f"{ref:.4e} ({ref_share:.3f} of its test's tolerance), port "
          f"{port:.4e} ({port_share:.3f}); allowance {allow:.4e} = "
          f"max({RATIO} x reference, 2^-8 x max|logit| = {floor:.4e})")
    assert port <= allow
