"""Port parity of the MoE decoders (reduced qwen2-moe and phi3.5-moe, on
the reference's weights through the bridge): the bulk forward against
the compiled reference within ``LOGIT_TOL_COMPILED`` and 12 decode steps
against the reference's ops one by one within ``LOGIT_TOL_EAGER``
(``tests/test_torch_families.py`` holds the other families; the two are
separate files so each stays short under ``--dist loadfile``).  Reduced
qwen2 takes the K-split down (its 4 experts divide the reduced axis of
2); the N-split down is held in ``tests/test_torch_moe.py``.

A checkpoint written by either package restores in the other, for
reduced qwen2-moe and gemma3 (MoE leaves, several pattern positions and
a tail segment): the same leaf keys and hash, every leaf bit for bit."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JC
from repro_torch import tree as TR
from repro_torch.checkpoint import ckpt
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from test_torch_families import _pair, check_prefill_and_decode


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"])
def test_prefill_and_decode_match_reference(name):
    check_prefill_and_decode(name)


def test_reduced_moe_layers_bridge_as_reference():
    jcfg, jp, pcfg, pp = _pair("qwen2-moe-a2.7b")
    layer = pp["layers"][0]["moe"]
    assert isinstance(layer["down"], PM.MoEKSplit) and jcfg.moe_ep
    assert set(layer) == {"router", "gate", "up", "down", "shared"}
    jl = jp["blocks"][0]["pos0"]["moe"]
    assert layer["gate"].w_hi.shape == jl["gate"].w_hi.shape[1:]


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "gemma3-4b"])
def test_checkpoints_cross_restore(name, tmp_path):
    jcfg, jp, pcfg, pp = _pair(name)
    jpath, ppath = str(tmp_path / "j"), str(tmp_path / "p")
    JC.save(jpath, {"params": jp}, step=3)
    ckpt.save(ppath, {"params": pp}, step=3)
    jm, pm = _manifest(jpath), _manifest(ppath)
    assert pm["leaves"] == jm["leaves"] and pm["hash"] == jm["hash"]
    # the port reads the reference's checkpoint ...
    fresh = PT.init_model(torch.Generator().manual_seed(1), pcfg)
    got, man = ckpt.restore(jpath, {"params": fresh})
    assert man["step"] == 3
    for a, b in zip(TR.tensors(pp), TR.tensors(got["params"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.float(), b.float())
    # ... and the reference reads the port's
    like = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                        {"params": jp})
    jgot, _ = JC.restore(ppath, like)
    for a, b in zip(jax.tree.leaves({"params": jp}), jax.tree.leaves(jgot)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)
