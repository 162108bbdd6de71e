"""Port parity, continued from ``test_torch_sharding.py`` (whose
helpers it shares): the other half of the full configs' param specs, the
reduced MoE, hybrid and recurrent configs' on a (4 x 2) mesh, and the ZeRO-1, AdamW-state, batch and decode
cache specs against ``repro.launch.sharding``, from shapes alone.
"""
import jax
import numpy as np
import pytest

from repro.configs import load_all as jload_all
from repro.data.pipeline import batch_spec as jbatch_spec
from repro.launch import sharding as JSH
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch.configs import get
from repro_torch.data.pipeline import batch_spec
from repro_torch.launch import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as PA
import test_torch_sharding as TS
from test_torch_sharding import (ARCHS, FULL_HERE, PROD, SMALL, FakeMesh,
                                 _agree, _jax_params, _keyed, _pad,
                                 _port_params)

REDUCED = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b",
           "xlstm-1.3b")


@pytest.mark.parametrize("name", [n for n in ARCHS if n not in FULL_HERE])
def test_full_param_specs_match_reference(name):
    """The full configs ``test_torch_sharding.py`` leaves to this file."""
    TS.test_param_specs_match_reference(name, False)


@pytest.mark.parametrize("name", REDUCED)
def test_reduced_param_specs_match_reference(name):
    """The reduced configs at tp = 2 (experts parallel where 4 % 2 == 0)
    on a (4 x 2) mesh."""
    jcfg, shapes, flat = _jax_params(name, True)
    ref = _keyed(flat, JSH.param_specs(shapes, jcfg, FakeMesh(SMALL)))
    cfg, params, pshapes = _port_params(name, True)
    specs = SH.param_specs(params, cfg, SMALL)
    _agree(ref, pshapes, specs, JSH.param_spec_fn(jcfg, 2, 4), name)


@pytest.mark.parametrize("name", ["internlm2-1.8b", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b", "xlstm-1.3b"])
def test_zero1_and_opt_state_specs_match_reference(name):
    jcfg, shapes, flat = _jax_params(name, False)
    mesh = FakeMesh(PROD)
    jp = JSH.param_specs(shapes, jcfg, mesh)
    jz = _keyed(flat, JSH.zero1_specs(jp, shapes, mesh))
    cfg, params, pshapes = _port_params(name, False)
    ps = SH.param_specs(params, cfg, PROD)
    z = SH.zero1_specs(ps, pshapes, PROD)
    for key, (_, leaf, jspec) in jz.items():
        if tuple(leaf.shape) == pshapes[key].shape:
            nd = len(leaf.shape)
            assert _pad(z[key], nd) == _pad(jspec, nd), key
    ocfg = PA.AdamWConfig(master_weights=not cfg.fsdp)
    o = SH.opt_state_specs(pshapes, ps, ocfg, PROD)
    jo = JSH.opt_state_specs(shapes, jp, JA.AdamWConfig(
        master_weights=not cfg.fsdp), mesh)
    assert o["mu"] == o["nu"] == z and o["count"] == SH.P()
    assert (o["master"] is None) == (jo.master is None)


@pytest.mark.parametrize("name", ["internlm2-1.8b", "hubert-xlarge",
                                  "llava-next-34b"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_batch_specs_match_reference(name, kind):
    for mesh in (PROD, {"pod": 2, "data": 16, "model": 16}):
        jspec = jbatch_spec(jload_all()[name], 256, 64, kind)
        ref = JSH.batch_specs(jspec, FakeMesh(mesh))
        got = SH.batch_specs(batch_spec(get(name), 256, 64, kind), mesh)
        assert set(got) == set(ref)
        for k in got:
            assert tuple(got[k]) == tuple(ref[k]), (name, kind, k)


@pytest.mark.parametrize("name,batch", [
    ("qwen2-moe-a2.7b", 128), ("qwen2-moe-a2.7b", 1), ("gemma3-4b", 128),
    ("jamba-v0.1-52b", 1), ("xlstm-1.3b", 128), ("llama3-405b", 1)])
def test_cache_specs_match_reference(name, batch):
    """Decode caches: batch over "data" (and kv heads over "model") when
    the batch divides, else the sequence over "data"; recurrent states by
    their batch."""
    jcfg = jload_all()[name]
    seq = 256
    jshapes = jax.eval_shape(lambda: JT.init_cache(jcfg, batch, seq))
    flat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    mesh = FakeMesh(PROD)
    ref = _keyed(flat, JSH.cache_specs(jshapes, jcfg, mesh, batch=batch))
    cfg = get(name)
    caches = T.init_cache(cfg, batch, seq, device="meta")
    from repro_torch import tree as TR
    shapes = SH.leaf_shapes({TR.LAYERS: TR.LayerList(
        caches, cfg.pattern_period())})
    specs = SH.cache_specs(shapes, cfg, PROD, batch=batch)
    mine = {k.removeprefix("blocks/"): v for k, v in specs.items()}
    mine_shapes = {k.removeprefix("blocks/"): v for k, v in shapes.items()}
    assert list(mine) == list(ref)
    for key, (_, leaf, jspec) in ref.items():
        shape = mine_shapes[key].shape
        if tuple(leaf.shape) != shape:     # kv heads as published
            one = {key.split("/")[-1]: jax.ShapeDtypeStruct(shape,
                                                            np.float32)}
            jspec = JSH.cache_specs(one, jcfg, mesh, batch=batch)[
                key.split("/")[-1]]
        assert _pad(mine[key], len(shape)) == _pad(jspec, len(shape)), key
