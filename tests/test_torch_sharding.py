"""Port parity: ``repro_torch.launch.sharding``'s path rules against
``repro.launch.sharding``, leaf by leaf, from shapes alone.

The reference's trees come from ``jax.eval_shape`` of its ``init_model``
and ``init_cache``; the port's from ``init_model`` on the meta device
(``sharding.param_shapes``: nothing is allocated, Llama-3-405B included)
and ``init_cache(device="meta")``, walked by ``repro_torch.tree`` under
the reference's key paths.  Every leaf key and every spec must agree.
Where the attention geometry differs by design (the port keeps the
published heads at ``tp`` = 1 except for LLaVA-NeXT-34B and
Llama-3-405B: ``tests/test_torch_frontends.py::
test_attention_geometry_against_reference``), the port's spec must be the
reference's rule applied to the port's shape, and only attention leaves
may differ in shape.  Here half the full configs on the production mesh
(16 x 16) and the twin of ``tests/test_system.py::
test_sharding_specs_cover_all_archs``; ``test_torch_sharding_state.py``
holds the other full configs, the reduced ones on a (4 x 2) mesh and the
ZeRO-1, AdamW-state, batch and cache specs (two files, so each stays
short).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _path_str
from repro.configs import load_all as jload_all
from repro.configs import reduced as jreduced
from repro.data.pipeline import batch_spec as jbatch_spec
from repro.launch import sharding as JSH
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch.configs import get, reduced
from repro_torch.data.pipeline import batch_spec
from repro_torch.launch import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as PA

ARCHS = sorted(jload_all())
PROD = {"data": 16, "model": 16}
SMALL = {"data": 4, "model": 2}
ATTN = ("wq", "wk", "wv", "wo")


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _pad(spec, n):
    spec = tuple(spec)
    return spec + (None,) * (n - len(spec))


@functools.lru_cache(maxsize=None)
def _jax_params(name: str, small: bool):
    cfg = jload_all()[name]
    cfg = jreduced(cfg, tp=2) if small else cfg
    shapes = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0),
                                                  cfg))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return cfg, shapes, flat


def _keyed(flat, specs_tree):
    specs = jax.tree.leaves(specs_tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert len(specs) == len(flat)
    return {"/".join(_path_str(p) for p in path): (path, leaf, spec)
            for (path, leaf), spec in zip(flat, specs)}


@functools.lru_cache(maxsize=None)
def _port_params(name: str, small: bool):
    cfg = get(name)
    cfg = reduced(cfg, tp=2) if small else cfg
    params = SH.param_shapes(cfg)
    return cfg, params, SH.leaf_shapes(params)


def _agree(ref: dict, shapes: dict, specs: dict, rule, label: str) -> int:
    """Every key in order; equal specs where the shapes agree, the
    reference's rule on the port's shape where they do not (attention
    leaves only).  Returns the count of differing shapes."""
    assert list(ref) == list(specs), label
    differ = 0
    for key, (path, leaf, jspec) in ref.items():
        mine = shapes[key]
        nd = len(mine.shape)
        if tuple(leaf.shape) != tuple(mine.shape):
            differ += 1
            assert any(a in key.split("/") for a in ATTN), (label, key)
            jspec = rule(path, jax.ShapeDtypeStruct(mine.shape, np.float32))
        assert _pad(specs[key], nd) == _pad(jspec, nd), (label, key)
    return differ


#: the full configs held here on the production mesh; the others
#: (and the reduced ones) in ``test_torch_sharding_state.py``
FULL_HERE = ("llama3-405b", "gemma3-4b", "qwen2-moe-a2.7b", "llama3-8b",
             "internlm2-1.8b")
SPEC_CASES = [(n, False) for n in FULL_HERE]


@pytest.mark.parametrize("name,small", SPEC_CASES,
                         ids=[f"{n}-{'reduced' if s else 'full'}"
                              for n, s in SPEC_CASES])
def test_param_specs_match_reference(name, small):
    mesh = SMALL if small else PROD
    jcfg, shapes, flat = _jax_params(name, small)
    ref = _keyed(flat, JSH.param_specs(shapes, jcfg, FakeMesh(mesh)))
    cfg, params, pshapes = _port_params(name, small)
    assert all(t.device.type == "meta" for t in
               __import__("repro_torch").tree.tensors(params))
    specs = SH.param_specs(params, cfg, mesh)
    rule = JSH.param_spec_fn(jcfg, mesh["model"], mesh["data"])
    differ = _agree(ref, pshapes, specs, rule, name)
    # only the configs whose heads the port keeps as published differ
    padded = name in ("llava-next-34b", "llama3-405b")
    if padded or jcfg.block_type == "xlstm" or jcfg.encoder_only:
        assert differ == 0, name


def test_sharding_specs_cover_all_archs():
    """Spec generation runs for every full-size arch from shapes alone
    and assigns mesh axes to >90% of the large parameter leaves (the
    reference's rule of ``test_sharding_specs_cover_all_archs``)."""
    for name in ARCHS:
        cfg, params, shapes = _port_params(name, False)
        specs = SH.param_specs(params, cfg, PROD)
        big = sharded_big = 0
        for key, leaf in shapes.items():
            if int(np.prod(leaf.shape)) > (1 << 22):
                big += 1
                if any(a is not None for a in specs[key]):
                    sharded_big += 1
        assert not big or sharded_big / big > 0.9, (name, sharded_big, big)


def test_param_shapes_allocate_nothing():
    cfg, params, shapes = _port_params("llama3-405b", False)
    total = sum(s.nbytes for s in shapes.values())
    assert total > 5e11          # ~1.2 TB at ratio_high 0.5
    from repro_torch import tree as TR
    assert {t.device.type for t in TR.tensors(params)} == {"meta"}
    assert all(t.dtype in (torch.float32, torch.bfloat16,
                           torch.float8_e4m3fn)
               for t in TR.tensors(params))
