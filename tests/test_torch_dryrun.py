"""The compiler-free dry run (``repro_torch.launch.dryrun``) against
``repro.launch.dryrun``: arithmetic only, no XLA compile.

* ``model_flops_estimate`` equals the reference's for every arch and
  cell, and the port's cells and shapes are the reference's;
* the per-device parameter bytes of every cell equal the reference's
  specs (its rule, ``param_spec_fn``, at the production mesh's sizes)
  applied to the shapes — the reference's ``eval_shape`` shapes where
  the port's agree, the port's attention shapes where the geometry
  differs by design (``test_torch_sharding.py``); FSDP on for training
  and off at inference, as the reference lowers them;
* the ZeRO-1 AdamW state's bytes likewise, and a cell's JSON names what
  has no counterpart without a compiler; a sweep resumes from its
  cached JSON.

Importing ``repro.launch.dryrun`` writes ``XLA_FLAGS`` (512 host
devices) at import; the test puts the variable back, so this process's
forced device count stays the conftest's.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs import load_all as jload_all
from repro.launch import sharding as JSH
from repro.optim import adamw as JA
from repro_torch import tree as TR
from repro_torch.configs import base as PB
from repro_torch.configs import get
from repro_torch.launch import dryrun as PD
from repro_torch.launch import sharding as SH
from repro_torch.optim import adamw as PA


def _import_reference_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


JD = _import_reference_dryrun()
ARCHS = sorted(jload_all())
CELLS = [(a, s) for a in ARCHS for s in JB.cells(a)]


def test_cells_and_shapes_are_the_references():
    assert PB.SHAPES == JB.SHAPES
    assert PB.LONG_OK == JB.LONG_OK
    for a in ARCHS:
        assert PB.cells(a) == JB.cells(a)
    assert PD.MICROBATCHES == JD.MICROBATCHES


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_reference(arch, shape):
    shp = JB.SHAPES[shape]
    args = (shp["seq_len"], shp["global_batch"], shp["kind"])
    jcfg, pcfg = jload_all()[arch], get(arch)
    assert PD.model_flops_estimate(pcfg, *args) == \
        JD.model_flops_estimate(jcfg, *args)


def _jax_path(path):
    """A port key path as JAX's (what the reference's rules read)."""
    tu = jax.tree_util
    out = []
    for k in path:
        if k.kind == "dict":
            out.append(tu.DictKey(k.name))
        elif k.kind == "seq":
            out.append(tu.SequenceKey(k.name))
        elif k.kind == "flat":
            out.append(tu.FlattenedIndexKey(k.name))
        else:
            out.append(tu.GetAttrKey(k.name))
    return tuple(out)


def _device_bytes(shape, spec, dtype, mesh) -> int:
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    n = 1
    for dim, entry in zip(shape, spec):
        ways = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            ways *= mesh.get(a, 1) if a is not None else 1
        n *= -(-dim // ways)
    return n * torch.empty((), dtype=dtype).element_size()


def _reference_param_bytes(arch: str, kind: str, mesh: dict):
    """Per-device bytes of the params and of the ZeRO-1 AdamW state under
    the reference's rules, on the port's shapes (the reference's own
    where they agree: test_torch_sharding.py)."""
    jcfg = jload_all()[arch]
    if kind != "train" and jcfg.fsdp:
        jcfg = dataclasses.replace(jcfg, fsdp=False)
    pcfg = get(arch)
    if kind != "train" and pcfg.fsdp:
        pcfg = dataclasses.replace(pcfg, fsdp=False)
    rule = JSH.param_spec_fn(jcfg, mesh["model"], mesh["data"])
    leaves = TR.walk(SH.param_shapes(pcfg))
    specs, shapes = {}, {}
    for leaf in leaves:
        t = leaf.parts[0]
        shape = ((len(leaf.parts),) if leaf.stacked else ()) + tuple(t.shape)
        specs[leaf.key] = rule(_jax_path(leaf.path),
                               jax.ShapeDtypeStruct(shape, np.float32))
        shapes[leaf.key] = (shape, t.dtype)
    params = sum(_device_bytes(s, specs[k], dt, mesh)
                 for k, (s, dt) in shapes.items())
    if kind != "train":
        return params, None

    class Mesh:
        shape = mesh
        axis_names = tuple(mesh)

    sds = {k: jax.ShapeDtypeStruct(s, np.float32) for k, (s, _) in
           shapes.items()}
    z = JSH.zero1_specs(specs, sds, Mesh())
    ocfg = (JA.AdamWConfig(master_weights=False, moment_dtype="bfloat16")
            if jload_all()[arch].fsdp else JA.AdamWConfig())
    mdt = torch.bfloat16 if ocfg.moment_dtype == "bfloat16" \
        else torch.float32
    opt = 2 * sum(_device_bytes(s, z[k], mdt, mesh)
                  for k, (s, _) in shapes.items())
    if ocfg.master_weights:
        opt += sum(_device_bytes(s, z[k], torch.float32, mesh)
                   for k, (s, _) in shapes.items())
    return params, opt + 4


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_bytes_follow_reference_specs(arch):
    for shape in ("train_4k", "prefill_32k"):
        got = PD.cell_bytes(arch, shape, multi_pod=True)
        params, opt = _reference_param_bytes(
            arch, JB.SHAPES[shape]["kind"], got["mesh"])
        assert got["parts"]["params"] == params, (arch, shape)
        if opt is not None:
            assert got["parts"]["opt_state"] == opt, (arch, shape)


def test_dry_cell_records_what_is_absent(tmp_path):
    res = PD.dry_cell("internlm2-1.8b", "train_4k", multi_pod=True)
    assert res["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert res["n_chips"] == 512 and res["microbatches"] == 1
    parts = res["memory"]["argument_bytes_by_part"]
    assert set(parts) == {"params", "opt_state", "batch"}
    assert res["memory"]["argument_bytes"] == sum(parts.values())
    assert "cost" in res["absent"]["fields"] and res["absent"]["reason"]
    assert "cost" not in res and "collectives" not in res
    dec = PD.dry_cell("xlstm-1.3b", "long_500k")
    assert set(dec["memory"]["argument_bytes_by_part"]) == {
        "params", "caches", "tokens", "pos"}
    # a batch-1 decode keeps the recurrent states replicated
    assert dec["memory"]["argument_bytes_by_part"]["tokens"] == 4


def test_sweep_resumes_from_cached_cells(tmp_path, capsys):
    argv = ["--arch", "gemma3-4b", "--shape", "decode_32k", "--out",
            str(tmp_path)]
    assert PD.main(argv) == 0
    path = tmp_path / "gemma3-4b__decode_32k__pod1.json"
    rec = json.loads(path.read_text())
    assert rec["kind"] == "decode" and rec["model_flops"] > 0
    capsys.readouterr()
    assert PD.main(argv) == 0
    assert "[skip cached] gemma3-4b__decode_32k__pod1" in \
        capsys.readouterr().out
