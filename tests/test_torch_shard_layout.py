"""Which rank holds which box of a leaf: ``launch.mesh._box`` (the layout
``distribute``, ``local_slice``, ``gather_to_origin`` and the re-meshing
restore all use) against ``jax.sharding.NamedSharding.
devices_indices_map`` of the same spec on the same mesh shape.

The specs are the port's own (equal to the reference's:
``test_torch_sharding.py``) for every registered config: the parameter
and ZeRO-1 specs on the production mesh (16 x 16) and on the multi-pod
mesh (2 x 16 x 16), the batch specs of every cell on both (the pod mesh
shards the batch over ("pod", "data"): one dim over two axes), the decode
caches' specs on the production mesh, and the reduced configs'
parameter specs on a (4 x 2) mesh.  For every mesh coordinate the port's
box must be the index box the reference gives the device at that
coordinate.  The reference's side runs in a subprocess with 512 forced
host devices (nothing is compiled or allocated: ``devices_indices_map``
is arithmetic on the mesh).  A shape the spec's axes do not divide has no
reference layout (``NamedSharding`` refuses it); such a case is only
checked to be one (the port splits it as ``torch.chunk`` does).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import tree as TR
from repro_torch.configs import get, reduced
from repro_torch.configs.base import SHAPES, cells, load_all
from repro_torch.data.pipeline import batch_spec
from repro_torch.launch import mesh as MS
from repro_torch.launch import sharding as SH
from repro_torch.models import transformer as T

MESHES = {"prod": {"data": 16, "model": 16},
          "pod": {"pod": 2, "data": 16, "model": 16},
          "small": {"data": 4, "model": 2}}

_JAX_SIDE = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec
todo = json.load(open(sys.argv[1]))
out = {}
for name, job in todo.items():
    sizes = job["mesh"]
    mesh = jax.make_mesh(tuple(sizes.values()), tuple(sizes))
    coords = list(np.ndindex(mesh.devices.shape))
    for i, (shape, spec) in enumerate(job["cases"]):
        ps = PartitionSpec(*[tuple(e) if isinstance(e, list) else e
                             for e in spec])
        try:
            got = NamedSharding(mesh, ps).devices_indices_map(tuple(shape))
        except ValueError:
            continue                      # not divisible: no layout
        boxes = np.zeros((len(coords), len(shape), 2), np.int64)
        for c, coord in enumerate(coords):
            for d, sl in enumerate(got[mesh.devices[coord]]):
                start, stop, _ = sl.indices(shape[d])
                boxes[c, d] = (start, stop)
        out[f"{name}/{i}"] = boxes
np.savez(sys.argv[2], **out)
"""


def _norm(spec, nd):
    spec = list(spec) + [None] * (nd - len(spec))
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in spec)


def _cases() -> dict:
    """{mesh name: {(shape, spec), ...}} of every spec the port makes."""
    out = {k: set() for k in MESHES}

    def add(name, shapes, specs):
        for key, leaf in shapes.items():
            shape = tuple(leaf.shape)
            out[name].add((shape, _norm(specs[key], len(shape))))

    for arch in sorted(load_all()):
        cfg = get(arch)
        params = SH.param_shapes(cfg)
        pshapes = SH.leaf_shapes(params)
        for name in ("prod", "pod"):
            mesh = MESHES[name]
            pspecs = SH.param_specs(params, cfg, mesh)
            add(name, pshapes, pspecs)
            add(name, pshapes, SH.zero1_specs(pspecs, pshapes, mesh))
            for cell in cells(arch):
                shp = SHAPES[cell]
                if shp["kind"] == "decode":
                    continue
                bspec = batch_spec(cfg, shp["seq_len"], shp["global_batch"],
                                   shp["kind"])
                add(name, {k: SH.Shape(tuple(s), dt) for k, (s, dt)
                           in bspec.items()}, SH.batch_specs(bspec, mesh))
        if "decode_32k" in cells(arch):
            shp = SHAPES["decode_32k"]
            caches = T.init_cache(cfg, shp["global_batch"], shp["seq_len"],
                                  device="meta")
            cshapes = SH.leaf_shapes({TR.LAYERS: TR.LayerList(
                caches, cfg.pattern_period())})
            add("prod", cshapes, SH.cache_specs(
                cshapes, cfg, MESHES["prod"], batch=shp["global_batch"]))
        small = reduced(cfg, tp=2)
        sparams = SH.param_shapes(small)
        sshapes = SH.leaf_shapes(sparams)
        add("small", sshapes, SH.param_specs(sparams, small,
                                             MESHES["small"]))
    return {k: sorted(v, key=repr) for k, v in out.items()}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    cases = _cases()
    base = tmp_path_factory.mktemp("layout")
    todo = {name: {"mesh": MESHES[name],
                   "cases": [[list(s), list(p)] for s, p in cases[name]]}
            for name in MESHES}
    with open(base / "todo.json", "w") as f:
        json.dump(todo, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    subprocess.run([sys.executable, "-c", _JAX_SIDE, str(base / "todo.json"),
                    str(base / "boxes.npz")], env=env, check=True,
                   timeout=300)
    with np.load(base / "boxes.npz") as data:
        ref = {k: data[k] for k in data.files}
    return cases, ref


@pytest.mark.parametrize("name", list(MESHES))
def test_box_matches_devices_indices_map(layouts, name):
    cases, ref = layouts
    sizes = MESHES[name]
    coords = list(np.ndindex(*sizes.values()))
    held = multi = 0
    for i, (shape, spec) in enumerate(cases[name]):
        pls = MS.placements(sizes, spec)
        boxes = np.array([MS._box(shape, pls, list(sizes.values()), c)
                          for c in coords], np.int64).reshape(
                              len(coords), len(shape), 2)
        want = ref.get(f"{name}/{i}")
        if want is None:
            # no reference layout: the axes do not divide a sharded dim
            assert any(shape[d] % np.prod([sizes[a] for a in (
                e if isinstance(e, tuple) else (e,))]) for d, e in
                enumerate(spec) if e is not None), (shape, spec)
            continue
        np.testing.assert_array_equal(boxes, want, err_msg=f"{shape} {spec}")
        held += 1
        multi += any(isinstance(e, tuple) and len(e) > 1 for e in spec)
    assert held > 20
    if name == "pod":
        assert multi > 0          # a dim over ("pod", "data") was held
