"""Compiler-free dry run: the per-device bytes of every (arch × shape)
cell's arguments on the production mesh, from shapes alone (counterpart
of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \
        [--multi-pod] [--out results/dryrun_torch]
    python -m repro_torch.launch.dryrun --all [--both-meshes]

The reference lowers and compiles each cell with XLA over 512
placeholder host devices and records XLA's memory, cost and collective
analyses.  The port has no compiler and no devices are needed here: for
each cell it builds the parameter tree on the meta device
(``launch.sharding.param_shapes``), takes the port's specs on the
production mesh's shape (``launch.mesh.production_shape``) and sums what
one device holds of the arguments — params, the ZeRO-1 AdamW state and
the batch for ``train``; params and the batch for ``prefill``; params,
the tokens and the decode caches for ``decode``.  At inference FSDP is
off, as in the reference.  ``model_flops`` is the reference's estimate,
copied exactly.  XLA's ``cost``, ``collectives`` and ``temp_bytes`` have
no counterpart: each cell's JSON lists them under ``absent`` with the
reason.  ``--all`` sweeps every registered cell (``configs.base.
cells``) and keeps one JSON per cell, so an interrupted sweep resumes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import tree as TR
from repro_torch.configs.base import REGISTRY, SHAPES, cells, get, load_all
from repro_torch.data.pipeline import batch_spec
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import production_shape
from repro_torch.optim import adamw

# per-(arch, shape) microbatch overrides: keep per-microbatch activations
# inside ~16 GB/chip (tokens/shard per microbatch ≲ 16k for the giants)
MICROBATCHES = {
    ("llama3-405b", "train_4k"): 8,
    ("llava-next-34b", "train_4k"): 4,
    ("jamba-v0.1-52b", "train_4k"): 4,
    ("phi3.5-moe-42b-a6.6b", "train_4k"): 4,
    ("llama3-8b", "train_4k"): 2,
    ("gemma3-4b", "train_4k"): 2,
    ("qwen2-moe-a2.7b", "train_4k"): 2,
}

#: the reference's fields with no counterpart without a compiler
ABSENT = {
    "fields": ["cost", "collectives", "collectives_raw", "corrected",
               "memory.temp_bytes", "memory.output_bytes", "hlo_bytes"],
    "reason": "no compiler: the port runs eager PyTorch, so XLA's cost, "
              "memory and collective analyses of a compiled program have "
              "no counterpart; memory.argument_bytes is computed from the "
              "specs",
}


def model_flops_estimate(cfg, seq_len: int, global_batch: int,
                         kind: str) -> float:
    """MODEL_FLOPS: 6·N·D train (N = active params), 2·N·D forward."""
    n_active = cfg.param_count()
    if cfg.n_experts:
        # active experts only
        dense = cfg.param_count() - (
            len([1 for _, f in cfg.layer_kinds() if f == "moe"])
            * (cfg.n_experts - cfg.top_k) * 3 * cfg.d_model * cfg.d_ff)
        n_active = dense
    tokens = global_batch * (seq_len if kind != "decode" else 1)
    mult = 6 if kind == "train" else 2
    return float(mult) * n_active * tokens


def _shapes_of(spec: dict) -> dict[str, SH.Shape]:
    return {k: SH.Shape(tuple(shape), dt) for k, (shape, dt) in spec.items()}


def cell_bytes(arch: str, shape_name: str, *, multi_pod: bool = False
               ) -> dict:
    """The per-device argument bytes of one cell, by part."""
    cfg = get(arch)
    shp = SHAPES[shape_name]
    seq_len, global_batch, kind = (shp["seq_len"], shp["global_batch"],
                                   shp["kind"])
    if kind != "train" and cfg.fsdp:
        # FSDP shards optimizer/training state; at inference the params
        # stay TP-sharded only (the reference's rule)
        cfg = dataclasses.replace(cfg, fsdp=False)
    mesh = production_shape(multi_pod)
    params = SH.param_shapes(cfg)
    pshapes = SH.leaf_shapes(params)
    pspecs = SH.param_specs(params, cfg, mesh)
    parts = {"params": SH.device_bytes(pshapes, pspecs, mesh)}
    out = {"cfg": cfg, "mesh": mesh, "seq_len": seq_len,
           "global_batch": global_batch, "kind": kind}
    if kind == "train":
        if get(arch).fsdp:
            # giants: no fp32 master, bf16 moments (the reference's choice)
            ocfg = adamw.AdamWConfig(master_weights=False,
                                     moment_dtype="bfloat16")
        else:
            ocfg = adamw.AdamWConfig()
        opt = adamw.init(params, ocfg)
        ospecs = SH.opt_state_specs(pshapes, pspecs, ocfg, mesh)
        nbytes = sum(SH.device_bytes(SH.leaf_shapes(getattr(opt, f)),
                                     ospecs[f], mesh)
                     for f in ("mu", "nu", "master")
                     if getattr(opt, f) is not None)
        parts["opt_state"] = nbytes + opt.count.element_size()
        bspec = batch_spec(cfg, seq_len, global_batch, "train")
        parts["batch"] = SH.device_bytes(_shapes_of(bspec),
                                         SH.batch_specs(bspec, mesh), mesh)
    elif kind == "prefill":
        bspec = batch_spec(cfg, seq_len, global_batch, "prefill")
        parts["batch"] = SH.device_bytes(_shapes_of(bspec),
                                         SH.batch_specs(bspec, mesh), mesh)
    elif kind == "decode":
        from repro_torch.models import transformer as T
        caches = T.init_cache(cfg, global_batch, seq_len, device="meta")
        cshapes = SH.leaf_shapes({TR.LAYERS: TR.LayerList(
            caches, cfg.pattern_period())})
        parts["caches"] = SH.device_bytes(
            cshapes, SH.cache_specs(cshapes, cfg, mesh, batch=global_batch),
            mesh)
        tok = {"t": ((global_batch, 1), torch.int32)}
        tspec = (SH.batch_specs(tok, mesh) if global_batch > 1
                 else {"t": SH.P()})
        parts["tokens"] = SH.device_bytes(_shapes_of(tok), tspec, mesh)
        parts["pos"] = 4
    else:
        raise ValueError(kind)
    out["parts"] = parts
    return out


def dry_cell(arch: str, shape_name: str, *, multi_pod: bool = False
             ) -> dict:
    """One cell's JSON record.  A train cell records its ``MICROBATCHES``
    entry (the reference's compiled step splits its batch so; the
    argument bytes do not depend on it)."""
    t0 = time.time()
    c = cell_bytes(arch, shape_name, multi_pod=multi_pod)
    mesh = c["mesh"]
    result = {
        "arch": arch, "shape": shape_name, "kind": c["kind"],
        "multi_pod": multi_pod, "mesh": mesh, "seq_len": c["seq_len"],
        "global_batch": c["global_batch"],
    }
    if c["kind"] == "train":
        result["microbatches"] = MICROBATCHES.get((arch, shape_name), 1)
    result["memory"] = {"argument_bytes": sum(c["parts"].values()),
                        "argument_bytes_by_part": c["parts"]}
    result["model_flops"] = model_flops_estimate(
        c["cfg"], c["seq_len"], c["global_batch"], c["kind"])
    n = 1
    for v in mesh.values():
        n *= v
    result["n_chips"] = n
    result["absent"] = ABSENT
    result["specs_s"] = round(time.time() - t0, 2)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    load_all()
    os.makedirs(args.out, exist_ok=True)

    todo = []
    if args.all:
        for arch in REGISTRY:
            for shape in cells(arch):
                todo.append((arch, shape, False))
                if args.both_meshes:
                    todo.append((arch, shape, True))
    else:
        todo.append((args.arch, args.shape, args.multi_pod))

    failures = 0
    for arch, shape, mp in todo:
        tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip cached] {tag}")
            continue
        print(f"[specs] {tag} ...", flush=True)
        try:
            res = dry_cell(arch, shape, multi_pod=mp)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            print(f"  ok in {res['specs_s']}s  argument bytes/device="
                  f"{res['memory']['argument_bytes']:.3e}  model_flops="
                  f"{res['model_flops']:.3e}", flush=True)
        except Exception as e:   # noqa: BLE001 — counted, reported, re-raised
            failures += 1
            print(f"  FAILED: {type(e).__name__}: {e}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
