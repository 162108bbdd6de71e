"""Path-based sharding rules: params, optimizer state, batches, caches
(twin of ``repro.launch.sharding``, rule for rule).

TP plan:
  column-parallel (N→"model"): wq wk wv gate up in_proj up_proj ff_up lm_head
  row-parallel   (K→"model"): wo down out_proj down_proj ff_down
  MoE: E→"model" when expert-parallel, else d_ff→"model"
  embed/vocab → "model" when divisible; small/norm params replicated
  ZeRO-1: optimizer moments/master additionally sharded over "data"
  batches: leading dim over ("pod","data"); decode caches: batch over "data"
  unless batch==1, then sequence over "data" (sequence-parallel long decode).

The rules walk the port's trees with :func:`repro_torch.tree.walk`, so a
leaf has the reference's key path and, under ``"layers"``, its stacked
shape ``[L, ...]``.  A spec is a :class:`P`: one entry per tensor dim
(an axis name, a tuple of names, or None), the counterpart of
``PartitionSpec``.  The spec functions return ``{leaf key: P}`` in walk
order and read only shapes, so full-size configs take
:func:`param_shapes` (``init_model`` on the meta device: nothing is
allocated).  ``tp`` and ``dp`` come from the mesh, as in the reference;
``ArchConfig.moe_ep`` decides the MoE rule (at ``ep_axis``).
:func:`to_named` pairs a spec with a mesh (:class:`NamedSharding`, whose
``placements`` are DTensor placements).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree as TR
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import axis_sizes, data_axes, placements

COLUMN_PARALLEL = {"wq", "wk", "wv", "gate", "up", "in_proj", "up_proj",
                   "ff_up", "lm_head"}
ROW_PARALLEL = {"wo", "down", "out_proj", "down_proj", "ff_down"}
REPLICATED_MODULES = {"router", "r", "b_if", "frontend_proj", "pos_embed"}


class P(tuple):
    """A per-dimension spec: ``P("model", None)``; ``P()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class Shape:
    """A leaf's logical shape and dtype (``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: P

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)


def _path_names(path) -> list[str]:
    """The reference's names of a key path: dict keys, ``#i`` for a list
    index, the child index of a registered class, a field's name."""
    out = []
    for k in path:
        if k.kind == "seq":
            out.append(f"#{k.name}")
        else:
            out.append(str(k.name))
    return out


def _spec_last(leaf_ndim: int, axis_from_end: int, name: str) -> P:
    spec = [None] * leaf_ndim
    spec[leaf_ndim - axis_from_end] = name
    return P(*spec)


def _divisible(n: int, tp: int) -> bool:
    return n % tp == 0


def _add_fsdp(spec: P, shape, dp: int, min_elems: int = 1 << 20) -> P:
    """FSDP/ZeRO-3: add "data" on the first free dim divisible by the data
    axis (large leaves only — small params stay replicated)."""
    n = 1
    for d in shape:
        n *= d
    if n < min_elems:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if "data" in entries:
        return spec
    # prefer the largest free divisible dim
    best, best_dim = -1, -1
    for i, (d, s) in enumerate(zip(shape, entries)):
        if s is None and d % dp == 0 and d >= dp and d > best_dim:
            best, best_dim = i, d
    if best >= 0:
        entries[best] = "data"
        return P(*entries)
    return spec


def param_spec_fn(cfg: ArchConfig, tp: int, dp: int = 0):
    """Returns f(path, leaf shape) -> P."""

    def fn(path, leaf) -> P:
        spec = _base_fn(path, leaf)
        if cfg.fsdp and dp > 1:
            spec = _add_fsdp(spec, leaf.shape, dp)
        return spec

    def _base_fn(path, leaf) -> P:
        names = _path_names(path)
        shape = leaf.shape
        nd = len(shape)
        # module name = last dict key before pytree-index suffixes
        mod = next((n for n in reversed(names) if not n.startswith("#")),
                   "")
        if "embed" == mod:
            return (P("model", None) if _divisible(cfg.vocab, tp) else P())
        if mod in REPLICATED_MODULES or "norm" in mod or mod in (
                "b_in", "dt_bias", "conv_b", "b_if"):
            if mod in ("conv_b",):
                din = shape[-1]
                return (_spec_last(nd, 1, "model")
                        if _divisible(din, tp) else P())
            return P()
        if "moe" in names:
            # MoE*Split leaves: [.., E, K, N]
            if mod in ("gate", "up", "down") and nd >= 3:
                if cfg.moe_ep:
                    return _spec_last(nd, 3, "model")
                if mod == "down":      # MoENSplit [E, K=d_ff, N_cls]
                    return _spec_last(nd, 2, "model")
                return _spec_last(nd, 1, "model")   # column d_ff
            # shared expert MLP falls through to generic rules
        if mod == "lm_head" or "lm_head" in names:
            return (_spec_last(nd, 1, "model")
                    if _divisible(cfg.vocab, tp) else P())
        for col in COLUMN_PARALLEL:
            if col in names:
                if nd >= 2 and _divisible(shape[-1], tp):
                    return _spec_last(nd, 1, "model")
                return P()
        for row in ROW_PARALLEL:
            if row in names:
                if nd >= 2 and _divisible(shape[-2], tp):
                    return _spec_last(nd, 2, "model")
                return P()
        # mamba / mlstm internals sharded on d_in
        if mod in ("conv_w",):
            return (_spec_last(nd, 1, "model")
                    if _divisible(shape[-1], tp) else P())
        if mod in ("x_proj", "w_if", "A_log"):
            return (_spec_last(nd, 2, "model")
                    if _divisible(shape[-2], tp) else P())
        if mod in ("dt_proj",):
            return (_spec_last(nd, 1, "model")
                    if _divisible(shape[-1], tp) else P())
        if mod in ("D", "skip", "dt_bias"):
            return (_spec_last(nd, 1, "model")
                    if _divisible(shape[-1], tp) else P())
        return P()

    return fn


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so ``init_model``
    (which allocates on ``gen.device``) builds shapes only."""

    @property
    def device(self):
        return torch.device("meta")


def param_shapes(cfg: ArchConfig) -> dict:
    """The port's parameter tree of ``cfg`` on the meta device: every
    shape and dtype, no storage (``jax.eval_shape`` of ``init_model``)."""
    from repro_torch.models import transformer as T
    return T.init_model(_MetaGenerator(), cfg)


def leaf_shapes(tree) -> dict[str, Shape]:
    """``{leaf key: Shape}`` of a port tree in walk order (a stacked
    leaf's shape leads with its layer count)."""
    out = {}
    for leaf in TR.walk(tree):
        t = leaf.parts[0]
        shape = ((len(leaf.parts),) if leaf.stacked else ()) + tuple(
            t.shape)
        out[leaf.key] = Shape(shape, t.dtype)
    return out


def param_specs(params, cfg: ArchConfig, mesh) -> dict[str, P]:
    """``{leaf key: P}`` for the port tree ``params`` (tensors of any
    device, meta included)."""
    sizes = axis_sizes(mesh)
    fn = param_spec_fn(cfg, sizes["model"], sizes.get("data", 1))
    shapes = leaf_shapes(params)
    return {leaf.key: fn(leaf.path, shapes[leaf.key])
            for leaf in TR.walk(params)}


def zero1_specs(pspecs: dict, params_shapes: dict, mesh) -> dict[str, P]:
    """Optimizer state sharding: param spec + "data" on the first free,
    divisible dim (ZeRO-1).  ``params_shapes`` is :func:`leaf_shapes`'s
    dict."""
    dp = axis_sizes(mesh)["data"]

    def add_data(spec: P, leaf: Shape):
        shape = leaf.shape
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if "data" in entries:     # FSDP params already carry "data"
            return P(*entries)
        for i, (dim, s) in enumerate(zip(shape, entries)):
            if s is None and dim % dp == 0 and dim >= dp:
                entries[i] = "data"
                return P(*entries)
        return spec

    return {k: add_data(s, params_shapes[k]) for k, s in pspecs.items()}


def opt_state_specs(params_shapes: dict, pspecs: dict, ocfg, mesh) -> dict:
    """AdamW state specs: ``{"mu", "nu", "master", "count"}`` (``master``
    None without master weights)."""
    z = zero1_specs(pspecs, params_shapes, mesh)
    return {"mu": z, "nu": z, "master": z if ocfg.master_weights else None,
            "count": P()}


def batch_specs(spec_tree: dict, mesh, *, batch_axes=None) -> dict:
    """Leading dim over all data axes present in the mesh.
    ``spec_tree`` is ``{name: (shape, dtype)}`` (``data.pipeline.
    batch_spec``)."""
    axes = batch_axes or data_axes(mesh)
    ax = axes if len(axes) > 1 else axes[0]
    return {k: P(ax, *([None] * (len(shape) - 1)))
            for k, (shape, _) in spec_tree.items()}


def cache_specs(cache_shapes: dict, cfg: ArchConfig, mesh, *, batch: int
                ) -> dict[str, P]:
    """Decode caches, ``{leaf key: P}`` of :func:`leaf_shapes` of the
    reference-stacked cache tree: attention k/v [L, B, S, n_kv, dh];
    recurrent states [L, B, ...].  batch > 1 → shard B over "data" (and
    kv-heads over "model"); batch == 1 → sequence-parallel: shard S of
    attention caches over "data"."""
    sizes = axis_sizes(mesh)
    dp, tp = sizes["data"], sizes["model"]

    def fn(key: str, leaf: Shape):
        shape = leaf.shape
        nd = len(shape)
        is_kv = key.split("/")[-1] in ("k", "v")
        entries: list = [None] * nd
        if is_kv and nd == 5:
            L, B, S, H, dh = shape
            if B % dp == 0 and B >= dp:
                entries[1] = "data"
            elif S % dp == 0 and S > 1:
                entries[2] = "data"          # sequence-parallel cache
            if H % tp == 0:
                entries[3] = "model"
            return P(*entries)
        # recurrent state [L, B, ...]: shard B when divisible; the states
        # themselves are small (O(d·n) per layer) so otherwise replicate
        if nd >= 2 and shape[1] % dp == 0 and shape[1] >= dp:
            entries[1] = "data"
        return P(*entries)

    return {k: fn(k, v) for k, v in cache_shapes.items()}


def distribute_tree(tree, specs: dict, mesh):
    """``tree`` with every tensor a DTensor on ``mesh`` holding this rank's
    slice under its leaf's spec (``launch.mesh.distribute``).  A stacked
    leaf's spec leads with the layer dim, which must not be sharded (the
    port holds each layer's tensor apart); the rest applies to each
    layer's tensor."""
    from repro_torch.launch.mesh import distribute
    new = {}
    for leaf in TR.walk(tree):
        spec = tuple(specs[leaf.key])
        if leaf.stacked:
            if spec and spec[0] is not None:
                raise ValueError(f"{leaf.key}: spec {spec} shards the "
                                 "stacked layer dim")
            spec = spec[1:]
        for t in leaf.parts:
            new[id(t)] = distribute(t, spec, mesh)
    return TR.replace_tensors(tree, new)


def is_sharded(t) -> bool:
    """A DTensor with a ``Shard`` placement."""
    return any(getattr(p, "dim", None) is not None
               for p in getattr(t, "placements", ()))


def to_named(spec_tree: dict, mesh) -> dict:
    """``{key: NamedSharding}``: each spec on ``mesh`` (its
    ``placements`` are DTensor placements)."""
    return {k: NamedSharding(mesh, s) for k, s in spec_tree.items()}


def device_bytes(shapes: dict[str, Shape], specs: dict[str, P], mesh
                 ) -> int:
    """Bytes one rank holds of the leaves ``shapes`` sharded by
    ``specs`` (a sharded dim holds its largest shard:
    ``ceil(dim / axes)``)."""
    sizes = axis_sizes(mesh)
    total = 0
    for k, leaf in shapes.items():
        spec = list(specs[k]) + [None] * (len(leaf.shape) - len(specs[k]))
        n = 1
        for dim, entry in zip(leaf.shape, spec):
            ways = 1
            for a in ((entry if isinstance(entry, tuple) else (entry,))
                      if entry is not None else ()):
                ways *= sizes.get(a, 1)
            n *= -(-dim // ways)
        total += n * leaf.dtype.itemsize
    return total
