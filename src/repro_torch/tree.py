"""The port's parameter and optimizer-state trees, walked as the
reference's pytrees.

The reference's trees are JAX pytrees: dicts (walked in sorted key
order), lists, named tuples, ``MPLinear`` (children ``w``, ``b``), the
layout weights (one child per buffer) and the MoE expert weights
(children ``w_hi``, ``w_lo``), with ``None`` an empty subtree.  Its
layers are scanned in segments of whole pattern periods plus a tail
(``ArchConfig.segments``): layer ``r·p + q`` of the main segment sits at
``params["blocks"][0]["pos{q}"]``, repeat ``r`` of each leaf stacked
along a leading dim; tail layer ``q`` at ``["blocks"][1]["pos{q}"]`` with
a repeat dim of 1.  The port keeps its layers as a :class:`LayerList`
under ``"layers"``, which carries the period ``p``.

:func:`walk` visits a port tree in the reference's leaf order under the
reference's key paths; a leaf under ``"layers"`` is *stacked*: its parts
are the per-layer tensors at that place, in layer order.  AdamW's decay
rule reads a leaf's :attr:`Leaf.name` (``str`` of the JAX key path), the
checkpoint its :attr:`Leaf.key` (the reference's file key), so both see
the names the reference sees.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import torch

from repro_torch.core.layout import KSplitWeight, NSplitWeight
from repro_torch.core.linear import MPLinear
from repro_torch.models.moe import MOE_WEIGHTS

#: the port's layer list; the reference's scanned segments in its place
LAYERS = "layers"


class LayerList(list):
    """The port's layers, with the pattern period of the reference's
    scan (``ArchConfig.pattern_period()``).  A plain list under
    ``"layers"`` is refused: its period would be a guess."""

    def __init__(self, layers=(), period: int = 1):
        super().__init__(layers)
        self.period = int(period)


@dataclasses.dataclass(frozen=True)
class Key:
    """One step of a key path: ``dict`` (a dict key), ``seq`` (a list
    index), ``flat`` (a registered pytree class's child index) or
    ``attr`` (a named-tuple field)."""

    kind: str
    name: object

    def __str__(self) -> str:
        """``str`` of the JAX key (what the reference's decay rule
        matches)."""
        if self.kind == "dict":
            return f"[{self.name!r}]"
        if self.kind == "seq":
            return f"[{self.name}]"
        if self.kind == "flat":
            return f"[<flat index {self.name}>]"
        return f".{self.name}"

    @property
    def ckpt(self) -> str:
        """The reference checkpoint's spelling of this key."""
        return f"[{self.name}]" if self.kind == "seq" else str(self.name)


def segment_layers(n_layers: int, period: int) -> list[list[list[int]]]:
    """``[segment][pos] -> layer indices``, one per repeat in order."""
    main = n_layers // period
    segs = []
    if main:
        segs.append([[r * period + q for r in range(main)]
                     for q in range(period)])
    tail = n_layers - main * period
    if tail:
        segs.append([[main * period + q] for q in range(tail)])
    return segs


@dataclasses.dataclass
class Leaf:
    """One reference leaf: ``parts`` holds the tensor (one part) or, when
    ``stacked``, the per-layer tensors the reference stacks."""

    path: tuple
    parts: list
    stacked: bool

    @property
    def name(self) -> str:
        return "/".join(str(k) for k in self.path)

    @property
    def key(self) -> str:
        return "/".join(k.ckpt for k in self.path)


def _sorted_items(d: dict):
    return sorted(d.items(),
                  key=lambda kv: "blocks" if kv[0] == LAYERS else kv[0])


def _visit(node, path: tuple) -> Iterator[tuple[tuple, object]]:
    """(path, tensor or per-layer list) for every leaf under ``node``."""
    if node is None:
        return
    if torch.is_tensor(node):
        yield path, node
    elif isinstance(node, dict):
        for k, v in _sorted_items(node):
            if k == LAYERS:
                if not isinstance(v, LayerList):
                    raise TypeError(
                        f"'layers' is a {type(v).__name__}, not a "
                        "LayerList: wrap it as LayerList(layers, "
                        "cfg.pattern_period()) so it walks in the "
                        "reference's segments")
                yield from _visit_layers(v, path, v.period)
            else:
                yield from _visit(v, path + (Key("dict", k),))
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            yield from _visit(getattr(node, f), path + (Key("attr", f),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _visit(v, path + (Key("seq", i),))
    elif isinstance(node, MPLinear):
        yield from _visit(node.w, path + (Key("flat", 0),))
        yield from _visit(node.b, path + (Key("flat", 1),))
    elif isinstance(node, (KSplitWeight, NSplitWeight)):
        for i, b in enumerate(node.bufs):
            yield path + (Key("flat", i),), b
    elif isinstance(node, MOE_WEIGHTS):
        yield path + (Key("flat", 0),), node.w_hi
        yield path + (Key("flat", 1),), node.w_lo
    else:
        raise TypeError(f"not a tree node: {type(node).__name__}")


def _visit_layers(layers: list, path: tuple, period: int):
    for s, positions in enumerate(segment_layers(len(layers), period)):
        # the reference walks a segment's positions in sorted key order
        for q in sorted(range(len(positions)), key=lambda q: f"pos{q}"):
            idx = positions[q]
            per_layer = [list(_visit(layers[i], ())) for i in idx]
            for i, got in zip(idx[1:], per_layer[1:]):
                if [p for p, _ in got] != [p for p, _ in per_layer[0]]:
                    raise ValueError(f"layer {i} differs in structure "
                                     f"from layer {idx[0]}")
            for j, (sub, _) in enumerate(per_layer[0]):
                yield (path + (Key("dict", "blocks"), Key("seq", s),
                               Key("dict", f"pos{q}")) + sub,
                       [got[j][1] for got in per_layer])


def walk(tree) -> list[Leaf]:
    """The reference's leaves of ``tree``, in its flatten order."""
    return [Leaf(p, list(t), True) if isinstance(t, list)
            else Leaf(p, [t], False) for p, t in _visit(tree, ())]


def tensors(tree) -> list[torch.Tensor]:
    """Every tensor of ``tree``, in :func:`walk` order (a stacked leaf's
    layers in turn)."""
    return [t for leaf in walk(tree) for t in leaf.parts]


def map_tensors(fn: Callable, tree, *rest):
    """``tree`` rebuilt with ``fn(t, *matching tensors of rest)`` for each
    tensor ``t`` (every tree of ``rest`` has ``tree``'s structure)."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, LayerList):
        return LayerList((map_tensors(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree)), tree.period)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if isinstance(tree, MPLinear):
        return MPLinear(map_tensors(fn, tree.w, *(r.w for r in rest)),
                        map_tensors(fn, tree.b, *(r.b for r in rest)))
    if isinstance(tree, (KSplitWeight, NSplitWeight)):
        return dataclasses.replace(tree, bufs=tuple(
            fn(b, *(r.bufs[i] for r in rest))
            for i, b in enumerate(tree.bufs)))
    if isinstance(tree, MOE_WEIGHTS):
        return dataclasses.replace(
            tree, w_hi=fn(tree.w_hi, *(r.w_hi for r in rest)),
            w_lo=fn(tree.w_lo, *(r.w_lo for r in rest)))
    raise TypeError(f"not a tree node: {type(tree).__name__}")


def replace_tensors(tree, new: dict):
    """``tree`` rebuilt with ``new[id(t)]`` in place of each tensor ``t``
    (a tensor without an entry is kept)."""
    return map_tensors(lambda t: new.get(id(t), t), tree)
