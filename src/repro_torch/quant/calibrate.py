"""Activation-aware calibration: per-channel absmax statistics → class
maps (twin of ``repro.quant.calibrate``).

A per-tile symmetric-absmax integer format (``int8_pt``/``int4_pt``)
rounds a K-block of a weight by ``u_q · absmax(block)``, but the forward
error that rounding causes grows with the activations that multiply the
block.  Calibration therefore scores each K-block by

    score(block) = max_{k ∈ block}  act_absmax[k] · absmax(W[k, :])

and keeps the top ``ratio_high`` fraction of blocks in the set's HIGH
float format; the quiet rest drops to the integer LOW role.  The scores
and the stable argsort run in host numpy exactly as the reference's do
(a row's absmax is exact on any device), so the maps are bit for bit the
reference's.

The reference scans stacked layers, so a weight at one place of its
segments (position q of segment s) holds one map for all the layers
stacked there.  The port's layers are a Python list; the layers at one
such place (``tree.segment_layers``) share one map per weight name,
scored by the loudest layer per block, so quantizing the port's
parameters gives the maps a JAX ``quantize_params`` gives the stacked
ones.  A group of layers is passed as a list of :class:`KSplitWeight`
(one per layer).

NSplit weights and plain tensors pass through unchanged (NSplit maps are
tied to column permutations folded into the next layer at init).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import DEFAULT_FORMATS, FormatSet, format_set
from repro_torch.core.layout import KSplitWeight
from repro_torch.core.linear import MPLinear
from repro_torch.tree import LayerList, segment_layers


def _absmax(x, axis: int) -> np.ndarray:
    """fp32 absmax along ``axis`` of a 2-D tensor or array, as numpy (a
    max is exact, so the device it runs on does not change its bits)."""
    if torch.is_tensor(x):
        return x.detach().float().abs().amax(dim=axis).cpu().numpy()
    return np.abs(np.asarray(x, np.float32)).max(axis=axis)


def activation_absmax(x) -> np.ndarray:
    """Per-channel absmax of one activation batch ``[..., K] → [K]``
    (numpy array or tensor)."""
    return _absmax(x.reshape(-1, x.shape[-1]), 0)


@dataclasses.dataclass
class ActStats:
    """Online per-channel activation absmax, keyed by channel dimension.

    ``observe(x)`` folds a batch in (running elementwise max); ``get(k)``
    returns the ``[k]`` absmax vector, or all-ones when dimension ``k``
    was never observed (calibration then scores the weights alone)."""

    by_dim: dict = dataclasses.field(default_factory=dict)

    def observe(self, x) -> "ActStats":
        am = activation_absmax(x)
        k = am.shape[0]
        prev = self.by_dim.get(k)
        self.by_dim[k] = am if prev is None else np.maximum(prev, am)
        return self

    def get(self, k: int) -> np.ndarray:
        am = self.by_dim.get(k)
        return np.ones(k, np.float32) if am is None else am


def block_scores(w, act_amax: np.ndarray, tile: int) -> np.ndarray:
    """Loudness score per K-block of ``W[K, N]`` (tensor or array):
    ``max_k act_absmax[k]·absmax(W[k,:])`` within each block (fp32)."""
    k = int(w.shape[0])
    assert k % tile == 0, (k, tile)
    row = _absmax(w, 1) * np.asarray(act_amax, np.float32)[:k]
    return row.reshape(k // tile, tile).max(axis=1)


def calibrated_cls(scores: np.ndarray, ratio_high: float,
                   fset: FormatSet) -> np.ndarray:
    """Class vector from block scores: top ``ratio_high`` fraction HIGH,
    the rest the set's LOW role.  Stable argsort → deterministic map."""
    nb = scores.shape[0]
    n_hi = int(round(float(ratio_high) * nb))
    cls = np.full(nb, fset.low, np.int8)
    order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
    cls[order[:n_hi]] = fset.high
    return cls


def calibrate_ksplit(w, act_amax: np.ndarray, fset: FormatSet,
                     ratio_high: float):
    """Re-encode a KSplit weight under ``fset`` with the activation-aware
    map, rebuilt from its current buffers (so calibration composes with
    the storage rounding already applied).

    ``w`` is one :class:`KSplitWeight` or a list of them, the layers of
    one weight name; a list gets ONE map, scored by the loudest layer per
    block, and comes back as a list."""
    layers = list(w) if isinstance(w, (list, tuple)) else [w]
    tile = layers[0].tile
    denses = [lw.to_dense() for lw in layers]
    scores = np.max([block_scores(d, act_amax, tile) for d in denses],
                    axis=0)
    cls = calibrated_cls(scores, ratio_high, fset)
    rebuilt = [KSplitWeight.from_dense(d, cls, tile, fset) for d in denses]
    return rebuilt if isinstance(w, (list, tuple)) else rebuilt[0]


def _rebuild(group: list, fn) -> list:
    """``group`` holds one node per layer at the same place of the tree
    (one node outside the layer list); returns the rebuilt nodes."""
    first = group[0]
    if isinstance(first, dict):
        outs = [dict() for _ in group]
        for key in first:
            for out, node in zip(outs, _rebuild([g[key] for g in group],
                                                fn)):
                out[key] = node
        return outs
    if isinstance(first, list):
        return [_rebuild_layers(g, fn) if isinstance(g, LayerList)
                else _rebuild(g, fn) for g in group]
    if isinstance(first, MPLinear) and isinstance(first.w, KSplitWeight):
        return [MPLinear(w, m.b)
                for w, m in zip(fn([m.w for m in group]), group)]
    return group


def _rebuild_layers(layers: LayerList, fn) -> LayerList:
    """The layers at one place of the reference's segments (one stacked
    leaf there: ``tree.segment_layers``) share each weight's map."""
    out = list(layers)
    for positions in segment_layers(len(layers), layers.period):
        for idx in positions:
            for i, node in zip(idx, _rebuild([layers[i] for i in idx], fn)):
                out[i] = node
    return LayerList(out, layers.period)


def quantize_params(params, stats: ActStats | None = None, *,
                    fset: FormatSet | None = None,
                    ratio_high: float = 0.25):
    """Activation-aware quantized variant of a parameter tree.

    Every KSplit linear is rebuilt under ``fset`` (default: ``int8_pt``
    in the LOW role of the repo default set) with the calibrated map, one
    map per weight name across the layers of one place of the
    reference's segments (its stacked leaf); NSplit linears and plain
    tensors are the input's own objects.  The result serves through
    ``Engine(..., variants={tag: ...})``."""
    if fset is None:
        fset = format_set("int8_pt", DEFAULT_FORMATS.names[-1])
    stats = stats or ActStats()

    def calibrate(ws):
        return calibrate_ksplit(ws, stats.get(ws[0].shape[0]), fset,
                                ratio_high)

    return _rebuild([params], calibrate)[0]


def map_report(w) -> dict:
    """Bytes + class-mix summary of one calibrated weight (a
    :class:`KSplitWeight`, or the list of a weight name's layers), storage
    derived from the class map (``tile_bytes`` per tile, scale metadata
    included)."""
    layers = list(w) if isinstance(w, (list, tuple)) else [w]
    w0 = layers[0]
    k, n = w0.shape
    cls = np.asarray(w0.k_cls)
    per_layer = sum((int(n) // w0.tile) * w0.fset.tile_bytes(int(c), w0.tile)
                    for c in cls)
    dense = len(layers) * int(k) * int(n) * 4
    return {
        "shape": (int(k), int(n)),
        "layers": len(layers),
        "classes": {w0.fset.names[c]: int((cls == c).sum())
                    for c in np.unique(cls)},
        "storage_bytes": int(len(layers) * per_layer),
        "bytes_vs_fp32": float(len(layers) * per_layer) / dense,
    }


__all__ = [
    "ActStats", "activation_absmax", "block_scores", "calibrate_ksplit",
    "calibrated_cls", "map_report", "quantize_params",
]
