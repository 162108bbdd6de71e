"""Tile maps and precision-selection policies (twin of
``repro.core.precision``).

A *tile map* is an int8 numpy array ``[mt, nt]`` of class codes into a
:class:`~repro_torch.core.formats.FormatSet`.  Maps are host-side data
drawn with ``np.random.default_rng``, so for every policy and seed they
are identical to the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import DEFAULT_FORMATS, FormatSet

__all__ = ["Policy", "PAPER_RATIOS", "make_map", "map_ratio_string",
           "map_storage_bytes", "quantize_tile", "role_class_vector",
           "tile_grid"]


def tile_grid(shape: tuple[int, int], tile: int) -> tuple[int, int]:
    """Number of tiles along each dim (ragged edges round up)."""
    m, n = shape
    return (-(-m // tile), -(-n // tile))


def map_storage_bytes(cls_map: np.ndarray, tile: int,
                      fset: FormatSet = DEFAULT_FORMATS) -> int:
    """Exact storage bytes of a tile-heterogeneous matrix."""
    cls_map = np.asarray(cls_map)
    classes = [int(c) for c in np.unique(cls_map)]
    bad = [c for c in classes if not 0 <= c < len(fset)]
    if bad:
        raise ValueError(
            f"class codes {bad} outside format set {fset.names}")
    return int(sum(int((cls_map == c).sum()) * fset.tile_bytes(c, tile)
                   for c in classes))


def _largest_remainder_percent(counts: list[int], total: int) -> list[int]:
    exact = [100.0 * c / total for c in counts]
    floors = [int(f) for f in exact]
    short = 100 - sum(floors)
    order = sorted(range(len(counts)), key=lambda i: exact[i] - floors[i],
                   reverse=True)
    for i in order[:short]:
        floors[i] += 1
    return floors


def map_ratio_string(cls_map: np.ndarray,
                     fset: FormatSet = DEFAULT_FORMATS) -> str:
    """Paper notation 'aD:bS[:cQ]' as percentages summing to 100."""
    cls_map = np.asarray(cls_map)
    total = cls_map.size
    hi = int((cls_map == fset.high).sum())
    lo8 = int((cls_map == fset.low8).sum()) if fset.low8 is not None else 0
    lo = total - hi - lo8
    a, b, c = _largest_remainder_percent([hi, lo, lo8], total)
    if c or lo8:
        return f"{a}D:{b}S:{c}Q"
    return f"{a}D:{b}S"


@dataclasses.dataclass(frozen=True)
class Policy:
    """A named precision-selection policy (see the reference for the
    kinds: ``ratio``, ``uniform_high``/``uniform_low``/``uniform_low8``,
    ``norm_topk``, ``outlier_aware``)."""

    kind: str = "ratio"
    ratio_high: float = 0.5
    ratio_low8: float = 0.0
    outlier_sigma: float = 6.0
    seed: int = 0

    def name(self) -> str:
        if self.kind == "ratio":
            a = round(self.ratio_high * 100)
            c = round(self.ratio_low8 * 100)
            return f"ratio_{a}D{100 - a - c}S" + (f"{c}Q" if c else "")
        return self.kind


def _role_counts(n: int, p: Policy, fset: FormatSet) -> tuple[int, int, int]:
    n_hi = int(round(p.ratio_high * n))
    n_lo8 = int(round(p.ratio_low8 * n))
    if n_lo8 and fset.low8 is None:
        raise ValueError(
            f"policy {p} requests a Q fraction but format set {fset.names} "
            "has no low8 role")
    n_lo = n - n_hi - n_lo8
    if n_lo < 0:
        raise ValueError(
            f"ratio_high + ratio_low8 = {p.ratio_high} + {p.ratio_low8} "
            f"exceeds 1 (policy {p.name()!r})")
    return n_hi, n_lo, n_lo8


def role_class_vector(n_hi: int, n_lo: int, n_lo8: int,
                      fset: FormatSet = DEFAULT_FORMATS) -> np.ndarray:
    """Class-code vector with the given role counts, HIGH block first."""
    if n_lo8 and fset.low8 is None:
        raise ValueError(f"format set {fset.names} has no low8 role")
    return np.concatenate([
        np.full(n_hi, fset.high, np.int8),
        np.full(n_lo, fset.low, np.int8),
        np.full(n_lo8, fset.low8 if n_lo8 else 0, np.int8),
    ])


def _ratio_map(mt: int, nt: int, p: Policy, fset: FormatSet) -> np.ndarray:
    flat = role_class_vector(*_role_counts(mt * nt, p, fset), fset)
    rng = np.random.default_rng(p.seed)
    rng.shuffle(flat)
    return flat.reshape(mt, nt)


def _norm_topk_map(w: np.ndarray, tile: int, p: Policy,
                   fset: FormatSet) -> np.ndarray:
    mt, nt = tile_grid(w.shape, tile)
    m, n = mt * tile, nt * tile
    wp = np.zeros((m, n), w.dtype)
    wp[: w.shape[0], : w.shape[1]] = w
    norms = np.linalg.norm(
        wp.reshape(mt, tile, nt, tile).transpose(0, 2, 1, 3), axis=(2, 3))
    k = int(round(p.ratio_high * mt * nt))
    cls = np.full((mt, nt), fset.low, np.int8)
    if k > 0:
        cls.flat[np.argsort(norms, axis=None)[::-1][:k]] = fset.high
    k8 = _role_counts(mt * nt, p, fset)[2]
    if k8:
        lo_idx = np.argsort(norms, axis=None)[:k8]
        keep = cls.flat[lo_idx] == fset.low
        cls.flat[lo_idx[keep]] = fset.low8
    return cls


def _outlier_map(w: np.ndarray, tile: int, p: Policy,
                 fset: FormatSet) -> np.ndarray:
    mt, nt = tile_grid(w.shape, tile)
    m, n = mt * tile, nt * tile
    wp = np.zeros((m, n), np.float32)
    wp[: w.shape[0], : w.shape[1]] = np.asarray(w, np.float32)
    tiles = wp.reshape(mt, tile, nt, tile).transpose(0, 2, 1, 3)
    amax = np.abs(tiles).max(axis=(2, 3))
    sigma = wp.std() + 1e-12
    return np.where(amax > p.outlier_sigma * sigma,
                    fset.high, fset.low).astype(np.int8)


def make_map(shape: tuple[int, int], tile: int, policy: Policy,
             weights: np.ndarray | None = None,
             fset: FormatSet = DEFAULT_FORMATS) -> np.ndarray:
    """Generate an int8[mt, nt] class-code map for a matrix of ``shape``."""
    mt, nt = tile_grid(shape, tile)
    if policy.kind == "uniform_high":
        return np.full((mt, nt), fset.high, np.int8)
    if policy.kind == "uniform_low":
        return np.full((mt, nt), fset.low, np.int8)
    if policy.kind == "uniform_low8":
        if fset.low8 is None:
            raise ValueError(f"format set {fset.names} has no low8 role")
        return np.full((mt, nt), fset.low8, np.int8)
    if policy.kind == "ratio":
        return _ratio_map(mt, nt, policy, fset)
    if policy.kind == "norm_topk":
        if weights is None:
            raise ValueError("norm_topk policy needs weights")
        return _norm_topk_map(np.asarray(weights), tile, policy, fset)
    if policy.kind == "outlier_aware":
        if weights is None:
            raise ValueError("outlier_aware policy needs weights")
        return _outlier_map(np.asarray(weights), tile, policy, fset)
    raise ValueError(f"unknown policy kind {policy.kind!r}")


def quantize_tile(x: torch.Tensor, cls: int,
                  fset: FormatSet = DEFAULT_FORMATS) -> torch.Tensor:
    """Round-trip a tile through its storage precision (the value the
    consumer's receiver-side conversion produces).  ``x`` is one tile:
    per-tile-scaled formats compute a single scale over it."""
    return fset.fmt(int(cls)).roundtrip(x)


#: named policies of the paper's sweep (Figs. 2-4)
PAPER_RATIOS: dict[str, Policy] = {
    "100D:0S": Policy(kind="uniform_high"),
    "80D:20S": Policy(kind="ratio", ratio_high=0.8),
    "50D:50S": Policy(kind="ratio", ratio_high=0.5),
    "20D:80S": Policy(kind="ratio", ratio_high=0.2),
    "0D:100S": Policy(kind="uniform_low"),
}
