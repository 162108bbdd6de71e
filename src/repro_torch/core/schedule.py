"""Static load-balancing of precision maps (twin of
``repro.core.schedule``; numpy only, maps bit for bit the reference's).

The paper relies on PaRSEC's dynamic scheduler to absorb the cost variance
between FP64 and FP32 tile tasks scattered block-cyclically over the process
grid.  SUMMA over ``torch.distributed`` runs every rank through the same
static step loop, so there is no work stealing; the variance is removed
*by construction*:

* ``balanced_ratio_map``        — every (shard-) group of tiles receives the
  exact same class counts; the max-shard cost equals the mean (imbalance 1.0),
  which is the fixed point PaRSEC's scheduler converges toward.
* ``sorted_balanced_map``       — additionally sorts classes within each
  panel so compact per-class slices have static shapes (needed by the
  storage-precision SUMMA collectives, see core/summa.py).
* ``shard_costs`` / ``imbalance`` — the cost model (matmul passes per class)
  used to quantify what dynamic scheduling would have had to absorb.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import DEFAULT_FORMATS, FormatSet
from repro_torch.core.precision import Policy, role_class_vector


def _policy_ratios(policy: Policy) -> tuple[float, float]:
    """Effective (ratio_high, ratio_low8) honouring uniform_* kinds."""
    if policy.kind == "uniform_high":
        return 1.0, 0.0
    if policy.kind == "uniform_low":
        return 0.0, 0.0
    if policy.kind == "uniform_low8":
        return 0.0, 1.0
    return policy.ratio_high, policy.ratio_low8


def _exact_counts(n: int, ratio_high: float, ratio_low8: float = 0.0
                  ) -> tuple[int, int, int]:
    n_hi = int(round(ratio_high * n))
    n_lo8 = int(round(ratio_low8 * n))
    n_lo = n - n_hi - n_lo8
    if n_lo < 0:
        raise ValueError(
            f"ratio_high + ratio_low8 = {ratio_high} + {ratio_low8} exceeds "
            "1: the D/Q role fractions must leave a non-negative S remainder")
    return n_hi, n_lo, n_lo8


def balanced_ratio_map(mt: int, nt: int, policy: Policy,
                       row_groups: int = 1, col_groups: int = 1,
                       fset: FormatSet = DEFAULT_FORMATS) -> np.ndarray:
    """Random map whose class counts are identical in every
    (mt/row_groups × nt/col_groups) group of tiles."""
    if mt % row_groups or nt % col_groups:
        raise ValueError(
            f"shard groups {row_groups}x{col_groups} must divide the tile "
            f"grid {mt}x{nt}")
    rg, cg = mt // row_groups, nt // col_groups
    n_hi, n_lo, n_lo8 = _exact_counts(rg * cg, *_policy_ratios(policy))
    rng = np.random.default_rng(policy.seed)
    out = np.empty((mt, nt), np.int8)
    base = role_class_vector(n_hi, n_lo, n_lo8, fset)
    for i in range(row_groups):
        for j in range(col_groups):
            blk = base.copy()
            rng.shuffle(blk)
            out[i * rg:(i + 1) * rg, j * cg:(j + 1) * cg] = blk.reshape(rg, cg)
    return out


def sorted_balanced_map(mt: int, nt: int, policy: Policy, axis: int,
                        groups: int = 1,
                        fset: FormatSet = DEFAULT_FORMATS) -> np.ndarray:
    """Balanced map sorted within each panel.

    ``axis=0``: within every tile-*column*, HIGH tiles occupy the lowest row
    indices (A-matrix panels for SUMMA).  ``axis=1``: within every tile-*row*,
    HIGH tiles occupy the lowest column indices (B-matrix panels).  ``groups``
    splits the sorted axis into that many shard groups, each sorted
    independently (so every shard's slice is class-contiguous)."""
    panel_len = mt if axis == 0 else nt
    n_panels = nt if axis == 0 else mt
    if panel_len % groups:
        raise ValueError(
            f"sorted_balanced_map: {groups} shard groups must divide the "
            f"panel length {panel_len} (axis={axis}); pick a tile grid that "
            f"is a multiple of the device-grid extent")
    seg = panel_len // groups
    n_hi, n_lo, n_lo8 = _exact_counts(seg, *_policy_ratios(policy))
    col = role_class_vector(n_hi, n_lo, n_lo8, fset)
    panel = np.tile(col, groups)
    out = np.tile(panel[:, None], (1, n_panels))
    return out if axis == 0 else out.T.copy()


def class_counts_per_group(cls_map: np.ndarray, row_groups: int,
                           col_groups: int,
                           fset: FormatSet = DEFAULT_FORMATS) -> np.ndarray:
    """int[row_groups, col_groups, n_formats] class histogram per group."""
    mt, nt = cls_map.shape
    rg, cg = mt // row_groups, nt // col_groups
    out = np.zeros((row_groups, col_groups, len(fset)), np.int64)
    for i in range(row_groups):
        for j in range(col_groups):
            blk = cls_map[i * rg:(i + 1) * rg, j * cg:(j + 1) * cg]
            for c in fset.codes:
                out[i, j, c] = int((blk == c).sum())
    return out


def is_shard_balanced(cls_map: np.ndarray, row_groups: int, col_groups: int,
                      fset: FormatSet = DEFAULT_FORMATS) -> bool:
    """True when every shard group holds identical per-class tile counts —
    the invariant the grouped SUMMA local update needs for a static kernel
    grid (``balanced_ratio_map`` with matching groups guarantees it)."""
    cls_map = np.asarray(cls_map)
    if cls_map.shape[0] % row_groups or cls_map.shape[1] % col_groups:
        return False
    counts = class_counts_per_group(cls_map, row_groups, col_groups, fset)
    return bool((counts == counts[0, 0]).all())


def shard_costs(cls_map: np.ndarray, row_groups: int, col_groups: int,
                fset: FormatSet = DEFAULT_FORMATS,
                device_kind: str = "tpu-v5e") -> np.ndarray:
    """Per-shard matmul-pass cost of the tile tasks it owns (``device_kind``
    picks each format's ``pass_cost`` entry; the reference's default)."""
    counts = class_counts_per_group(cls_map, row_groups, col_groups, fset)
    w = np.array([fset.fmt(c).cost_on(device_kind) for c in fset.codes])
    return (counts * w).sum(-1)


def imbalance(cls_map: np.ndarray, row_groups: int, col_groups: int,
              fset: FormatSet = DEFAULT_FORMATS) -> float:
    """max/mean shard cost — 1.0 is perfectly balanced (what PaRSEC's dynamic
    scheduler achieves asymptotically; what our maps achieve statically)."""
    c = shard_costs(cls_map, row_groups, col_groups, fset)
    return float(c.max() / max(c.mean(), 1e-12))
