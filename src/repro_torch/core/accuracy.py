"""Registry-derived forward-error bounds — the accuracy oracle (numpy
fp64 twin of ``repro.core.accuracy``).

    |Ĉ - C_fp64|(i,j)  ≤  bound[cls_C(i,j)] · (|A|·|B| + |β|·|C|)(i,j)
    bound[c] = safety · (u_A + u_B + 2·u_op(c) + K·u_fp32 + u_store(c))

``u`` is the unit roundoff of each format (storage or compute), taken
from the port's format registry.  Per-tile-scaled integer classes widen
the error scale to per-tile absmax envelopes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import (DEFAULT_FORMATS, FormatSet,
                                      unit_roundoff)

#: default slack over the first-order bound
DEFAULT_SAFETY = 4.0


def _worst_storage_u(cls_map: np.ndarray, fset: FormatSet) -> float:
    return max(fset.fmt(int(c)).storage_roundoff()
               for c in np.unique(np.asarray(cls_map)))


def class_error_bounds(pa: np.ndarray, pb: np.ndarray, pc: np.ndarray,
                       k: int, fset: FormatSet = DEFAULT_FORMATS,
                       safety: float = DEFAULT_SAFETY) -> dict[int, float]:
    """Per-C-class relative forward-error bound vs an fp64 reference
    (``k`` is the contraction extent in elements)."""
    pa, pb, pc = (np.asarray(p) for p in (pa, pb, pc))
    u32 = unit_roundoff(torch.float32)
    u_a = _worst_storage_u(pa, fset)
    u_b = _worst_storage_u(pb, fset)
    u_op_b = max(fset.fmt(int(c)).operational_roundoff()
                 for c in np.unique(pb))
    out: dict[int, float] = {}
    for c in np.unique(pc):
        fmt = fset.fmt(int(c))
        u_op = max(fmt.operational_roundoff(), u_op_b)
        out[int(c)] = safety * (u_a + u_b + 2.0 * u_op + k * u32
                                + fmt.storage_roundoff())
    return out


def _tile_max_envelope(x_abs: np.ndarray, cls_map: np.ndarray, tile: int,
                       fset: FormatSet) -> np.ndarray:
    """``x_abs`` with every per-tile-scaled tile flattened to its max."""
    cls_map = np.asarray(cls_map)
    scaled = {int(c) for c in np.unique(cls_map)
              if fset.fmt(int(c)).per_tile_scaled}
    if not scaled:
        return x_abs
    out = np.array(x_abs, np.float64, copy=True)
    mt, nt = cls_map.shape
    for i in range(mt):
        for j in range(nt):
            if int(cls_map[i, j]) not in scaled:
                continue
            blk = out[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
            if blk.size:
                blk[...] = blk.max()
    return out


def check_against_fp64(out_dense, a, b, c, pa: np.ndarray, pb: np.ndarray,
                       pc: np.ndarray, tile: int,
                       fset: FormatSet = DEFAULT_FORMATS, *,
                       alpha: float = 1.0, beta: float = 0.0,
                       safety: float = DEFAULT_SAFETY) -> dict:
    """Compare a path's dense output against the fp64 ``α·A·B + β·C`` of
    the exact (pre-rounding) operands.  Returns the worst bound-normalized
    error per C class; ``ok`` iff all are ≤ 1."""
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    c64 = (np.zeros((a64.shape[0], b64.shape[1])) if c is None
           else np.asarray(c, np.float64))
    exact = alpha * (a64 @ b64) + beta * c64
    err = np.abs(np.asarray(out_dense, np.float64) - exact)
    aa = _tile_max_envelope(np.abs(a64), pa, tile, fset)
    bb = _tile_max_envelope(np.abs(b64), pb, tile, fset)
    cc = _tile_max_envelope(np.abs(c64), pc, tile, fset)
    scale = aa @ bb
    if beta:
        scale = scale + abs(beta) * cc
    scale = _tile_max_envelope(abs(alpha) * scale, pc, tile, fset) + 1e-30
    bounds = class_error_bounds(pa, pb, pc, a64.shape[1], fset, safety)
    sel = np.repeat(np.repeat(np.asarray(pc), tile, 0), tile, 1)
    sel = sel[: err.shape[0], : err.shape[1]]
    worst = {}
    for cls, bound in bounds.items():
        mask = sel == cls
        if not mask.any():
            continue
        worst[cls] = float((err[mask] / (bound * scale[mask])).max())
    return {"worst_ratio": worst, "bounds": bounds,
            "ok": all(v <= 1.0 for v in worst.values())}
