"""Registry-derived forward-error bounds — the accuracy oracle (numpy
fp64 twin of ``repro.core.accuracy``).

    |Ĉ - C_fp64|(i,j)  ≤  bound[cls_C(i,j)] · (|A|·|B| + |β|·|C|)(i,j)
    bound[c] = safety · (u_A + u_B + 2·u_op(c) + K·u_fp32 + u_store(c))

``u`` is the unit roundoff of each format (storage or compute), taken
from the port's format registry.  Per-tile-scaled integer classes widen
the error scale to per-tile absmax envelopes.

The refinement solver's oracles live here too: the HPL-MxP acceptance
metric and the per-tile residual attribution that decides promotion.
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


def error_scale(a: np.ndarray, b: np.ndarray, c: np.ndarray | None = None,
                beta: float = 0.0) -> np.ndarray:
    """Per-element magnitude the relative bounds scale by:
    (|A|·|B|)(i,j) + |β|·|C|(i,j), computed in fp64."""
    s = np.abs(np.asarray(a, np.float64)) @ np.abs(np.asarray(b, np.float64))
    if beta and c is not None:
        s = s + abs(beta) * np.abs(np.asarray(c, np.float64))
    return s


def hpl_mxp_metric(a_exact: np.ndarray, x: np.ndarray, b: np.ndarray,
                   fset: FormatSet = DEFAULT_FORMATS) -> float:
    """HPL-MxP acceptance metric ``||Ax-b||_inf / (||A||_inf·||x||_inf·n·u)``
    in fp64 against the exact operator; ``u`` is the HIGH role's storage
    roundoff."""
    a64 = np.asarray(a_exact, np.float64)
    x64 = np.asarray(x, np.float64)
    b64 = np.asarray(b, np.float64)
    r = np.abs(a64 @ x64 - b64).max()
    u = fset.fmt(fset.high).storage_roundoff()
    denom = (np.abs(a64).sum(axis=1).max()
             * np.abs(x64).max() * a64.shape[0] * u)
    return float(r / max(denom, 1e-300))


def tile_rounding_contribution(a_exact: np.ndarray, a_stored: np.ndarray,
                               x: np.ndarray, tile: int) -> np.ndarray:
    """Per-tile worst-row share of the storage-rounding residual
    ``Σ_j |A-Â|[ti, tj]·|x|[tj]`` as an ``[mt, nt]`` matrix (fp64).  A
    tile whose storage overflowed (NaN or inf) counts as a huge finite
    error, so it dominates every budget."""
    d = np.abs(np.asarray(a_exact, np.float64)
               - np.asarray(a_stored, np.float64))
    d = np.nan_to_num(d, nan=1e300, posinf=1e300)
    xa = np.abs(np.asarray(x, np.float64))
    if xa.ndim == 1:
        xa = xa[:, None]
    m, n = d.shape
    mt, nt = m // tile, n // tile
    per_row = np.empty((m, nt))
    for j in range(nt):
        per_row[:, j] = (d[:, j * tile:(j + 1) * tile]
                         @ xa[j * tile:(j + 1) * tile]).max(axis=1)
    return per_row.reshape(mt, tile, nt).max(axis=1)


def escalation_threshold(a_exact: np.ndarray, x: np.ndarray, tile: int,
                         fset: FormatSet = DEFAULT_FORMATS,
                         safety: float = DEFAULT_SAFETY) -> np.ndarray:
    """Per-tile residual budget ``safety · u_high · (|A|·|x|)/nt``."""
    a64 = np.abs(np.asarray(a_exact, np.float64))
    xa = np.abs(np.asarray(x, np.float64))
    if xa.ndim == 1:
        xa = xa[:, None]
    m, n = a64.shape
    mt, nt = m // tile, n // tile
    u_high = fset.fmt(fset.high).storage_roundoff()
    row_scale = (a64 @ xa).max(axis=1)
    tile_rows = row_scale.reshape(mt, tile).max(axis=1)
    return safety * u_high * np.repeat(tile_rows[:, None], nt, axis=1) / nt


def promotion_mask(a_exact: np.ndarray, a_stored: np.ndarray, x: np.ndarray,
                   cls_map: np.ndarray, tile: int,
                   fset: FormatSet = DEFAULT_FORMATS,
                   safety: float = DEFAULT_SAFETY) -> np.ndarray:
    """``[mt, nt]`` mask of tiles whose rounding contribution exceeds
    their budget and that still have a higher role to escalate to."""
    contrib = tile_rounding_contribution(a_exact, a_stored, x, tile)
    budget = escalation_threshold(a_exact, x, tile, fset, safety)
    return (contrib > budget) & (np.asarray(cls_map) < fset.high)


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
