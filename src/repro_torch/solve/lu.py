"""Blocked right-looking LU with mixed-precision trailing updates (numpy;
the port's own copy of ``repro.solve.lu``, bit-exact with it given the
same trailing products).

The HPL-MxP structure: panels are factored at working precision (fp32,
unpivoted — the operators the solver targets are SPD/diagonally dominant,
and row pivoting would desynchronize the per-tile precision map), while the
flops-dominant trailing-submatrix rank-``tile`` updates run through the
tile-centric GEMM stack: L21/U12 are wrapped as :class:`MPMatrix` carrying
the corresponding slices of A's class map (storage rounding per tile — the
mixed-precision part) and multiplied via ``tune.mp_matmul`` under a
prefetched plan, so the factorization exercises exactly the dispatch paths
the rest of the package tunes.

Everything outside the GEMMs is deterministic numpy fp32: two solves
whose GEMMs return the same products factor the same bits.
"""
from __future__ import annotations

import numpy as np


def unblocked_lu(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpivoted Doolittle LU of a small diagonal block (fp32).  Returns
    (L unit-lower, U upper).  Raises on a (numerically) zero pivot."""
    a = np.array(a, np.float32)
    t = a.shape[0]
    lo = np.eye(t, dtype=np.float32)
    for k in range(t):
        piv = a[k, k]
        if piv == 0.0 or not np.isfinite(piv):
            raise ZeroDivisionError(
                f"zero/non-finite pivot at panel row {k}: the refinement "
                "solver factors without pivoting — use an SPD or "
                "diagonally dominant operator (see "
                "repro_torch.solve.matrices)")
        lo[k + 1:, k] = a[k + 1:, k] / piv
        a[k + 1:, k:] -= np.outer(lo[k + 1:, k], a[k, k:])
    return lo, np.triu(a)


def _solve_unit_lower_small(lo: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = np.array(b, np.float32)
    for k in range(lo.shape[0]):
        x[k] -= lo[k, :k] @ x[:k]
    return x


def _solve_upper_small(u: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = np.array(b, np.float32)
    for k in range(u.shape[0] - 1, -1, -1):
        x[k] = (x[k] - u[k, k + 1:] @ x[k + 1:]) / u[k, k]
    return x


def _solve_lower_small(lo: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Forward substitution with a non-unit lower-triangular matrix."""
    x = np.array(b, np.float32)
    for k in range(lo.shape[0]):
        x[k] = (x[k] - lo[k, :k] @ x[:k]) / lo[k, k]
    return x


def solve_unit_lower(lu: np.ndarray, b: np.ndarray, tile: int) -> np.ndarray:
    """Blocked forward substitution ``L·y = b`` on the packed L\\U factor
    (unit-lower part), fp32."""
    y = np.array(b, np.float32)
    n = lu.shape[0]
    for s in range(0, n, tile):
        e = s + tile
        y[s:e] -= lu[s:e, :s].astype(np.float32) @ y[:s]
        lo = np.tril(lu[s:e, s:e], -1).astype(np.float32)
        np.fill_diagonal(lo, 1.0)
        y[s:e] = _solve_unit_lower_small(lo, y[s:e])
    return y


def solve_upper(lu: np.ndarray, y: np.ndarray, tile: int) -> np.ndarray:
    """Blocked back substitution ``U·x = y`` on the packed L\\U factor
    (upper part), fp32."""
    x = np.array(y, np.float32)
    n = lu.shape[0]
    for s in range(n - tile, -1, -tile):
        e = s + tile
        x[s:e] -= lu[s:e, e:].astype(np.float32) @ x[e:]
        x[s:e] = _solve_upper_small(np.triu(lu[s:e, s:e]).astype(np.float32),
                                    x[s:e])
    return x


def blocked_lu(a_stored: np.ndarray, cls_map: np.ndarray, tile: int,
               trailing_gemm) -> tuple[np.ndarray, dict]:
    """Right-looking blocked LU of the storage-quantized operator.

    ``a_stored`` is the dense fp32 view of the tile-quantized A (the solver
    factors the operator it can afford to represent — HPL-MxP's
    low-precision LU).  ``trailing_gemm(l21, u12, step)`` must return the
    dense fp32 product of the two MPMatrix-wrapped panels; the caller
    routes it through ``tune.mp_matmul`` (or any dispatch path) with its
    prefetched plan for ``step``.

    Returns the packed L\\U factor (fp32) and stats: trailing-update GEMM
    flops vs total factorization flops (the bench's "GEMM fraction").
    """
    m = np.array(a_stored, np.float32)
    n = m.shape[0]
    if n != m.shape[1] or n % tile:
        raise ValueError(f"blocked_lu needs square N%tile==0, got {m.shape} "
                         f"tile {tile}")
    nt = n // tile
    gemm_flops = 0
    for k in range(nt):
        s, e = k * tile, (k + 1) * tile
        lo, up = unblocked_lu(m[s:e, s:e])
        m[s:e, s:e] = np.tril(lo, -1) + up
        if e == n:
            break
        # panel solves at working precision (fp32, deterministic numpy)
        m[s:e, e:] = _solve_unit_lower_small(lo, m[s:e, e:])     # U12
        # L21·U11 = A21  ⇒  U11ᵀ·L21ᵀ = A21ᵀ (non-unit lower solve)
        m[e:, s:e] = _solve_lower_small(up.T.astype(np.float32),
                                        m[e:, s:e].T).T          # L21
        # mixed-precision trailing update through the dispatch stack
        prod = trailing_gemm(m[e:, s:e], m[s:e, e:], k)
        m[e:, e:] -= np.asarray(prod, np.float32)
        gemm_flops += 2 * (n - e) * tile * (n - e)
    total = 2 * n ** 3 // 3
    return m, {"gemm_flops": gemm_flops, "total_flops": total,
               "gemm_fraction": gemm_flops / max(total, 1)}
