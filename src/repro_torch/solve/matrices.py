"""Test operators for the refinement solver (numpy; the port's own copy
of ``repro.solve.matrices``, bit-exact with it).

HPL-MxP benchmarks on synthetically conditioned systems; the generators
here give the solver battery the two regimes that matter for tile-centric
adaptive precision:

* ``graded_spd``   — SPD with a geometrically graded diagonal (condition
  number ``cond``) over a decaying Toeplitz correlation (Kac–Murdock–Szegő).
  The entry magnitudes span many orders across tiles, so the residual
  attribution promotes only the tiles that matter — the final escalated map
  stays far cheaper than uniform-HIGH.  Unpivoted blocked LU is stable
  (SPD), matching the solver's static tile maps (row pivoting would
  desynchronize per-tile precision metadata).
* ``diag_dominant`` — dense random with a dominant diagonal: the benign
  regime where refinement converges after little or no escalation.

All generators return fp64 (the *exact* operator; quantization to the tile
map is the solver's job).
"""
from __future__ import annotations

import numpy as np


def kms_correlation(n: int, rho: float = 0.9) -> np.ndarray:
    """Kac–Murdock–Szegő matrix ``rho^|i-j|`` — SPD for 0 <= rho < 1, with
    entry magnitudes decaying geometrically off the diagonal."""
    idx = np.arange(n)
    return rho ** np.abs(idx[:, None] - idx[None, :]).astype(np.float64)


def graded_spd(n: int, cond: float = 1e6, rho: float = 0.9,
               seed: int = 0) -> np.ndarray:
    """SPD ``D^{1/2}·C·D^{1/2}`` with KMS correlation C and a geometric
    diagonal grading spanning ``cond`` (shuffled so expensive rows scatter
    over the tile grid instead of sorting by magnitude)."""
    c = kms_correlation(n, rho)
    grade = cond ** (np.arange(n) / max(n - 1, 1))
    rng = np.random.default_rng(seed)
    rng.shuffle(grade)
    s = np.sqrt(grade)
    return (s[:, None] * c) * s[None, :]


def diag_dominant(n: int, dominance: float = 2.0, seed: int = 0
                  ) -> np.ndarray:
    """Dense random matrix made strictly diagonally dominant (factor
    ``dominance`` over the off-diagonal row sums) — unpivoted-LU safe."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    np.fill_diagonal(a, 0.0)
    d = dominance * np.abs(a).sum(axis=1)
    np.fill_diagonal(a, np.where(d > 0, d, 1.0))
    return a


def rhs_for_solution(a: np.ndarray, nrhs: int = 1, seed: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(x_true, b) with ``b = A·x_true`` computed in fp64 — the solver's
    convergence is then measurable against a known solution."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((a.shape[0], nrhs))
    return x, np.asarray(a, np.float64) @ x
