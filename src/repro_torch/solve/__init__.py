"""repro_torch.solve — mixed-precision iterative-refinement linear solvers
(twin of ``repro.solve``): blocked LU or Jacobi-CG over an
:class:`~repro_torch.core.layout.MPMatrix` operator whose GEMMs run on
the port's kernels, with residual-driven escalation of the per-tile
precision map.  See ``refine.py``."""
from repro_torch.solve.matrices import (diag_dominant, graded_spd,
                                        rhs_for_solution)
from repro_torch.solve.refine import SolveConfig, SolveReport, solve

__all__ = [
    "SolveConfig", "SolveReport", "solve",
    "graded_spd", "diag_dominant", "rhs_for_solution",
]
