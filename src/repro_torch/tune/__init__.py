"""Hardware-aware dispatch: device table, cost model, the measuring
search with its plan cache, and the ``mp_matmul`` / ``linear_matmul``
entry points (twin of ``repro.tune``).

Two-line API::

    from repro_torch.tune import autotune, mp_matmul
    autotune(A, B, C)          # measure candidates once, persist the winner
    out = mp_matmul(A, B, C)   # routed through the cached plan
"""
from repro_torch.tune.costmodel import GemmPlan, GemmProblem, PATHS
from repro_torch.tune.device import DEVICE_TABLE, DeviceSpec, detect_device
from repro_torch.tune.dispatch import (SOLVE_PATHS, SUMMA_PATHS,
                                       autotune_summa, clear_registry,
                                       execute_plan, fresh_resolutions,
                                       linear_matmul, mp_matmul,
                                       register_plan, resolution_counters,
                                       resolve_plan,
                                       resolve_plans_for_buckets,
                                       reset_resolution_counters,
                                       resolve_solve_plans,
                                       resolve_summa_plan,
                                       solve_gemm_problem, summa_mp_matmul,
                                       summa_problem, tune_linear_params,
                                       warm_registry)
from repro_torch.tune.search import (PlanCache, autotune, candidate_plans,
                                     measure)

__all__ = [
    "DEVICE_TABLE", "DeviceSpec", "GemmPlan", "GemmProblem", "PATHS",
    "detect_device", "PlanCache", "autotune", "measure", "candidate_plans",
    "execute_plan", "linear_matmul", "mp_matmul", "resolve_plan",
    "clear_registry", "register_plan", "tune_linear_params",
    "warm_registry", "resolve_plans_for_buckets", "summa_mp_matmul",
    "summa_problem", "resolve_summa_plan", "autotune_summa", "SUMMA_PATHS",
    "resolve_solve_plans", "solve_gemm_problem", "SOLVE_PATHS",
    "resolution_counters", "reset_resolution_counters",
    "fresh_resolutions",
]
