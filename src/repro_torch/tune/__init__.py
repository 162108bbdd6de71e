"""Hardware-aware dispatch: device table, cost model, plan cache, and the
``mp_matmul`` / ``linear_matmul`` entry points."""
from repro_torch.tune.costmodel import GemmPlan, GemmProblem, PATHS
from repro_torch.tune.device import DEVICE_TABLE, DeviceSpec, detect_device
from repro_torch.tune.dispatch import (execute_plan, linear_matmul, mp_matmul,
                                       resolve_plan,
                                       resolve_plans_for_buckets,
                                       tune_linear_params)

__all__ = [
    "DEVICE_TABLE", "DeviceSpec", "GemmPlan", "GemmProblem", "PATHS",
    "detect_device", "execute_plan", "linear_matmul", "mp_matmul",
    "resolve_plan", "resolve_plans_for_buckets", "tune_linear_params",
]
