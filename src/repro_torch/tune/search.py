"""Plan keys, candidate enumeration and the persistent JSON plan cache
(twin of ``repro.tune.search``).

The port keeps its own cache, never the JAX package's:

``REPRO_TORCH_TUNE_CACHE`` is the path of the JSON plan cache (default
``~/.cache/repro-torch-tune/plans.json``).

Cached plans are stamped with the format registry's signatures; a plan
whose formats were redefined since it was stored is not served.
"""
from __future__ import annotations

import json
import os
from typing import Iterable

from repro_torch.core.formats import registry_signatures
from repro_torch.tune.costmodel import (GemmPlan, GemmProblem, PATHS,
                                        predict_time, validate_plan)
from repro_torch.tune.device import DeviceSpec, detect_device

CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"
CACHE_SCHEMA = 1


def cache_path() -> str:
    return os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-torch-tune", "plans.json")


def plan_key(dev: DeviceSpec, prob: GemmProblem) -> str:
    return (f"{dev.kind}|{prob.op}|M{prob.m}N{prob.n}K{prob.k}"
            f"|t{prob.tile}|{prob.formats}|{prob.ratio_key()}"
            f"|{prob.struct_key()}")


def _key_formats(key: str) -> list[str]:
    parts = key.split("|")
    return parts[4].split("+") if len(parts) > 4 else []


class PlanCache:
    """JSON-persisted plan store, read lazily once per instance."""

    def __init__(self, path: str | None = None):
        self.path = path or cache_path()
        self._mem: dict[str, GemmPlan] = {}
        self._loaded = False

    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        stamps = raw.get("formats", {})
        current = registry_signatures()
        for key, ent in raw.get("plans", {}).items():
            names = _key_formats(key)
            if any(n not in current or stamps.get(n) != current[n]
                   for n in names):
                continue   # format unknown here or redefined since
            self._mem[key] = GemmPlan(path=ent["path"], bm=ent["bm"],
                                      bn=ent["bn"], bk=ent["bk"])

    def get(self, key: str) -> GemmPlan | None:
        self._ensure_loaded()
        return self._mem.get(key)

    def put(self, key: str, plan: GemmPlan) -> None:
        self._ensure_loaded()
        self._mem[key] = plan
        self.save()

    def save(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        plans = {key: {"path": p.path, "bm": p.bm, "bn": p.bn, "bk": p.bk}
                 for key, p in self._mem.items()}
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"schema": CACHE_SCHEMA,
                       "formats": registry_signatures(), "plans": plans},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    def keys(self) -> list[str]:
        self._ensure_loaded()
        return sorted(self._mem)


_default_cache: PlanCache | None = None


def default_cache() -> PlanCache:
    """Process-wide cache bound to the current cache path."""
    global _default_cache
    path = cache_path()
    if _default_cache is None or _default_cache.path != path:
        _default_cache = PlanCache(path)
    return _default_cache


def candidate_plans(prob: GemmProblem, dev: DeviceSpec | None = None,
                    paths: Iterable[str] = PATHS) -> list[GemmPlan]:
    """Every valid plan for the problem on this device."""
    dev = dev or detect_device()
    t = prob.tile
    cands = [GemmPlan(path=p, bm=t, bn=t, bk=t) for p in paths]
    return [p for p in cands if not validate_plan(p, prob, dev)]


def rank_plans(cands: list[GemmPlan], prob: GemmProblem,
               dev: DeviceSpec | None = None) -> list[tuple[GemmPlan, dict]]:
    """Model-predicted ranking, best first."""
    dev = dev or detect_device()
    scored = [(p, predict_time(p, prob, dev)) for p in cands]
    return sorted(scored, key=lambda pc: pc[1]["total_s"])
