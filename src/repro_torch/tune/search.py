"""Plan keys, candidate enumeration, the measuring search and the
persistent JSON plan cache (twin of ``repro.tune.search``).

The search enumerates the plans the cost model finds valid on this
device, *measures* the best few by the model (warmup, then the median of
``iters`` timed calls) and persists the winner under its plan key.

Settings (``repro_torch.configure(...)``, else the environment; see
:mod:`repro_torch.config`):

* ``tune_cache`` / ``REPRO_TORCH_TUNE_CACHE`` — path of the JSON plan
  cache (default ``~/.cache/repro-torch-tune/plans.json``).  The port
  keeps its own cache, never the JAX package's.
* ``tune_cache_only`` / ``REPRO_TORCH_TUNE_CACHE_ONLY=1`` — never
  measure: serve cached plans, fall back to the cost model's best valid
  plan on a miss.
* ``device`` / ``REPRO_TORCH_TUNE_DEVICE`` — see
  ``tune.device.detect_device``.

Cached plans are stamped with the format registry's signatures; a plan
whose formats were redefined since it was stored is not served, and one
naming a format this process has not registered is kept on disk
untouched but not served.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterable

import torch

from repro_torch import config
from repro_torch.core.formats import registry_signatures
from repro_torch.tune.costmodel import (GemmPlan, GemmProblem, PATHS,
                                        predict_time, validate_plan)
from repro_torch.tune.device import DeviceSpec, detect_device

CACHE_ENV = config.KNOWN_SETTINGS["tune_cache"][0]
CACHE_ONLY_ENV = config.KNOWN_SETTINGS["tune_cache_only"][0]

#: persisted plan-cache schema: 2 adds per-plan meta (``source``,
#: ``measured_us``, ``predicted_us``); a schema-1 file is read as plans
#: without meta (its keys already have the 9-segment layout)
CACHE_SCHEMA = 2

#: the fields of a plan entry that are the plan itself (the rest is meta)
_PLAN_FIELDS = ("path", "bm", "bn", "bk")


def cache_path() -> str:
    return str(config.get("tune_cache") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-torch-tune", "plans.json"))


def cache_only() -> bool:
    return config.get_bool("tune_cache_only")


def plan_key(dev: DeviceSpec, prob: GemmProblem) -> str:
    return (f"{dev.kind}|{prob.op}|M{prob.m}N{prob.n}K{prob.k}"
            f"|t{prob.tile}|{prob.formats}|{prob.ratio_key()}"
            f"|{prob.struct_key()}")


def _key_formats(key: str) -> list[str]:
    parts = key.split("|")
    return parts[4].split("+") if len(parts) > 4 else []


class PlanCache:
    """JSON-persisted plan store with per-plan meta, read lazily once per
    instance."""

    def __init__(self, path: str | None = None):
        self.path = path or cache_path()
        self._mem: dict[str, GemmPlan] = {}
        self._meta: dict[str, dict] = {}
        # plans naming formats not registered in this process: never
        # served, written back verbatim (entry and stamps) by save()
        self._shelved: dict[str, dict] = {}
        self._shelved_stamps: dict[str, str] = {}
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
            if any(stamps.get(n, current[n]) != current[n]
                   for n in names if n in current):
                continue   # a format redefined since the plan was stored
            unknown = [n for n in names if n not in current]
            if unknown:
                self._shelved[key] = dict(ent)
                for n in unknown:
                    if n in stamps:
                        self._shelved_stamps[n] = stamps[n]
                continue
            self._mem[key] = GemmPlan(path=ent["path"], bm=ent["bm"],
                                      bn=ent["bn"], bk=ent["bk"])
            self._meta[key] = {k: v for k, v in ent.items()
                               if k not in _PLAN_FIELDS}

    def get(self, key: str) -> GemmPlan | None:
        self._ensure_loaded()
        return self._mem.get(key)

    def meta(self, key: str) -> dict:
        self._ensure_loaded()
        return dict(self._meta.get(key, {}))

    def put(self, key: str, plan: GemmPlan, *, persist: bool = True,
            **meta) -> None:
        """Store ``plan`` under ``key`` with ``meta`` (e.g. ``source=``,
        ``measured_us=``, ``predicted_us=``); ``persist=False`` keeps it
        in memory only."""
        self._ensure_loaded()
        self._mem[key] = plan
        self._meta[key] = dict(meta)
        if persist:
            self.save()

    def save(self) -> None:
        self._ensure_loaded()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        plans = {}
        for key, p in self._mem.items():
            plans[key] = {"path": p.path, "bm": p.bm, "bn": p.bn,
                          "bk": p.bk, **self._meta.get(key, {})}
        plans.update(self._shelved)
        stamps = {**self._shelved_stamps, **registry_signatures()}
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"schema": CACHE_SCHEMA, "formats": stamps,
                       "plans": plans}, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    def save_as(self, path: str) -> "PlanCache":
        """Write this cache's whole content (plans, meta, shelved entries
        and their stamps) to ``path``; returns the new cache."""
        self._ensure_loaded()
        out = PlanCache(path)
        out._loaded = True
        out._mem = dict(self._mem)
        out._meta = {k: dict(v) for k, v in self._meta.items()}
        out._shelved = {k: dict(v) for k, v in self._shelved.items()}
        out._shelved_stamps = dict(self._shelved_stamps)
        out.save()
        return out

    def __len__(self) -> int:
        self._ensure_loaded()
        return len(self._mem)

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


# ---------------------------------------------------------------------------
# Candidate enumeration + measurement
# ---------------------------------------------------------------------------

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


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of every tensor in ``out`` (tensors, sequences,
    dicts, and objects holding ``bufs`` such as MPMatrix)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    elif hasattr(out, "bufs"):
        _cuda_devices(tuple(out.bufs), found)
    return found


def measure(fn: Callable[[], object], *, warmup: int = 1,
            iters: int = 5) -> float:
    """Median host wall-clock seconds of ``fn()`` until its result is
    ready: each timed call runs ``fn`` and then synchronizes every CUDA
    device its outputs live on, as the reference blocks until its
    outputs are ready.  The time so covers the call's host work (class
    map uploads, permutations) and its device work alike; builds and
    first-call costs stay in the ``warmup`` calls."""

    def run_once() -> float:
        t0 = time.perf_counter()
        out = fn()
        for dev in _cuda_devices(out, set()):
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    for _ in range(max(warmup, 1)):
        run_once()
    times = sorted(run_once() for _ in range(max(iters, 1)))
    return times[len(times) // 2]


def autotune_problem(prob: GemmProblem, run_plan: Callable[[GemmPlan], object],
                     *, dev: DeviceSpec | None = None,
                     paths: Iterable[str] = PATHS,
                     cache: PlanCache | None = None,
                     max_measure: int = 4, warmup: int = 1, iters: int = 5,
                     force: bool = False, timer: Callable | None = None
                     ) -> tuple[GemmPlan, dict]:
    """Pick (and persist) the best plan for ``prob``.

    Order: a cached plan (unless ``force``); in cache-only mode the cost
    model's best, kept in memory with ``source="model"``; else the best
    ``max_measure`` plans by the model are measured with ``run_plan(plan)``
    (which executes the problem under that plan and returns its output),
    a candidate that raises is kept as an error row, and the fastest is
    persisted with ``source="measured"``.  ``timer`` replaces
    :func:`measure` (same signature; SUMMA's takes the slowest rank's
    time).  Returns ``(plan, report)``.
    """
    dev = dev or detect_device()
    # an empty PlanCache is falsy (__len__): test for None
    cache = cache if cache is not None else default_cache()
    key = plan_key(dev, prob)
    if not force:
        hit = cache.get(key)
        if hit is not None:
            return hit, {"key": key, "source": "cache", **cache.meta(key)}

    cands = candidate_plans(prob, dev, paths)
    if not cands:
        raise ValueError(f"no valid plan for {key} (paths={list(paths)})")
    ranked = rank_plans(cands, prob, dev)
    if cache_only():
        best, pred = ranked[0]
        cache.put(key, best, persist=False, source="model",
                  predicted_us=pred["total_s"] * 1e6)
        return best, {"key": key, "source": "model",
                      "predicted_us": pred["total_s"] * 1e6}

    timer = timer or measure
    rows = []
    for plan, pred in ranked[:max_measure]:
        try:
            t = timer(lambda p=plan: run_plan(p), warmup=warmup,
                      iters=iters)
        except Exception as e:  # noqa: BLE001 — a plan the device refuses
            rows.append({"plan": plan.key(), "error": repr(e)})
            continue
        rows.append({"plan": plan.key(), "measured_us": t * 1e6,
                     "predicted_us": pred["total_s"] * 1e6})
    timed = [r for r in rows if "measured_us" in r]
    if not timed:
        raise RuntimeError(f"every candidate failed for {key}: {rows}")
    best_row = min(timed, key=lambda r: r["measured_us"])
    best = next(p for p, _ in ranked if p.key() == best_row["plan"])
    cache.put(key, best, source="measured",
              measured_us=best_row["measured_us"],
              predicted_us=best_row["predicted_us"])
    return best, {"key": key, "source": "measured", "candidates": rows,
                  **best_row}


def autotune(a, b, c=None, *, alpha: float = 1.0, beta: float = 0.0,
             **kw) -> GemmPlan:
    """Autotune one MPMatrix GEMM and cache the winner: call
    ``autotune(A, B, C)`` once at setup, then every ``mp_matmul(A, B, C)``
    of that signature routes through the cached plan."""
    from repro_torch.tune import dispatch as D
    a, b, c = D.canonical_operands(a, b, c)
    prob = D.problem_of(a, b, c, alpha=alpha, beta=beta)
    kw.setdefault("dev", detect_device(a.device))
    plan, _ = autotune_problem(
        prob, lambda p: D.execute_plan(p, a, b, c, alpha=alpha, beta=beta),
        **kw)
    return plan
