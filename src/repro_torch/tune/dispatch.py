"""Unified mixed-precision GEMM dispatch — ``mp_matmul``, ``linear_matmul``
and the plan registry (twin of ``repro.tune.dispatch``).

Every execution path is registered behind one entry point; a resolved
``GemmPlan`` (explicit argument > in-memory registry > persisted cache >
cost-model best) picks the path.  On ``gpu-h100`` the cost model routes
``mp_matmul`` to the ``tile`` CUDA kernel (the ``split`` kernel when C
has split compound classes) and every sorted-map KSplit linear to the
``ksplit_cuda`` kernel at every M (the kernel masks ragged rows itself,
and its fixed summation order makes a row's result the same at any M);
on other devices the plain PyTorch paths run.  The refinement solver
prefetches every plan it can need (``resolve_solve_plans``).

``tune_linear_params(..., measure=True)``, :func:`autotune_summa` and
``search.autotune`` measure the candidates on the device and persist the
winners; by default every resolution is the cost model's or a cached
plan, never a measurement.

Counters (in :func:`repro_torch.obs.metrics_registry`):

* ``tune.plan_resolutions{source=registry|cache|model}`` — a ``model``
  resolution is fresh work; serving must do none after warmup (SUMMA
  resolutions count under ``summa_registry|summa_cache|summa_default``,
  a ``summa_default`` one being fresh too);
* ``dispatch.calls{path, op, formats}`` — one per dispatched GEMM.

Trace events (when ``repro_torch.obs`` tracing is on): ``plan.resolve``
per resolution (key, source) and a ``gemm.dispatch`` span around
``mp_matmul``'s execution (host time: the span closes when the launches
are enqueued).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.layout import (CompactMPMatrix, KSplitWeight, MPMatrix,
                                     ksplit_matmul, ksplit_matmul_vjp)
from repro_torch.core.mp_gemm import mp_gemm_ref
from repro_torch.kernels import ops
from repro_torch.tune import search as S
from repro_torch.tune.costmodel import (GemmPlan, GemmProblem, PATHS,
                                        validate_plan)
from repro_torch.tune.device import DeviceSpec, detect_device

#: in-memory plan registry: plan-cache key -> GemmPlan
_REGISTRY: dict[str, GemmPlan] = {}

RESOLUTION_METRIC = "tune.plan_resolutions"
DISPATCH_METRIC = "dispatch.calls"

#: paths a KSplit linear may take
LINEAR_PATHS = ("ksplit_torch", "ksplit_cuda")


def _count_resolution(source: str, key: str | None = None) -> None:
    obs.metrics_registry().counter(RESOLUTION_METRIC, source=source).inc()
    if key is not None and obs.is_enabled():
        obs.event("plan.resolve", "plan", key=key, source=source)


def resolution_counters() -> dict[str, int]:
    """``{source: count}`` of plan resolutions since the last reset."""
    return {labels["source"]: int(c.value) for labels, c in
            obs.metrics_registry().series(RESOLUTION_METRIC)}


def reset_resolution_counters() -> None:
    """Reset ``tune.plan_resolutions`` in the metrics registry."""
    obs.metrics_registry().reset(RESOLUTION_METRIC)


def fresh_resolutions(counters: dict[str, int] | None = None) -> int:
    """Resolutions that did fresh work (cost-model ranking, or SUMMA's
    un-prefetched default), not a registry or cache hit."""
    c = resolution_counters() if counters is None else counters
    return int(sum(v for k, v in c.items()
                   if k.split("summa_")[-1] in ("model", "default")))


def dispatch_counts(op: str | None = None) -> dict[str, int]:
    """``{path: calls}`` of the dispatch counter (optionally one op)."""
    out: dict[str, int] = {}
    for labels, c in obs.metrics_registry().series(DISPATCH_METRIC):
        if op is None or labels["op"] == op:
            out[labels["path"]] = out.get(labels["path"], 0) + int(c.value)
    return out


def clear_registry() -> None:
    _REGISTRY.clear()


def register_plan(key: str, plan: GemmPlan) -> None:
    _REGISTRY[key] = plan


def warm_registry(cache: S.PlanCache | None = None) -> int:
    """Load every persisted plan into the registry; returns the count."""
    cache = cache if cache is not None else S.default_cache()
    keys = cache.keys()
    for key in keys:
        _REGISTRY[key] = cache.get(key)
    return len(keys)


# ---------------------------------------------------------------------------
# Problem construction
# ---------------------------------------------------------------------------

def canonical_operands(a: MPMatrix, b: MPMatrix, c: MPMatrix | None
                       ) -> tuple[MPMatrix, MPMatrix, MPMatrix]:
    """Default C (when omitted) is a zero matrix with a uniform-LOW map."""
    if not isinstance(a, MPMatrix) or not isinstance(b, MPMatrix):
        raise TypeError("mp_matmul operands must be MPMatrix")
    if a.tile != b.tile:
        raise ValueError(f"tile mismatch {a.tile} vs {b.tile}")
    if a.fset != b.fset or (c is not None and c.fset != a.fset):
        raise ValueError("mp_matmul operands must share a format set")
    if a.cls.shape[1] != b.cls.shape[0]:
        raise ValueError(
            f"inner tile-grid mismatch {a.cls.shape} · {b.cls.shape}")
    if c is not None:
        if c.tile != a.tile:
            raise ValueError(f"C tile {c.tile} != A/B tile {a.tile}")
        if c.cls.shape != (a.cls.shape[0], b.cls.shape[1]):
            raise ValueError(
                f"C tile grid {c.cls.shape} incompatible with "
                f"{a.cls.shape} · {b.cls.shape}")
    if c is None:
        cmap = np.full((a.cls.shape[0], b.cls.shape[1]), a.fset.low, np.int8)
        c = MPMatrix.from_dense(
            torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                        device=a.device), cmap, a.tile, a.fset)
    return a, b, c


def problem_of(a: MPMatrix, b: MPMatrix, c: MPMatrix, *,
               alpha: float = 1.0, beta: float = 0.0) -> GemmProblem:
    pad_free = (a.shape == a.padded_shape and b.shape == b.padded_shape
                and c.shape == c.padded_shape)
    return GemmProblem.from_maps(a.cls, b.cls, c.cls, a.tile, alpha=alpha,
                                 beta=beta, pad_free=pad_free, fset=a.fset)


# ---------------------------------------------------------------------------
# Path executors
# ---------------------------------------------------------------------------

def _exec_ref(a, b, c, alpha, beta):
    return mp_gemm_ref(a, b, c, alpha=alpha, beta=beta)


def _exec_tile(a, b, c, alpha, beta):
    return ops.mp_gemm(a, b, c, alpha=alpha, beta=beta)


def _exec_split(a, b, c, alpha, beta):
    return ops.split_mp_gemm(a, b, c, alpha=alpha, beta=beta)


def _exec_grouped(a, b, c, alpha, beta):
    t = a.tile
    ac = CompactMPMatrix.from_dense(a.to_dense(), a.cls, t, a.fset)
    bc = CompactMPMatrix.from_dense(b.to_dense(), b.cls, t, b.fset)
    out = ops.grouped_mp_gemm(ac, bc, c.cls)
    dense = out.to_dense()[: c.shape[0], : c.shape[1]]
    return MPMatrix.from_dense(dense, c.cls, t, c.fset)


def _ksplit_weight(b: MPMatrix) -> KSplitWeight:
    return KSplitWeight.from_dense(b.to_dense(), b.cls[:, 0], b.tile, b.fset)


def _finish_c(y, c: MPMatrix, alpha, beta):
    out = alpha * y
    if beta != 0.0:
        out = out + beta * c.to_dense()
    return MPMatrix.from_dense(out, c.cls, c.tile, c.fset)


def _exec_ksplit_torch(a, b, c, alpha, beta):
    return _finish_c(ksplit_matmul(a.to_dense(), _ksplit_weight(b)), c,
                     alpha, beta)


def _exec_ksplit_cuda(a, b, c, alpha, beta):
    w = _ksplit_weight(b)
    x = a.to_dense()
    # the kernel consumes x with class-contiguous K columns (storage order)
    idx = np.concatenate(KSplitWeight.k_partition(w.k_cls, w.tile, w.fset))
    xp = x.index_select(1, torch.from_numpy(idx).to(x.device)).contiguous()
    return _finish_c(ops.ksplit_matmul_kernel(xp, w), c, alpha, beta)


_EXECUTORS = {
    "ref": _exec_ref,
    "tile": _exec_tile,
    "ksplit_torch": _exec_ksplit_torch,
    "ksplit_cuda": _exec_ksplit_cuda,
    "grouped": _exec_grouped,
    "split": _exec_split,
}
assert set(_EXECUTORS) == set(PATHS)


def execute_plan(plan: GemmPlan, a: MPMatrix, b: MPMatrix, c: MPMatrix,
                 *, alpha: float = 1.0, beta: float = 0.0) -> MPMatrix:
    return _EXECUTORS[plan.path](a, b, c, alpha, beta)


# ---------------------------------------------------------------------------
# Plan resolution + public entry point
# ---------------------------------------------------------------------------

def _lookup_plan(prob: GemmProblem, dev: DeviceSpec
                 ) -> tuple[GemmPlan, str] | None:
    """Registry → persisted cache; a stored plan is served only while it
    is still valid for this problem on this device."""
    key = S.plan_key(dev, prob)
    plan = _REGISTRY.get(key)
    if plan is not None and not validate_plan(plan, prob, dev):
        return plan, "registry"
    plan = S.default_cache().get(key)
    if plan is not None and not validate_plan(plan, prob, dev):
        _REGISTRY[key] = plan
        return plan, "cache"
    return None


def resolve_plan(prob: GemmProblem, dev: DeviceSpec | None = None,
                 paths: Iterable[str] = PATHS) -> tuple[GemmPlan, str]:
    """registry > persisted cache > cost-model best; returns (plan,
    source).  Never measures."""
    dev = dev or detect_device()
    key = S.plan_key(dev, prob)
    hit = _lookup_plan(prob, dev)
    if hit is not None:
        _count_resolution(hit[1], key)
        return hit
    ranked = S.rank_plans(S.candidate_plans(prob, dev, paths), prob, dev)
    if not ranked:
        raise ValueError(f"no valid plan for {key}")
    plan = ranked[0][0]
    _REGISTRY[key] = plan
    _count_resolution("model", key)
    return plan, "model"


def mp_matmul(a: MPMatrix, b: MPMatrix, c: MPMatrix | None = None, *,
              alpha: float = 1.0, beta: float = 0.0,
              plan: GemmPlan | None = None) -> MPMatrix:
    """C ← α·A·B + β·C routed through the best known execution path."""
    a, b, c = canonical_operands(a, b, c)
    prob = problem_of(a, b, c, alpha=alpha, beta=beta)
    dev = detect_device(a.device)
    if plan is None:
        plan, _ = resolve_plan(prob, dev)
    else:
        bad = validate_plan(plan, prob, dev)
        if bad:
            raise ValueError(f"plan {plan.key()} invalid: {bad}")
    obs.metrics_registry().counter(
        DISPATCH_METRIC, path=plan.path, op=prob.op,
        formats=prob.formats).inc()
    if obs.is_enabled():
        with obs.span("gemm.dispatch", "gemm", path=plan.path,
                      m=prob.m, n=prob.n, k=prob.k, op=prob.op,
                      formats=prob.formats):
            return execute_plan(plan, a, b, c, alpha=alpha, beta=beta)
    return execute_plan(plan, a, b, c, alpha=alpha, beta=beta)


# ---------------------------------------------------------------------------
# MPLinear integration (op = "linear")
# ---------------------------------------------------------------------------

def linear_problem(w: KSplitWeight, m: int) -> GemmProblem:
    bh, b8 = w.role_fractions
    k, n = w.shape
    return GemmProblem(
        m=int(m), n=n, k=k, tile=w.tile, op="linear",
        a_high=0.0, a_low8=0.0, b_high=bh, b_low8=b8,
        c_high=0.0, c_low8=0.0, b_k_constant=True,
        c_classes=(w.fset.low,),
        alpha_one=True, beta_zero=True, pad_free=True,
        formats=w.fset.key())


def _linear_forward(path: str, x: torch.Tensor, w: KSplitWeight
                    ) -> torch.Tensor:
    if path == "ksplit_cuda":
        m = x.numel() // x.shape[-1]
        y = ops.ksplit_matmul_kernel(x.reshape(m, x.shape[-1]).contiguous(),
                                     w)
        return y.reshape(*x.shape[:-1], w.shape[1])
    return ksplit_matmul(x, w)


class _KSplitLinear(torch.autograd.Function):
    """A KSplit linear under autograd, as the reference's
    ``_kernel_linear``: the forward runs the dispatched path (the ksplit
    kernel on the card), the backward is the VJP of the gathering path
    (``core.layout.ksplit_matmul_vjp``: plain fp32 matmuls, no kernel);
    each buffer's gradient comes back in that buffer's dtype."""

    @staticmethod
    def forward(ctx, x, w, path, *bufs):
        ctx.save_for_backward(x, *bufs)
        ctx.w = w
        return _linear_forward(path, x, w)

    @staticmethod
    def backward(ctx, g):
        x, *bufs = ctx.saved_tensors
        w = dataclasses.replace(ctx.w, bufs=tuple(bufs))
        dx, dbufs = ksplit_matmul_vjp(x, w, g)
        return (dx if ctx.needs_input_grad[0] else None, None, None,
                *(d if need else None
                  for d, need in zip(dbufs, ctx.needs_input_grad[3:])))


def linear_matmul(x: torch.Tensor, w: KSplitWeight) -> torch.Tensor:
    """MPLinear's matmul, path taken from the plan registry.

    A registry hit costs a dict lookup; a miss resolves through the cache
    or the cost model and is counted (``tune_linear_params`` at setup
    makes serving hit the registry, so serving adds no resolutions).
    The kernel path needs x's K columns class-contiguous, which holds iff
    the K-class vector is sorted by descending code (ratio policies);
    other maps take the gathering plain path.  Where autograd records
    (x or a buffer requires a gradient), the call is differentiable
    through :class:`_KSplitLinear`."""
    m = 1
    for d in x.shape[:-1]:
        m *= int(d)
    dev = detect_device(x.device)
    prob = linear_problem(w, m)
    plan = _REGISTRY.get(S.plan_key(dev, prob))
    if plan is None:
        plan, _ = resolve_plan(prob, dev, LINEAR_PATHS)
    path = plan.path if (plan.path != "ksplit_cuda" or w.sorted) \
        else "ksplit_torch"
    obs.metrics_registry().counter(DISPATCH_METRIC, path=path, op="linear",
                                   formats=w.fset.key()).inc()
    if torch.is_grad_enabled() and (
            x.requires_grad or any(b.requires_grad for b in w.bufs)):
        return _KSplitLinear.apply(x, w, path, *w.bufs)
    return _linear_forward(path, x, w)


def tune_linear_params(params, m_hint: int, *, measure: bool = False,
                       cache: S.PlanCache | None = None, warmup: int = 1,
                       iters: int = 3) -> dict[str, GemmPlan]:
    """Tune-once-at-setup: a plan for every distinct KSplitWeight
    signature in a parameter tree (dicts / lists / MPLinear leaves) at
    ``m_hint`` rows, loaded into the registry.

    ``measure=False`` (the default) is model selection and cache lookup
    only.  ``measure=True`` (outside cache-only mode) times both linear
    paths on zero activations ``[m_hint, K]`` (bf16) on the weight's
    device — the path a call of that weight would execute, so an
    unsorted map times the gathering path under either plan — and
    persists the winner to ``cache`` (default: the process cache)."""
    from repro_torch.core.linear import MPLinear
    plans: dict[str, GemmPlan] = {}

    def tune(w: KSplitWeight) -> None:
        dev = detect_device(w.bufs[0].device)
        prob = linear_problem(w, m_hint)
        key = S.plan_key(dev, prob)
        if key in plans:
            return
        if not measure or S.cache_only():
            plan = resolve_plan(prob, dev, LINEAR_PATHS)[0]
        else:
            x = torch.zeros((m_hint, w.shape[0]), dtype=torch.bfloat16,
                            device=w.bufs[0].device)

            def run(p: GemmPlan, x=x, w=w) -> torch.Tensor:
                path = p.path if (p.path != "ksplit_cuda" or w.sorted) \
                    else "ksplit_torch"
                return _linear_forward(path, x, w)

            plan, _ = S.autotune_problem(
                prob, run, dev=dev, paths=LINEAR_PATHS, cache=cache,
                warmup=warmup, iters=iters)
            _REGISTRY[key] = plan
        plans[key] = plan

    def visit(node):
        if isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)
        elif isinstance(node, MPLinear) and isinstance(node.w, KSplitWeight):
            tune(node.w)

    visit(params)
    return plans


def resolve_plans_for_buckets(params_by_tag: dict, buckets
                              ) -> dict[tuple, dict[str, GemmPlan]]:
    """Plan prefetch for the serve scheduler's shape buckets.

    ``buckets`` is an iterable of ``(tag, batch, pad_len)``.  The engine
    prefills by stepping the decode function, so every linear of a bucket
    runs at ``m = batch``; ``m = 1`` is resolved too, because on the card
    every sorted-map linear takes the ksplit kernel at every M — the
    kernel's M-independent summation order is what keeps a row's tokens
    the same served alone or batched.  Returns ``{(tag, m): {key:
    plan}}``; every plan is also loaded into the registry."""
    out: dict[tuple, dict[str, GemmPlan]] = {}
    for tag, batch, _pad_len in buckets:
        if tag not in params_by_tag:
            raise KeyError(f"unknown weight-variant tag {tag!r} "
                           f"(have {sorted(params_by_tag)})")
        for m in sorted({1, int(batch)}):
            if (tag, m) not in out:
                out[(tag, m)] = tune_linear_params(params_by_tag[tag],
                                                   m_hint=m)
    return out


# ---------------------------------------------------------------------------
# Distributed SUMMA integration (op = "summa{P}x{Q}")
# ---------------------------------------------------------------------------

#: local-update paths of the distributed SUMMA rank-update
SUMMA_PATHS = ("ref", "grouped")


def summa_problem_from_maps(pa, pb, pc, tile: int, P: int, Q: int,
                            fset=None, *, alpha: float = 1.0,
                            beta: float = 0.0,
                            pad_free: bool = True) -> GemmProblem:
    """Distributed plan-key problem from raw class maps.

    The key carries the grid's shape (in the op tag), the *per-shard* M/N
    extents (tile counts × tile), the full K, and the format-set tag, so a
    plan tuned for one grid/shape/format combination is never served to
    another.  A ``!ub`` op suffix marks C maps that are not shard-balanced
    (the grouped local path is invalid for those)."""
    from repro_torch.core import schedule
    from repro_torch.core.formats import DEFAULT_FORMATS
    fset = fset or DEFAULT_FORMATS
    prob = GemmProblem.from_maps(pa, pb, pc, tile, alpha=alpha, beta=beta,
                                 pad_free=pad_free, fset=fset)
    balanced = schedule.is_shard_balanced(pc, P, Q, fset)
    op = f"summa{P}x{Q}" + ("" if balanced else "!ub")
    return dataclasses.replace(prob, op=op, m=prob.m // P, n=prob.n // Q)


def summa_problem(a: MPMatrix, b: MPMatrix, c: MPMatrix, grid, *,
                  alpha: float = 1.0, beta: float = 0.0) -> GemmProblem:
    """Distributed plan-key problem for a SUMMA GEMM on ``grid`` (a
    :class:`~repro_torch.launch.grid.Grid` or a ``(P, Q)`` pair; see
    :func:`summa_problem_from_maps` for the key anatomy)."""
    P, Q = getattr(grid, "shape", grid)
    base = problem_of(a, b, c, alpha=alpha, beta=beta)
    return summa_problem_from_maps(
        a.cls, b.cls, c.cls, a.tile, int(P), int(Q), a.fset,
        alpha=alpha, beta=beta, pad_free=base.pad_free)


def resolve_summa_plan(prob: GemmProblem, dev: DeviceSpec | None = None
                       ) -> tuple[GemmPlan, str]:
    """registry > persisted cache > reference path.

    Unlike single-device resolution there is no cost-model fallback: the
    grouped local update runs only when a plan exists for this (grid,
    per-shard shape, format set) key; otherwise the reference
    one-dot-per-C-class update is used."""
    dev = dev or detect_device()
    key = S.plan_key(dev, prob)
    hit = _lookup_plan(prob, dev)
    if hit is not None:
        _count_resolution("summa_" + hit[1], key)
        return hit
    t = prob.tile
    _count_resolution("summa_default", key)
    return GemmPlan(path="ref", bm=t, bn=t, bk=t), "default"


def summa_mp_matmul(a: MPMatrix, b: MPMatrix, c: MPMatrix | None = None, *,
                    grid, alpha: float = 1.0, beta: float = 0.0,
                    plan: GemmPlan | None = None) -> MPMatrix:
    """Distributed twin of :func:`mp_matmul`: C ← α·A·B + β·C over
    ``grid`` with the local rank-update routed through the plan
    registry/cache."""
    from repro_torch.core.summa import summa_mp_gemm
    return summa_mp_gemm(a, b, c, grid=grid, alpha=alpha, beta=beta,
                         plan=plan)


def autotune_summa(a: MPMatrix, b: MPMatrix, c: MPMatrix | None = None, *,
                   grid, alpha: float = 1.0, beta: float = 0.0,
                   **kw) -> GemmPlan:
    """Measure SUMMA's local-update candidates (``SUMMA_PATHS``) on
    ``grid`` and persist the winner under the distributed plan key.
    Collective: every rank calls it with the same operands, in the same
    order.  Each candidate's time is the slowest rank's (gathered after
    every measurement), so every rank ranks the same numbers and
    persists the same plan."""
    from repro_torch.core.summa import summa_mp_gemm
    a, b, c = canonical_operands(a, b, c)
    prob = summa_problem(a, b, c, grid, alpha=alpha, beta=beta)
    kw.setdefault("dev", detect_device(a.device))

    def run(p: GemmPlan):
        return summa_mp_gemm(a, b, c, grid=grid, alpha=alpha, beta=beta,
                             plan=p).bufs

    def slowest_rank(fn, **mkw) -> float:
        mine = torch.tensor([S.measure(fn, **mkw)], dtype=torch.float64,
                            device=grid.device)
        return max(float(v) for v in grid.all_gather(mine))

    plan, _ = S.autotune_problem(prob, run, paths=SUMMA_PATHS,
                                 timer=slowest_rank, **kw)
    return plan


# ---------------------------------------------------------------------------
# Refinement-solver integration (op = "solve")
# ---------------------------------------------------------------------------

#: GEMM paths valid for every map structure the solver can produce (ksplit
#: paths need a K-constant B map, which trailing updates never have);
#: ``split`` serves the compute-higher escalation mode
SOLVE_PATHS = ("ref", "tile", "grouped", "split")


def solve_gemm_problem(pa: np.ndarray, tile: int, nrhs_t: int,
                       fset) -> GemmProblem:
    """Plan-key problem of the refinement residual GEMM ``A·X``: A carries
    the map ``pa``; X and the output are uniform-HIGH ``[kt, nrhs_t]`` /
    ``[mt, nrhs_t]``.  Solver problems carry ``op="solve"``."""
    pa = np.asarray(pa)
    pb = np.full((pa.shape[1], nrhs_t), fset.high, np.int8)
    pc = np.full((pa.shape[0], pb.shape[1]), fset.high, np.int8)
    return dataclasses.replace(
        GemmProblem.from_maps(pa, pb, pc, tile, fset=fset), op="solve")


def resolve_solve_plans(a_maps, tile: int, fset, *, nrhs: int,
                        summa_grid: tuple[int, int] | None = None,
                        local_path: str = "ref",
                        paths: Iterable[str] = SOLVE_PATHS,
                        dev: DeviceSpec | None = None) -> dict:
    """Escalation-ladder plan prefetch for the refinement solver: for
    every rung of ``a_maps`` (rung 0 = the starting map) a plan for the
    residual GEMM ``A·X`` and for each blocked-LU trailing update, all
    loaded into the registry under ``op="solve"`` keys (cost model only,
    never measuring); with ``summa_grid`` the distributed residual GEMM
    is registered under its ``summa{P}x{Q}`` key with ``local_path``, so
    promotion never falls back to an un-prefetched plan.  Returns
    ``{("residual", rung): plan, ("trail", step, rung): plan, ("summa",
    rung): plan, "keys": [...]}``; a solve issues no fresh resolution
    after this call."""
    dev = dev or detect_device()
    if nrhs % tile:
        raise ValueError(f"nrhs={nrhs} must be a multiple of tile={tile}")
    rt = nrhs // tile
    book: dict = {}
    keys: list[str] = []
    for rung, pa in enumerate(a_maps):
        pa = np.asarray(pa)
        mt, kt = pa.shape
        prob = solve_gemm_problem(pa, tile, rt, fset)
        book[("residual", rung)] = resolve_plan(prob, dev, paths)[0]
        keys.append(S.plan_key(dev, prob))
        # blocked-LU trailing updates: step k multiplies L21 (map column k)
        # by U12 (map row k) into the [mt-k-1, kt-k-1] trailing block
        for k in range(min(mt, kt) - 1):
            pl = pa[k + 1:, k:k + 1]
            pu = pa[k:k + 1, k + 1:]
            tprob = dataclasses.replace(
                GemmProblem.from_maps(
                    pl, pu, np.full((pl.shape[0], pu.shape[1]), fset.high,
                                    np.int8), tile, fset=fset),
                op="solve")
            book[("trail", k, rung)] = resolve_plan(tprob, dev, paths)[0]
            keys.append(S.plan_key(dev, tprob))
        if summa_grid is not None:
            P, Q = summa_grid
            pb = np.full((kt, rt), fset.high, np.int8)
            pc = np.full((mt, rt), fset.high, np.int8)
            sprob = summa_problem_from_maps(pa, pb, pc, tile, P, Q, fset)
            splan = GemmPlan(path=local_path, bm=tile, bn=tile, bk=tile)
            bad = validate_plan(splan, sprob, dev)
            if bad:
                raise ValueError(
                    f"solver SUMMA local path {local_path!r} invalid for "
                    f"rung {rung}: {bad}")
            skey = S.plan_key(dev, sprob)
            register_plan(skey, splan)
            book[("summa", rung)] = splan
            keys.append(skey)
    book["keys"] = keys
    return book
