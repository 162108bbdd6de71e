"""Residual-driven adaptive-precision iterative refinement (twin of
``repro.solve.refine``).

The operator is an :class:`~repro_torch.core.layout.MPMatrix` whose
per-tile precision map adapts to the observed residual:

1. factor the quantized operator with blocked LU whose trailing updates
   run through ``tune.mp_matmul`` on the device (``repro_torch.solve.lu``;
   the panels and the trailing subtraction stay numpy fp32 on the host,
   as in the reference), or use Jacobi-CG for SPD systems;
2. refine: the residual GEMM ``A·X`` runs through the same dispatch
   stack at the tile map's precisions; corrections come from the factors;
3. after each sweep the fp64 HPL-MxP metric
   (``core.accuracy.hpl_mxp_metric``) decides convergence; on a stall,
   tiles whose storage-rounding contribution exceeds their budget
   (``core.accuracy.promotion_mask``) are promoted one role, the operator
   is re-quantized from the exact values, and refactored.

Every plan the solve can need is prefetched up front
(``tune.dispatch.resolve_solve_plans``), so promotion never resolves a
plan mid-solve; ``SolveReport.fresh_resolutions`` audits that.

Escalation: ``"tile"`` promotes exactly the over-budget tiles;
``"balanced"`` walks sorted-balanced ladder rungs.  Compute escalation:
``"store"`` keeps the storage ladder, ``"split"`` swaps the HIGH role for
a split compound format (every GEMM then runs the split kernel), ``"auto"``
takes whichever the cost model prices cheaper at the top rung.

With ``summa_grid=(P, Q)`` the residual GEMM runs as SUMMA
(``core.summa``) on a P×Q grid of ranks, under the prefetched
``summa{P}x{Q}`` plan keys, with ``local_path`` as its local update.
Every rank runs the same solver (SPMD): the host work (numpy
factorization, promotion decisions) is deterministic and replicated, only
the residual GEMM is distributed, and rank 0's report is returned.
``solve`` called outside a grid spawns the ranks itself
(``launch.grid.run_on_grid``).  A P×Q solve equals the 1×1-grid solve bit
for bit, and with ``local_path="grouped"`` it equals the single-device
grouped solve (``residual_path="grouped"``, ``balance_groups=P`` and the
same ``nrhs_pad``): the grouped kernel's accumulate-into form sums every
C tile in the single launch's order.

Trace events (``repro_torch.obs``, when enabled), as the reference's:
``solve.run`` around the solve, ``solve.factor`` around each
factorization, ``solve.sweep`` around each LU refinement sweep,
``solve.escalate`` per promotion (with the promoted tiles' coordinates,
at most ``PROMOTION_COORD_CAP``), ``solve.compute_decision`` and
``solve.sweep_metric``.  Spans are host time; the factor and sweep spans
end after their results are read to the host.  A distributed solve's
ranks all trace the same decisions: the parent's trace keeps rank 0's
(``launch.grid.run_on_grid``).  The port adds the device:
``solve(..., device=None)`` runs on ``cuda`` unless the caller passes
``device="cpu"``, and reports the seconds the trailing updates spend
copying panels to the device and products back.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import accuracy as ACC
from repro_torch.core.formats import DEFAULT_FORMATS, FormatSet
from repro_torch.core.layout import MPMatrix
from repro_torch.core import summa as SU
from repro_torch.core.precision import (Policy, make_map, map_ratio_string,
                                        map_storage_bytes, role_class_vector)
from repro_torch.solve import lu as LU
from repro_torch.split.recovery import split_variant
from repro_torch.tune import dispatch as TD
from repro_torch.tune import search as TS
from repro_torch.tune.costmodel import GemmPlan
from repro_torch.tune.device import detect_device

#: escalation-ladder rungs prefetched for the data-driven ("tile") mode
LADDER_RUNGS = 5

#: most promoted-tile coordinates kept per escalation record
PROMOTION_COORD_CAP = 128


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Knobs of one adaptive-precision solve (see the reference for the
    meaning of each).  ``warm`` builds SUMMA's static tables for every
    rung of the ladder before the solve (the reference pre-traces them),
    so promotion builds none mid-solve."""

    tile: int = 16
    fset: FormatSet = DEFAULT_FORMATS
    ratio_high: float = 0.0
    ratio_low8: float = 0.0
    seed: int = 0
    tol: float = 1.0
    max_sweeps: int = 60
    max_escalations: int = 32
    budget_margin: float = 0.25
    stall_ratio: float = 0.5
    method: str = "lu"             # "lu" | "cg"
    start_policy: str = "norm_topk"
    cg_check_every: int = 8
    escalation: str = "tile"       # "tile" | "balanced"
    compute_escalation: str = "store"  # "store" | "split" | "auto"
    split_format: str = "split2_fp16"
    balance_groups: int | None = None
    nrhs_pad: int | None = None
    summa_grid: tuple[int, int] | None = None
    local_path: str = "ref"        # SUMMA local-update path (ref | grouped)
    residual_path: str | None = None   # force the residual GEMM's path
    warm: bool = True              # build the SUMMA tables of every rung


@dataclasses.dataclass
class SolveReport:
    converged: bool
    method: str
    sweeps: int
    escalations: int
    factorizations: int
    metric: float
    metric_history: list
    ratio_history: list
    final_ratio: str
    final_map: np.ndarray
    storage_bytes: int
    uniform_high_bytes: int
    gemm_seconds: float
    total_seconds: float
    gemm_fraction: float
    fresh_resolutions: int
    plan_keys: int
    x: np.ndarray
    sweep_seconds: list = dataclasses.field(default_factory=list)
    promotions: list = dataclasses.field(default_factory=list)
    compute_mode: str = "store"
    store_cost_s: float = float("nan")
    split_cost_s: float = float("nan")
    #: wall seconds of all factorizations (panels, trailing GEMMs, copies
    #: and the host-side trailing subtraction)
    factor_seconds: float = 0.0
    #: of which the trailing updates' panel uploads and product downloads
    trail_copy_seconds: float = 0.0
    #: builds of SUMMA's static tables (slot tables, per-shard C maps,
    #: owner steps) during the solve, after the warm pass: the counterpart
    #: of the reference's jit cache misses, 0 when the ladder was warmed
    summa_recompiles: int = 0
    #: host seconds this rank spent in SUMMA's panel broadcasts, and their
    #: bytes (0 without a grid)
    broadcast_seconds: float = 0.0
    broadcast_bytes: int = 0


def _balanced_map(mt: int, nt: int, n_hi: int, n_lo8: int, groups: int,
                  fset: FormatSet) -> np.ndarray:
    """Sorted-balanced ladder map: every shard segment of every
    tile-column holds ``n_hi`` HIGH / ``n_lo8`` LOW8 tiles, classes sorted
    by descending storage cost."""
    seg = mt // groups
    col = role_class_vector(n_hi, seg - n_hi - n_lo8, n_lo8, fset)
    return np.tile(np.tile(col, groups)[:, None], (1, nt))


def _groups(cfg: SolveConfig) -> int:
    if cfg.balance_groups is not None:
        return cfg.balance_groups
    return cfg.summa_grid[0] if cfg.summa_grid else 1


def _rhs_width(cfg: SolveConfig, nrhs_logical: int) -> int:
    """The padded RHS width: a multiple of the tile (and of SUMMA's
    column quantum tile·Q), or ``nrhs_pad``."""
    quantum = cfg.tile * (cfg.summa_grid[1] if cfg.summa_grid else 1)
    nrhs = -(-nrhs_logical // quantum) * quantum
    if cfg.nrhs_pad is not None:
        if cfg.nrhs_pad < nrhs or cfg.nrhs_pad % quantum:
            raise ValueError(
                f"nrhs_pad={cfg.nrhs_pad} must be a multiple of {quantum} "
                f"covering the {nrhs_logical} RHS columns")
        nrhs = cfg.nrhs_pad
    return nrhs


def _check_grid(cfg: SolveConfig, n: int, nrhs: int) -> None:
    """The reference's checks of a distributed solve's configuration."""
    P, Q = cfg.summa_grid
    t = cfg.tile
    if cfg.escalation != "balanced":
        raise ValueError(
            "summa_grid needs escalation='balanced' (SUMMA requires "
            "sorted-balanced maps; per-tile promotion breaks them)")
    if cfg.compute_escalation != "store":
        raise ValueError(
            "compute_escalation needs a single-device solve (the SUMMA "
            "local paths do not run split compound formats)")
    if n % (P * t) or nrhs % (Q * t) or (n // t) % P or (n // t) % Q:
        raise ValueError(
            f"N={n}, nrhs={nrhs} incompatible with the {P}x{Q} grid "
            f"at tile {t} (need N % (P·t) == nrhs % (Q·t) == 0 and "
            f"K-panels divisible by both grid extents)")


def _ladder(cfg: SolveConfig, mt: int, nt: int,
            weights: np.ndarray | None = None) -> list[np.ndarray]:
    """Every A-map the escalation can visit (rung 0 = the starting map)."""
    if cfg.escalation == "balanced":
        groups = _groups(cfg)
        if mt % groups:
            raise ValueError(
                f"balance_groups={groups} must divide the tile-row count "
                f"{mt} (N/tile) for sorted-balanced ladder maps")
        seg = mt // groups
        h0 = int(round(cfg.ratio_high * seg))
        q0 = int(round(cfg.ratio_low8 * seg))
        return [_balanced_map(mt, nt, h, min(q0, seg - h), groups, cfg.fset)
                for h in range(h0, seg + 1)]
    f0 = cfg.ratio_high
    maps = []
    for r in range(LADDER_RUNGS):
        fh = f0 + (1.0 - f0) * r / (LADDER_RUNGS - 1)
        fq = min(cfg.ratio_low8, 1.0 - fh)
        kind = cfg.start_policy if r == 0 else "ratio"
        pol = Policy(kind=kind, ratio_high=fh, ratio_low8=fq, seed=cfg.seed)
        maps.append(make_map((mt * cfg.tile, nt * cfg.tile), cfg.tile, pol,
                             weights=weights if kind == "norm_topk" else None,
                             fset=cfg.fset))
    return maps


def _tile_rung(cfg: SolveConfig, frac_high: float) -> int:
    """Nearest prefetched ladder rung for a data-driven map's D fraction."""
    f0 = cfg.ratio_high
    if f0 >= 1.0:
        return LADDER_RUNGS - 1
    r = (frac_high - f0) / (1.0 - f0) * (LADDER_RUNGS - 1)
    return int(np.clip(round(r), 0, LADDER_RUNGS - 1))


def _rung_cost_s(fset: FormatSet, mt: int, rt: int, tile: int,
                 dev) -> float:
    """Cost-model price of the top-rung (uniform HIGH) residual GEMM under
    ``fset`` (model only: no registry writes, no resolution counts)."""
    hi = np.full((mt, mt), fset.high, np.int8)
    prob = TD.solve_gemm_problem(hi, tile, rt, fset)
    cands = TS.candidate_plans(prob, dev, TD.SOLVE_PATHS)
    if not cands:
        return float("inf")
    return float(TS.rank_plans(cands, prob, dev)[0][1]["total_s"])


def _decide_compute(cfg: SolveConfig, mt: int, rt: int, dev
                    ) -> tuple[SolveConfig, str, float, float]:
    """Keep the storage ladder or substitute the split compound format for
    HIGH (``"auto"``: whichever the cost model prices cheaper)."""
    if cfg.compute_escalation not in ("store", "split", "auto"):
        raise ValueError(
            f"unknown compute_escalation {cfg.compute_escalation!r} "
            "(store | split | auto)")
    if cfg.compute_escalation == "store":
        return cfg, "store", float("nan"), float("nan")
    split_fset = split_variant(cfg.fset, cfg.split_format)
    store_s = _rung_cost_s(cfg.fset, mt, rt, cfg.tile, dev)
    split_s = _rung_cost_s(split_fset, mt, rt, cfg.tile, dev)
    mode = ("split" if cfg.compute_escalation == "split"
            or split_s < store_s else "store")
    if mode == "split":
        cfg = dataclasses.replace(cfg, fset=split_fset)
    if obs.is_enabled():
        obs.event("solve.compute_decision", "solve", mode=mode,
                  policy=cfg.compute_escalation, store_s=store_s,
                  split_s=split_s)
    return cfg, mode, store_s, split_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Solver:
    """State shared by the LU and CG drivers."""

    def __init__(self, a, b, cfg: SolveConfig, device: torch.device,
                 grid=None):
        t = cfg.tile
        self.device = device
        self.dev_spec = detect_device(device)
        self.a64 = np.asarray(a, np.float64)
        n = self.a64.shape[0]
        if self.a64.shape != (n, n) or n % t:
            raise ValueError(f"operator must be square with N % tile == 0, "
                             f"got {self.a64.shape} tile {t}")
        b2 = np.asarray(b, np.float64).reshape(n, -1)
        self.nrhs_logical = b2.shape[1]
        nrhs = _rhs_width(cfg, self.nrhs_logical)
        self.b64 = np.zeros((n, nrhs))
        self.b64[:, : self.nrhs_logical] = b2
        self.n, self.nrhs = n, nrhs
        self.mt, self.rt = n // t, nrhs // t

        # compute-higher escalation decides the format set before any
        # layout, ladder or plan exists
        if cfg.summa_grid is not None:
            _check_grid(cfg, n, nrhs)
        cfg, self.compute_mode, self.store_cost_s, self.split_cost_s = (
            _decide_compute(cfg, self.mt, self.rt, self.dev_spec))
        self.cfg = cfg
        if cfg.summa_grid is not None:
            if grid is None or grid.shape != tuple(cfg.summa_grid):
                raise ValueError(
                    f"summa_grid={cfg.summa_grid} runs on a grid of that "
                    f"shape, got {grid and grid.shape}")
        self.grid = grid if cfg.summa_grid is not None else None

        self.a32 = torch.from_numpy(self.a64.astype(np.float32)).to(device)
        self.ladder = _ladder(cfg, self.mt, self.mt, weights=self.a64)
        self.pa = self.ladder[0].copy()
        self.rung = 0
        self.A = MPMatrix.from_dense(self.a32, self.pa, t, cfg.fset)
        self.x_map = np.full((self.mt, self.rt), cfg.fset.high, np.int8)
        self.zero_c = MPMatrix.from_dense(
            torch.zeros((n, nrhs), device=device), self.x_map, t, cfg.fset)
        self.gemm_seconds = 0.0
        self.factor_seconds = 0.0
        self.trail_copy_seconds = 0.0
        self.escalations = 0
        self.factorizations = 0
        self.ratio_history: list[str] = []
        self.sweep_seconds: list[float] = []
        self.promotions: list[dict] = []
        self.book = TD.resolve_solve_plans(
            self.ladder, t, cfg.fset, nrhs=nrhs, summa_grid=cfg.summa_grid,
            local_path=cfg.local_path, dev=self.dev_spec)
        if self.grid is not None and cfg.warm:
            # every rung's tables now, so promotion builds none mid-solve
            for pa in self.ladder:
                SU.prepare(pa, self.x_map, self.x_map, tile=t, fset=cfg.fset,
                           grid=self.grid, local_path=cfg.local_path)
        if self.grid is not None:
            self.grid.reset_counters()
        self.recompiles0 = SU.table_builds()
        # a snapshot, not a reset: the report counts this solve's delta
        self._fresh0 = TD.fresh_resolutions()

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device)

    # -- GEMMs through the dispatch stack ---------------------------------
    def amul(self, x32: np.ndarray) -> np.ndarray:
        """A·X at the tile map's precisions (the refinement inner GEMM)."""
        t0 = time.perf_counter()
        cfg = self.cfg
        x_mp = MPMatrix.from_dense(self._to_device(x32), self.x_map,
                                   cfg.tile, cfg.fset)
        if self.grid is not None:
            out = SU.summa_mp_gemm(self.A, x_mp, self.zero_c,
                                   grid=self.grid)
            res = out.to_dense().cpu().numpy()
            self.gemm_seconds += time.perf_counter() - t0
            return res
        if cfg.residual_path is not None:
            plan = GemmPlan(path=cfg.residual_path, bm=cfg.tile,
                            bn=cfg.tile, bk=cfg.tile)
        else:
            plan = self.book[("residual", self._book_rung())]
        out = TD.mp_matmul(self.A, x_mp, self.zero_c, plan=plan)
        res = out.to_dense().cpu().numpy()
        self.gemm_seconds += time.perf_counter() - t0
        return res

    def _book_rung(self) -> int:
        if self.cfg.escalation == "balanced":
            return self.rung
        return _tile_rung(self.cfg,
                          float((self.pa == self.cfg.fset.high).mean()))

    def factor(self) -> np.ndarray:
        """Blocked LU of the current quantized operator; trailing updates
        via mp_matmul under the prefetched per-step plans."""
        cfg, t = self.cfg, self.cfg.tile
        rung = self._book_rung()
        tf = time.perf_counter()
        a_stored = self.A.to_dense().cpu().numpy()

        def trailing(l21, u12, step):
            t0 = time.perf_counter()
            pl = self.pa[step + 1:, step:step + 1]
            pu = self.pa[step:step + 1, step + 1:]
            l_dev, u_dev = self._to_device(l21), self._to_device(u12)
            t1 = time.perf_counter()
            lmp = MPMatrix.from_dense(l_dev, pl, t, cfg.fset)
            ump = MPMatrix.from_dense(u_dev, pu, t, cfg.fset)
            cmp_ = MPMatrix.from_dense(
                torch.zeros((l21.shape[0], u12.shape[1]),
                            device=self.device),
                np.full((pl.shape[0], pu.shape[1]), cfg.fset.high, np.int8),
                t, cfg.fset)
            out = TD.mp_matmul(lmp, ump, cmp_,
                               plan=self.book[("trail", step, rung)])
            dense = out.to_dense()
            _sync(self.device)
            t2 = time.perf_counter()
            prod = dense.cpu().numpy()
            t3 = time.perf_counter()
            self.trail_copy_seconds += (t1 - t0) + (t3 - t2)
            self.gemm_seconds += t3 - t0
            return prod

        with obs.span("solve.factor", "solve", rung=rung,
                      factorization=self.factorizations + 1):
            lu_, _stats = LU.blocked_lu(a_stored, self.pa, t, trailing)
        self.factorizations += 1
        self.factor_seconds += time.perf_counter() - tf
        return lu_

    # -- escalation ---------------------------------------------------------
    def escalate(self, x: np.ndarray) -> bool:
        """Promote over-budget tiles one role and re-quantize the operator
        from the exact values.  Returns False when there is nothing left
        to promote."""
        cfg, fset = self.cfg, self.cfg.fset
        old_pa = self.pa
        xa = x if np.all(np.isfinite(x)) else np.ones_like(x)
        slack = cfg.tol * cfg.budget_margin * self.n
        a_stored = self.A.to_dense().cpu().numpy()
        mask = ACC.promotion_mask(self.a64, a_stored, xa, self.pa, cfg.tile,
                                  fset, slack)
        if cfg.escalation == "balanced":
            groups = _groups(cfg)
            seg = self.mt // groups
            per_seg = mask.reshape(groups, seg, self.mt).sum(axis=1)
            step = max(1, int(per_seg.max()))
            if self.rung >= len(self.ladder) - 1:
                return False
            self.rung = min(self.rung + step, len(self.ladder) - 1)
            self.pa = self.ladder[self.rung].copy()
        else:
            if not mask.any():
                # nothing exceeds its budget but refinement stalled:
                # promote the worst decile by contribution/budget ratio
                contrib = ACC.tile_rounding_contribution(
                    self.a64, a_stored, xa, cfg.tile)
                budget = ACC.escalation_threshold(
                    self.a64, xa, cfg.tile, fset, slack)
                ratio = np.where(self.pa < fset.high,
                                 contrib / np.maximum(budget, 1e-300), -1.0)
                k = max(1, int(0.1 * ratio.size))
                idx = np.argsort(ratio, axis=None)[::-1][:k]
                mask = np.zeros_like(self.pa, bool)
                mask.flat[idx] = True
                mask &= self.pa < fset.high
            if not mask.any():
                return False
            self.pa = self.pa + mask.astype(np.int8)
        self.A = self.A.requantize(self.pa, dense=self.a32)
        self.escalations += 1
        ratio = map_ratio_string(self.pa, fset)
        self.ratio_history.append(ratio)
        changed = np.argwhere(self.pa != old_pa)
        record = {
            "escalation": self.escalations,
            "mode": cfg.escalation,
            "rung": self._book_rung(),
            "tiles": int(len(changed)),
            "coords": [[int(i), int(j)]
                       for i, j in changed[:PROMOTION_COORD_CAP]],
            "ratio": ratio,
        }
        self.promotions.append(record)
        if obs.is_enabled():
            obs.event("solve.escalate", "solve", **record)
        return True

    def metric(self, x: np.ndarray) -> float:
        return ACC.hpl_mxp_metric(self.a64, x, self.b64, self.cfg.fset)

    def report(self, x, converged, sweeps, history, t0) -> SolveReport:
        cfg = self.cfg
        uniform = np.full_like(self.pa, cfg.fset.high)
        total = time.perf_counter() - t0
        return SolveReport(
            converged=bool(converged), method=cfg.method, sweeps=sweeps,
            escalations=self.escalations,
            factorizations=self.factorizations,
            metric=float(history[-1]) if history else float("inf"),
            metric_history=[float(v) for v in history],
            ratio_history=list(self.ratio_history),
            final_ratio=map_ratio_string(self.pa, cfg.fset),
            final_map=self.pa.copy(),
            storage_bytes=map_storage_bytes(self.pa, cfg.tile, cfg.fset),
            uniform_high_bytes=map_storage_bytes(uniform, cfg.tile,
                                                 cfg.fset),
            gemm_seconds=self.gemm_seconds, total_seconds=total,
            gemm_fraction=self.gemm_seconds / max(total, 1e-12),
            fresh_resolutions=TD.fresh_resolutions() - self._fresh0,
            plan_keys=len(self.book["keys"]),
            x=x[:, : self.nrhs_logical],
            sweep_seconds=[float(v) for v in self.sweep_seconds],
            promotions=list(self.promotions),
            compute_mode=self.compute_mode,
            store_cost_s=float(self.store_cost_s),
            split_cost_s=float(self.split_cost_s),
            factor_seconds=self.factor_seconds,
            trail_copy_seconds=self.trail_copy_seconds,
            summa_recompiles=SU.table_builds() - self.recompiles0,
            broadcast_seconds=(self.grid.broadcast_seconds
                               if self.grid is not None else 0.0),
            broadcast_bytes=(self.grid.bytes_sent
                             if self.grid is not None else 0))


def _robust_factor(sv: _Solver):
    """Factor, escalating past tiles whose storage format killed a pivot
    (e.g. fp8 saturation on a loud diagonal block)."""
    ones = np.ones((sv.n, sv.nrhs))
    while True:
        try:
            return sv.factor()
        except ZeroDivisionError:
            if (sv.escalations >= sv.cfg.max_escalations
                    or not sv.escalate(ones)):
                raise


def _solve_lu(sv: _Solver, t0: float) -> SolveReport:
    cfg = sv.cfg
    lu_ = _robust_factor(sv)
    x = np.zeros((sv.n, sv.nrhs))
    history: list[float] = []
    prev = float("inf")
    sweeps = 0
    while sweeps < cfg.max_sweeps:
        ts = time.perf_counter()
        with obs.span("solve.sweep", "solve", sweep=sweeps + 1,
                      method="lu"):
            r = sv.b64 - np.asarray(sv.amul(x.astype(np.float32)),
                                    np.float64)
            d = LU.solve_upper(
                lu_,
                LU.solve_unit_lower(lu_, r.astype(np.float32), cfg.tile),
                cfg.tile)
            x = x + d
            m = sv.metric(x)
        sv.sweep_seconds.append(time.perf_counter() - ts)
        sweeps += 1
        history.append(m)
        if obs.is_enabled():
            obs.event("solve.sweep_metric", "solve", sweep=sweeps,
                      metric=float(m))
        if m <= cfg.tol:
            return sv.report(x, True, sweeps, history, t0)
        if not np.isfinite(m) or m > cfg.stall_ratio * prev:
            if (sv.escalations >= cfg.max_escalations
                    or not sv.escalate(x)):
                break
            lu_ = _robust_factor(sv)   # factors follow the escalated map
            if not np.all(np.isfinite(x)) or not np.isfinite(m):
                x = np.zeros_like(x)   # restart a diverged iterate
            prev = float("inf")
            continue
        prev = m
    return sv.report(x, False, sweeps, history, t0)


def _solve_cg(sv: _Solver, t0: float) -> SolveReport:
    """Jacobi-preconditioned CG for SPD operators, matvecs through the
    tile-centric GEMM; escalation restarts from the current iterate."""
    cfg = sv.cfg
    dinv = 1.0 / np.clip(np.abs(np.diag(sv.a64)), 1e-300, None)

    def restart(x):
        r = sv.b64 - np.asarray(sv.amul(x.astype(np.float32)), np.float64)
        z = dinv[:, None] * r
        return r, z, z.copy(), (r * z).sum(axis=0)

    x = np.zeros((sv.n, sv.nrhs))
    r, z, p, rz = restart(x)
    history: list[float] = []
    prev = float("inf")
    iters = 0
    blk0 = time.perf_counter()
    while iters < cfg.max_sweeps * cfg.cg_check_every:
        v = np.asarray(sv.amul(p.astype(np.float32)), np.float64)
        alpha = rz / np.clip((p * v).sum(axis=0), 1e-300, None)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * v
        z = dinv[:, None] * r
        rz_new = (r * z).sum(axis=0)
        p = z + (rz_new / np.clip(rz, 1e-300, None))[None, :] * p
        rz = rz_new
        iters += 1
        if iters % cfg.cg_check_every:
            continue
        m = sv.metric(x)
        sv.sweep_seconds.append(time.perf_counter() - blk0)
        blk0 = time.perf_counter()
        history.append(m)
        if obs.is_enabled():
            obs.event("solve.sweep_metric", "solve", sweep=iters,
                      metric=float(m))
        if m <= cfg.tol:
            return sv.report(x, True, iters, history, t0)
        if not np.isfinite(m) or m > cfg.stall_ratio * prev:
            if (sv.escalations >= cfg.max_escalations
                    or not sv.escalate(x)):
                break
            if not np.all(np.isfinite(x)) or not np.isfinite(m):
                x = np.zeros_like(x)
            r, z, p, rz = restart(x)   # the operator changed
            prev = float("inf")
            continue
        prev = m
    return sv.report(x, False, iters, history, t0)


def _solve_on_grid(grid, a: torch.Tensor, b: torch.Tensor,
                   cfg: SolveConfig) -> SolveReport:
    """One rank of a distributed solve (``run_on_grid``'s function)."""
    return solve(a.numpy(), b.numpy(), cfg, device=grid.device, grid=grid)


def solve(a, b, cfg: SolveConfig = SolveConfig(),
          device: torch.device | str | None = None, *, grid=None,
          backend: str | None = None) -> SolveReport:
    """Solve ``A·x = b`` with residual-driven adaptive tile precision.

    ``a`` is the exact operator (numpy, any float dtype), ``b`` one or
    more right-hand sides.  The GEMMs run on ``device`` (default
    ``cuda``; pass ``"cpu"`` for the plain versions); the report carries
    the solution, the escalated map and its storage bytes, the HPL-MxP
    metric trajectory and the zero-mid-solve-resolution audit.

    With ``cfg.summa_grid`` the solve runs on ``grid`` (a
    :class:`~repro_torch.launch.grid.Grid` of that shape, every rank
    calling ``solve``); without one it checks the configuration, spawns
    the P·Q ranks on ``device`` over ``backend``
    (``launch.grid.placement``: ``None`` takes nccl when every rank can
    have a card, else gloo) and returns rank 0's report."""
    if cfg.summa_grid is not None and grid is None:
        from repro_torch.launch.grid import placement, run_on_grid
        a64 = np.asarray(a, np.float64)
        if a64.ndim != 2 or a64.shape[0] != a64.shape[1]:
            raise ValueError(f"operator must be square, got {a64.shape}")
        n = a64.shape[0]
        b64 = np.asarray(b, np.float64).reshape(n, -1)
        _check_grid(cfg, n, _rhs_width(cfg, b64.shape[1]))
        P, Q = cfg.summa_grid
        rank_device, backend = placement(
            P, Q, "cuda" if device is None else str(device), backend)
        # torch tensors travel to the ranks through shared memory
        return run_on_grid(P, Q, _solve_on_grid, torch.from_numpy(a64),
                           torch.from_numpy(b64), cfg, device=rank_device,
                           backend=backend)
    t0 = time.perf_counter()
    with obs.span("solve.run", "solve", method=cfg.method, tile=cfg.tile,
                  escalation=cfg.escalation):
        sv = _Solver(a, b, cfg, torch.device("cuda" if device is None
                                             else device), grid)
        sv.ratio_history.append(map_ratio_string(sv.pa, sv.cfg.fset))
        if cfg.method == "cg":
            return _solve_cg(sv, t0)
        if cfg.method != "lu":
            raise ValueError(f"unknown method {cfg.method!r} (lu | cg)")
        return _solve_lu(sv, t0)
