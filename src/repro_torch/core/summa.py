"""Distributed tile-centric mixed-precision GEMM — SUMMA over
``torch.distributed`` (twin of ``repro.core.summa``).

The paper's Algorithm 1 dataflow on a P×Q grid of ranks
(:class:`repro_torch.launch.grid.Grid`)::

  for each k-panel l:
      owner column of A(:, l) broadcasts the panel along grid rows
      owner row    of B(l, :) broadcasts the panel along grid columns
      every rank updates its C block at the C tiles' precision

**Receiver-side conversion** (the paper's key communication property):
a panel travels *in storage precision*, one slab per registered format of
the operands' :class:`~repro_torch.core.formats.FormatSet` (the fp32
tiles of a panel as an fp32 slab, the bf16 tiles as a bf16 slab, the fp8
tiles as an fp8 slab), each a ``dist.broadcast`` from the owner along the
row or column subgroup; the receiver upcasts.  For the slabs to have the
same shape on every rank, the A/B class maps must be *sorted-balanced*
(``schedule.sorted_balanced_map``): within every panel and shard
segment, classes appear in descending storage cost (``fset.class_order``)
and every panel has identical per-class counts.

Contract (the reference's): every rank holds the global ``MPMatrix``
operands, slices its own (p, q) block, runs the step loop on it, and the
C blocks are all-gathered, so every rank returns the global result with
C's class map.  The local update is routed through the plan machinery
(``tune.dispatch.resolve_summa_plan``):

* ``ref``: the slabs upcast in ``class_order``, then per C class one
  fp32-accumulating dot of the panel at that class's compute dtype;
* ``grouped``: the grouped kernel in its accumulate-into form on the
  card (its plain version on the CPU), one launch per k-panel, adding
  into fp32 running sums of the rank's C tiles.

Both keep the running sum in fp32, apply ``alpha``/``beta`` once after
the last panel and round into C's storage once, at the end
(``MPMatrix.from_dense``: the convert kernel on the card).  A C tile's
value does not depend on the shape of the grid: every panel product is
computed tile by tile (the kernel's work items on the card; t×t×t
products on the CPU), so a P×Q run equals the 1×1 run bit for bit.

The static per-call tables (sorted-balanced class counts, the owner
steps, the panels' slot tables and the per-shard C maps) are cached by
maps, grid and tile, with their copies on the card (the slabs' gather
indices and the grouped kernel's tables and work list, uploaded once and
passed to every k-panel's launch); :func:`table_builds` counts the
builds, the counterpart of the reference's jit cache misses.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.formats import DEFAULT_FORMATS, FormatSet

#: local-update paths the SUMMA rank-update can execute
LOCAL_PATHS = ("ref", "grouped")

#: most static-table sets kept (an escalating solve visits one per rung)
TABLE_CACHE_SIZE = 256

_TABLES: dict = {}
_table_builds = 0


def table_builds() -> int:
    """Builds of SUMMA's static tables in this process (cache misses)."""
    return _table_builds


def _panel_owner_steps(K: int, tile: int, P: int, Q: int):
    """Static per-step metadata: owner col of A panel, local panel index in
    the owner, owner row of B panel, local panel index.

    Raises a descriptive ``ValueError`` when the K panels do not divide
    evenly over the grid."""
    if K % tile:
        raise ValueError(f"K={K} must be a multiple of tile={tile}")
    kt = K // tile
    if kt % Q or kt % P:
        raise ValueError(
            f"K/tile={kt} panels do not divide evenly over the {P}x{Q} "
            f"grid (kt%P={kt % P}, kt%Q={kt % Q}); choose K a multiple of "
            f"tile*P and tile*Q so every shard owns whole panels")
    kloc_a, kloc_b = K // Q, K // P
    q_a = (np.arange(kt) * tile) // kloc_a
    la = np.arange(kt) - q_a * (kloc_a // tile)
    p_b = (np.arange(kt) * tile) // kloc_b
    lb = np.arange(kt) - p_b * (kloc_b // tile)
    return (q_a.astype(np.int32), la.astype(np.int32),
            p_b.astype(np.int32), lb.astype(np.int32))


def _check_sorted_balanced(cls_map: np.ndarray, axis: int, groups: int,
                           fset: FormatSet) -> dict[int, int]:
    """Verify the map is sorted-balanced along ``axis`` with ``groups`` shard
    segments: within every segment-panel the classes appear in descending
    storage cost (``fset.class_order``) with identical per-class counts.
    Returns the per-class tile count of one segment-panel."""
    m = cls_map if axis == 0 else cls_map.T
    if m.shape[0] % groups:
        raise ValueError(
            f"map extent {m.shape[0]} along axis {axis} not divisible by "
            f"{groups} shard groups")
    seg = m.shape[0] // groups
    counts: tuple | None = None
    for g in range(groups):
        blk = m[g * seg:(g + 1) * seg]
        for j in range(m.shape[1]):
            col = blk[:, j]
            c = {code: int((col == code).sum()) for code in fset.codes}
            canon = np.concatenate(
                [np.full(c[code], code, np.int8)
                 for code in fset.class_order])
            if not np.array_equal(col, canon):
                raise ValueError(
                    "map not class-sorted (descending storage cost) within "
                    "panel segment — build A/B maps with "
                    "schedule.sorted_balanced_map")
            key = tuple(c[code] for code in fset.codes)
            if counts is None:
                counts = key
            elif counts != key:
                raise ValueError(
                    "map not balanced across panels/segments — per-panel "
                    "class counts must be identical for static SPMD slabs")
    return {code: (counts[code] if counts else 0) for code in fset.codes}


def _class_offsets(counts: dict[int, int], tile: int, fset: FormatSet
                   ) -> dict[int, int]:
    """Element offset of each class's slab within a local panel, in
    ``class_order`` (descending storage cost — matching the sorted maps)."""
    off, out = 0, {}
    for code in fset.class_order:
        out[code] = off
        off += counts[code] * tile
    return out


def _segment_class_vector(counts: dict[int, int], fset: FormatSet
                          ) -> np.ndarray:
    """Per-tile class codes of one sorted segment-panel (class_order)."""
    return np.concatenate([np.full(counts[code], code, np.int8)
                           for code in fset.class_order])


def _panel_slot_tables(vec: np.ndarray, fset: FormatSet, transpose: bool
                       ) -> list[np.ndarray]:
    """Grouped-kernel dispatch tables for a sorted panel: per format code, a
    table routing tile index → slot in that format's tile stack (``n_code``
    for a tile of another class)."""
    out = []
    for code in fset.codes:
        n_code = int((vec == code).sum())
        tbl = np.full((len(vec), 1), n_code, np.int32)
        rows = np.nonzero(vec == code)[0]
        tbl[rows, 0] = np.arange(len(rows), dtype=np.int32)
        out.append(tbl.T.copy() if transpose else tbl)
    return out


def _sorted_groups(cls_map: np.ndarray, axis: int, groups: int,
                   fset: FormatSet) -> int:
    """The fewest segments, a multiple of ``groups``, in which the map is
    sorted-balanced along ``axis`` (so maps built for a finer grid serve
    a coarser one: each rank's segment is then several sorted runs);
    raises ``groups``' error when there is none."""
    try:
        _check_sorted_balanced(cls_map, axis, groups, fset)
        return groups
    except ValueError as e:
        first = e
    extent = cls_map.shape[axis]
    for g in range(2 * groups, extent + 1, groups):
        if extent % g:
            continue
        try:
            _check_sorted_balanced(cls_map, axis, g, fset)
            return g
        except ValueError:
            continue
    raise first


class _Tables:
    """SUMMA's static tables for one (maps, grid, tile, path).

    A map sorted-balanced in G segments (G a multiple of the grid extent)
    gives every rank the same class vector along its segment of each
    panel (``a_vec``/``b_vec``: G/P sorted runs); the slab of a class
    gathers that class's tiles in segment order (``a_idx``/``b_idx``),
    one contiguous run when G equals the extent."""

    def __init__(self, amap, bmap, cmap, tile, P, Q, K, fset, local_path):
        ga = _sorted_groups(amap, 0, P, fset)
        gb = _sorted_groups(bmap, 1, Q, fset)
        self.steps = np.stack(_panel_owner_steps(K, tile, P, Q), axis=1)
        self.a_vec, self.a_idx = self._segment(
            _check_sorted_balanced(amap, axis=0, groups=ga, fset=fset),
            ga // P, fset)
        self.b_vec, self.b_idx = self._segment(
            _check_sorted_balanced(bmap, axis=1, groups=gb, fset=fset),
            gb // Q, fset)
        self.c_classes = sorted(int(v) for v in np.unique(cmap))
        self._ncodes = len(fset)
        self._idx_on: dict = {}
        self._kernel_on: dict = {}
        mt_loc, nt_loc = cmap.shape[0] // P, cmap.shape[1] // Q
        #: the C map of every shard, [P][Q]
        self.c_loc = [[np.ascontiguousarray(
            cmap[p * mt_loc:(p + 1) * mt_loc, q * nt_loc:(q + 1) * nt_loc])
            for q in range(Q)] for p in range(P)]
        if local_path == "grouped":
            # the kernel launches one work item per local C tile: every
            # shard must hold the same per-class tile counts
            counts = [np.bincount(blk.reshape(-1), minlength=len(fset))
                      for row in self.c_loc for blk in row]
            for code in self.c_classes:
                if len({int(c[code]) for c in counts}) > 1:
                    raise ValueError(
                        "grouped SUMMA local path needs a shard-balanced "
                        "C map (identical per-class tile counts on every "
                        "shard, e.g. schedule.balanced_ratio_map with "
                        f"{P}x{Q} groups); class {code} varies")
            a_tbl = _panel_slot_tables(self.a_vec, fset, transpose=False)
            b_tbl = _panel_slot_tables(self.b_vec, fset, transpose=True)
            n = np.arange(len(self.a_vec))
            self.a_cls = self.a_vec[:, None]
            self.a_slot = np.stack(a_tbl)[self.a_vec, n, 0][:, None]
            n = np.arange(len(self.b_vec))
            self.b_cls = self.b_vec[None, :]
            self.b_slot = np.stack(b_tbl)[self.b_vec, 0, n][None, :]

    def idx_on(self, device: torch.device) -> tuple[dict, dict]:
        """``a_idx`` and ``b_idx`` on ``device`` (copied once)."""
        key = str(device)
        if key not in self._idx_on:
            self._idx_on[key] = tuple(
                {code: x.to(device) for code, x in idx.items()}
                for idx in (self.a_idx, self.b_idx))
        return self._idx_on[key]

    def kernel_on(self, device: torch.device, p: int, q: int):
        """The grouped kernel's int32 tables of shard (p, q) on a CUDA
        ``device`` (uploaded once; the same at every k-panel), None on
        the CPU, where the plain version needs none."""
        if device.type != "cuda":
            return None
        key = (str(device), p, q)
        if key not in self._kernel_on:
            from repro_torch.kernels.grouped_gemm import device_tables
            self._kernel_on[key] = device_tables(
                self.a_cls, self.a_slot, self.b_cls, self.b_slot,
                self.c_loc[p][q], self._ncodes, device)
        return self._kernel_on[key]

    @staticmethod
    def _segment(run_counts: dict, runs: int, fset: FormatSet):
        """A rank segment of ``runs`` sorted runs: its class vector and,
        per class, the tile indices of that class in segment order."""
        run = _segment_class_vector(run_counts, fset)
        off = _class_offsets(run_counts, 1, fset)
        idx = {code: torch.from_numpy(np.concatenate(
            [r * len(run) + off[code] + np.arange(run_counts[code])
             for r in range(runs)]).astype(np.int64))
            for code in fset.codes}
        return np.tile(run, runs), idx


def _tables(amap, bmap, cmap, tile, P, Q, K, fset, local_path) -> _Tables:
    global _table_builds
    key = (amap.shape, amap.tobytes(), bmap.shape, bmap.tobytes(),
           cmap.shape, cmap.tobytes(), tile, P, Q, K, fset.key(), local_path)
    tab = _TABLES.get(key)
    if tab is None:
        tab = _Tables(amap, bmap, cmap, tile, P, Q, K, fset, local_path)
        _table_builds += 1
        if len(_TABLES) >= TABLE_CACHE_SIZE:
            _TABLES.pop(next(iter(_TABLES)))
        _TABLES[key] = tab
    return tab


def prepare(a_cls, b_cls, c_cls, *, tile: int, fset: FormatSet, grid,
            local_path: str = "ref") -> None:
    """Build (or find) the static tables of a SUMMA GEMM with these class
    maps on ``grid`` without running it: the solver's warm pass over its
    escalation ladder, so promotion builds no tables mid-solve."""
    a_cls, b_cls, c_cls = (np.asarray(m, np.int8) for m in
                           (a_cls, b_cls, c_cls))
    _tables(a_cls, b_cls, c_cls, tile, grid.P, grid.Q,
            a_cls.shape[1] * tile, fset, local_path)


def _panel_dot(a_panel: torch.Tensor, b_panel: torch.Tensor, tile: int
               ) -> torch.Tensor:
    """``a_panel [mloc, t] · b_panel [t, nloc]`` in fp32, one t×t×t
    product per C tile, so a tile's value does not depend on the shard's
    shape."""
    from repro_torch.core.layout import fp32_matmul
    mloc, nloc = a_panel.shape[0], b_panel.shape[1]
    at = a_panel.reshape(mloc // tile, 1, tile, tile)
    bt = b_panel.reshape(tile, nloc // tile, tile).permute(1, 0, 2)[None]
    return fp32_matmul(at, bt).permute(0, 2, 1, 3).reshape(mloc, nloc)


def _summa_impl(a, b, c, grid, alpha: float, beta: float, local_path: str):
    from repro_torch.core.layout import CompactMPMatrix, MPMatrix, expand_map
    from repro_torch.kernels import grouped_gemm as _grouped
    from repro_torch.kernels import mp_gemm_tile as _tile
    fset, T = a.fset, a.tile
    P, Q = grid.P, grid.Q
    M, K = a.padded_shape
    N = b.padded_shape[1]
    if M % (P * T) or N % (Q * T):
        raise ValueError(
            f"M={M}, N={N} must be multiples of P*tile={P * T} and "
            f"Q*tile={Q * T} for the {P}x{Q} grid")
    mloc, nloc = M // P, N // Q
    if local_path not in LOCAL_PATHS:
        raise ValueError(f"unknown SUMMA local path {local_path!r}; "
                         f"valid: {LOCAL_PATHS}")
    dev = a.device
    if grid.device != dev or b.device != dev or c.device != dev:
        raise ValueError(f"operands on {a.device}/{b.device}/{c.device}, "
                         f"the grid's rank on {grid.device}")
    tab = _tables(np.asarray(a.cls, np.int8), np.asarray(b.cls, np.int8),
                  np.asarray(c.cls, np.int8), T, P, Q, K, fset, local_path)
    p, q = grid.p, grid.q
    kloc_a, kloc_b = K // Q, K // P
    a_blk = [x[p * mloc:(p + 1) * mloc, q * kloc_a:(q + 1) * kloc_a]
             for x in a.bufs]
    b_blk = [x[p * kloc_b:(p + 1) * kloc_b, q * nloc:(q + 1) * nloc]
             for x in b.bufs]
    c_loc = tab.c_loc[p][q]
    specs = _tile.format_specs(fset)
    mt_loc, nt_loc = mloc // T, nloc // T
    a_idx, b_idx = tab.idx_on(dev)

    def a_slab(code, owner, local):
        """The A panel's tiles of class ``code`` [n, t, t], in segment
        order."""
        idx = a_idx[code]
        if grid.q == owner:
            x = a_blk[code][:, local * T:(local + 1) * T].reshape(
                mt_loc, T, T).index_select(0, idx)
        else:
            x = torch.empty((len(idx), T, T), dtype=a.bufs[code].dtype,
                            device=dev)
        return grid.broadcast(x, owner, "row")

    def b_slab(code, owner, local):
        """The B panel's tiles of class ``code`` [n, t, t], in segment
        order."""
        idx = b_idx[code]
        if grid.p == owner:
            x = b_blk[code][local * T:(local + 1) * T].reshape(
                T, nt_loc, T).permute(1, 0, 2).index_select(0, idx)
        else:
            x = torch.empty((len(idx), T, T), dtype=b.bufs[code].dtype,
                            device=dev)
        return grid.broadcast(x, owner, "col")

    if local_path == "grouped":
        k_tabs = tab.kernel_on(dev, p, q)
        n_cls = np.bincount(c_loc.reshape(-1), minlength=len(fset))
        acc = tuple(torch.zeros((int(n), T, T), dtype=torch.float32,
                                device=dev) for n in n_cls)
    else:
        acc = torch.zeros((mloc, nloc), dtype=torch.float32, device=dev)
        sel_c = (torch.from_numpy(expand_map(c_loc, T)).to(dev)
                 if len(tab.c_classes) > 1 else None)
        a_perm, b_perm = (torch.argsort(torch.cat(
            [idx[code] for code in fset.class_order]))
            for idx in (a_idx, b_idx))
    for qa, la, pb, lb in tab.steps:
        a_slabs = {code: a_slab(code, qa, la) for code in fset.codes}
        b_slabs = {code: b_slab(code, pb, lb) for code in fset.codes}
        if local_path == "grouped":
            # the kernel upcasts each slab's tiles as it loads them
            ap = CompactMPMatrix(
                tuple(a_slabs[code] for code in fset.codes),
                tab.a_cls, tab.a_slot, T, (mloc, T), fset)
            bp = CompactMPMatrix(
                tuple(b_slabs[code] for code in fset.codes),
                tab.b_cls, tab.b_slot, T, (T, nloc), fset)
            _grouped.grouped_mp_gemm(ap, bp, c_loc, acc=acc, tables=k_tabs)
            continue
        # receiver-side conversion: every storage slab upcast (in
        # class_order), its tiles put back in segment order, then one dot
        # per C class at that class's compute dtype
        a_panel = torch.cat([a_slabs[code].float()
                             for code in fset.class_order])[a_perm]
        b_panel = torch.cat([b_slabs[code].float()
                             for code in fset.class_order])[b_perm]
        a_panel = a_panel.reshape(mloc, T)
        b_panel = b_panel.permute(1, 0, 2).reshape(T, nloc)
        upd = None
        for code in tab.c_classes:
            compute = specs[code][0]
            d = _panel_dot(_tile._round(a_panel, compute),
                           _tile._round(b_panel, compute), T)
            upd = d if upd is None else torch.where(sel_c == code, d, upd)
        acc = acc + upd
    if local_path == "grouped":
        acc = CompactMPMatrix(acc, c_loc, CompactMPMatrix.make_slots(c_loc),
                              T, (mloc, nloc), fset).padded_dense()
    c_blk = [x[p * mloc:(p + 1) * mloc, q * nloc:(q + 1) * nloc]
             for x in c.bufs]
    c32 = c_blk[0].float()
    for x in c_blk[1:]:
        c32 = c32 + x.float()
    out = alpha * acc + beta * c32
    # one storage rounding into each C tile's format, then every rank
    # gathers every block
    local = MPMatrix.from_dense(out, c_loc, T, fset)
    bufs = []
    for x in local.bufs:
        blocks = grid.all_gather(x.contiguous())
        bufs.append(torch.cat([torch.cat(blocks[r * Q:(r + 1) * Q], 1)
                               for r in range(P)], 0))
    return MPMatrix(tuple(bufs), c.cls, T, c.shape, fset)


def summa_mp_gemm(a, b, c=None, *, grid, alpha: float = 1.0,
                  beta: float = 0.0, plan=None):
    """Distributed C ← αAB + βC over ``grid`` with MPMatrix operands.

    Works for any registered format set (2 or 3 formats): panels travel
    as one storage-precision slab per format.  A/B maps must be
    sorted-balanced (see the module docstring); ``c=None`` defaults to a
    zero uniform-LOW output like single-device ``mp_matmul``.  Every rank
    passes the same global operands, on its grid device.

    The local update's path comes from ``plan`` (a ``GemmPlan`` whose
    ``path`` is ``"ref"`` or ``"grouped"``) or, when omitted, from the
    distributed plan registry/cache (``tune.dispatch.resolve_summa_plan``
    — the reference path on a miss).  Returns a new MPMatrix with C's
    class map, on every rank.
    """
    from repro_torch import obs
    from repro_torch.tune import dispatch as _dispatch
    from repro_torch.tune.costmodel import validate_plan
    from repro_torch.tune.device import detect_device

    a, b, c = _dispatch.canonical_operands(a, b, c)
    prob = _dispatch.summa_problem(a, b, c, grid, alpha=alpha, beta=beta)
    if plan is None:
        plan, _src = _dispatch.resolve_summa_plan(prob)
    else:
        bad = validate_plan(plan, prob, detect_device(a.device))
        if bad:
            raise ValueError(f"SUMMA plan {plan.key()} invalid: {bad}")
    obs.metrics_registry().counter(
        _dispatch.DISPATCH_METRIC, path=plan.path, op=prob.op,
        formats=prob.formats).inc()
    if not obs.is_enabled():
        return _summa_impl(a, b, c, grid, alpha, beta, plan.path)
    # one span for the whole distributed GEMM plus an instant per
    # k-panel with the static owner schedule (host time; the span ends
    # when the last local update is enqueued)
    K = prob.k
    with obs.span("summa.gemm", "summa", op=prob.op, path=plan.path,
                  m=prob.m, n=prob.n, k=prob.k, formats=prob.formats,
                  steps=K // a.tile):
        try:
            qa, la, pb, lb = _panel_owner_steps(K, a.tile, grid.P, grid.Q)
            for s in range(len(qa)):
                obs.event("summa.panel", "summa", step=s,
                          a_owner_col=int(qa[s]), a_local=int(la[s]),
                          b_owner_row=int(pb[s]), b_local=int(lb[s]))
        except ValueError:
            pass          # _summa_impl raises the descriptive error
        return _summa_impl(a, b, c, grid, alpha, beta, plan.path)


def summa_collective_bytes(M: int, N: int, K: int, tile: int, P: int, Q: int,
                           ratio_high: float, ratio_low8: float = 0.0,
                           fset: FormatSet = DEFAULT_FORMATS) -> dict:
    """Analytic communication model (per full GEMM, all shards summed):
    each of K/tile steps broadcasts an A panel (M/P rows) to Q columns and a
    B panel (N/Q cols) to P rows, in storage precision — the per-element wire
    cost is the role-fraction-weighted storage bytes of the format set."""
    kt = K // tile
    hb, lb, l8b = fset.role_bytes()
    bytes_per_elem = (hb * ratio_high + l8b * ratio_low8
                      + lb * (1.0 - ratio_high - ratio_low8))
    a_panel = (M // P) * tile * bytes_per_elem
    b_panel = (N // Q) * tile * bytes_per_elem
    per_step = a_panel * P * Q + b_panel * P * Q   # every shard receives one
    return {
        "steps": kt,
        "a_panel_bytes": a_panel,
        "b_panel_bytes": b_panel,
        "total_bytes": per_step * kt,
        "bytes_per_elem_model": bytes_per_elem,
    }


def summa_with_stats(a, b, c=None, *, grid, plan=None, alpha: float = 1.0,
                     beta: float = 0.0) -> dict:
    """:func:`summa_mp_gemm` with what each rank counted, for checking a
    run: operands are moved to the grid's device.  Returns the
    result (on the CPU) and, per rank in rank order, the grouped-kernel
    launches, the broadcasts, their bytes and their host seconds (each
    read in its own rank and gathered), and each rank's host seconds of
    the call."""
    from repro_torch.kernels import grouped_gemm as _grouped
    a, b = _on(a, grid.device), _on(b, grid.device)
    c = None if c is None else _on(c, grid.device)
    grid.reset_counters()
    launches0 = _grouped.launches
    t0 = time.perf_counter()
    out = summa_mp_gemm(a, b, c, grid=grid, plan=plan, alpha=alpha,
                        beta=beta)
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)
    seconds = time.perf_counter() - t0
    mine = torch.tensor([_grouped.launches - launches0, grid.broadcasts,
                         grid.bytes_sent, grid.broadcast_seconds, seconds],
                        dtype=torch.float64, device=grid.device)
    rows = [r.cpu().tolist() for r in grid.all_gather(mine)]
    return {"grid": f"{grid.P}x{grid.Q}", "out": _on(out, "cpu"),
            "launches": [int(r[0]) for r in rows],
            "broadcasts": [int(r[1]) for r in rows],
            "bytes": [int(r[2]) for r in rows],
            "broadcast_seconds": [r[3] for r in rows],
            "seconds": [r[4] for r in rows]}


def _on(m, device):
    """An MPMatrix with its buffers on ``device``."""
    return dataclasses.replace(m, bufs=tuple(x.to(device) for x in m.bufs))


def config_selfcheck(cfg, grid, *, device: str = "cuda",
                     backend: str | None = None) -> dict:
    """``summa_selfcheck`` at an ArchConfig's tile/policy/format set on a
    fresh P×Q grid of spawned ranks (``grid`` is ``(P, Q)``) — the launch
    wiring behind ``launch.train --summa`` and ``Engine(summa_grid=…)``.
    ``backend=None`` takes :func:`repro_torch.launch.grid.placement`'s
    rule (nccl when every rank has a card, else gloo)."""
    from repro_torch.core.formats import format_set
    from repro_torch.launch.grid import placement, run_on_grid
    P, Q = (int(v) for v in grid)
    rank_device, backend = placement(P, Q, device, backend)
    return run_on_grid(P, Q, summa_selfcheck, tile=cfg.mp_tile,
                       policy=cfg.mp_policy,
                       fset=format_set(*cfg.mp_formats.split("+")),
                       device=rank_device, backend=backend)


def summa_selfcheck(grid, *, tile: int = 16, size: int | None = None,
                    policy=None, fset: FormatSet = DEFAULT_FORMATS,
                    seed: int = 0) -> dict:
    """Launch-time validation of the distributed path (train/serve wiring):
    build a sorted-balanced GEMM at the config's tile/policy/format set, run
    SUMMA on ``grid`` against the single-device reference, and return a
    report (resolved plan, relative error, wire-byte model).  Inputs are
    standard normals from numpy's generator at ``seed``."""
    from repro_torch.core import schedule
    from repro_torch.core.layout import MPMatrix
    from repro_torch.core.mp_gemm import mp_gemm_ref
    from repro_torch.core.precision import Policy
    from repro_torch.tune import dispatch as _dispatch

    P, Q = grid.P, grid.Q
    policy = policy or Policy(kind="ratio", ratio_high=0.5)
    size = size or tile * P * Q          # divides every grid constraint
    M = N = K = size
    mt, nt, kt = M // tile, N // tile, K // tile
    pa = schedule.sorted_balanced_map(mt, kt, policy, axis=0, groups=P,
                                      fset=fset)
    pb = schedule.sorted_balanced_map(kt, nt, policy, axis=1, groups=Q,
                                      fset=fset)
    pc = schedule.balanced_ratio_map(mt, nt, policy, P, Q, fset=fset)
    rng = np.random.default_rng(seed)
    dev = grid.device
    A = MPMatrix.from_dense(torch.from_numpy(
        rng.standard_normal((M, K), np.float32)).to(dev), pa, tile, fset)
    B = MPMatrix.from_dense(torch.from_numpy(
        rng.standard_normal((K, N), np.float32)).to(dev), pb, tile, fset)
    C = MPMatrix.from_dense(torch.zeros((M, N), device=dev), pc, tile, fset)
    prob = _dispatch.summa_problem(A, B, C, grid)
    plan, source = _dispatch.resolve_summa_plan(prob)
    out = summa_mp_gemm(A, B, C, grid=grid, plan=plan)
    ref = mp_gemm_ref(A, B, C)
    err = float((out.to_dense() - ref.to_dense()).abs().max())
    scale = float(ref.to_dense().abs().max())
    hi = float((pa == fset.high).mean())
    lo8 = (float((pa == fset.low8).mean()) if fset.low8 is not None else 0.0)
    model = summa_collective_bytes(M, N, K, tile, P, Q, hi, lo8, fset)
    return {
        "grid": f"{P}x{Q}", "size": size, "tile": tile,
        "formats": fset.key(), "local_path": plan.path,
        "plan_source": source, "max_abs_err": err,
        "rel_err": err / max(scale, 1e-30),
        "wire_bytes_per_elem": model["bytes_per_elem_model"],
    }
