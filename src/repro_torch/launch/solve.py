"""Adaptive-precision refinement-solver launcher (twin of
``repro.launch.solve``).

    python -m repro_torch.launch.solve --n 8192 --tile 128 --ratio 0D:100S
    python -m repro_torch.launch.solve --n 256 --device cpu
    python -m repro_torch.launch.solve --summa 2x2 --device cpu

Solves an ill-conditioned synthetic system (``repro_torch.solve.matrices``)
with residual-driven tile-precision escalation on one card (``--device
cuda``, the default) or with the kernels' plain versions on the CPU, and
prints the HPL-MxP metric trajectory, the precision-map adaptation, the
storage saving against uniform-HIGH and the mid-solve resolution audit.
``--summa PxQ`` runs the residual GEMM as SUMMA on a P×Q grid of spawned
ranks (``--local-path ref|grouped``; escalation defaults to ``balanced``).
``--backend`` defaults to ``nccl`` when P·Q cards are visible (a card per
rank) and to ``gloo`` otherwise (every rank on ``cuda:0``, or the CPU);
the choice is printed before any work.  The reference's ``--devices``
has no counterpart: the grid is ``--summa``.  ``--trace PATH`` records a
``repro_torch.obs`` JSONL trace (with ``--summa``, rank 0's events) and
writes its Chrome export beside it.
Exit status is nonzero unless the solve converged with zero fresh
mid-solve plan resolutions and (tile escalation, store mode) a map
cheaper than uniform-HIGH.
"""
import argparse
import sys


def _parse_ratio(s: str) -> tuple[float, float]:
    """'20D:70S:10Q' → (0.20, 0.10); the S share is the remainder."""
    hi = lo8 = 0.0
    for seg in s.split(":"):
        seg = seg.strip().upper()
        if seg.endswith("D"):
            hi = float(seg[:-1]) / 100.0
        elif seg.endswith("Q"):
            lo8 = float(seg[:-1]) / 100.0
        elif not seg.endswith("S"):
            raise ValueError(f"bad ratio segment {seg!r} (want e.g. "
                             "'0D:100S' or '0D:80S:20Q')")
    return hi, lo8


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--nrhs", type=int, default=1)
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--matrix", default="graded-spd",
                    choices=["graded-spd", "diag-dominant"])
    ap.add_argument("--cond", type=float, default=1e4,
                    help="diagonal-grading span of the SPD operator")
    ap.add_argument("--rho", type=float, default=0.9,
                    help="off-diagonal decay of the SPD operator")
    ap.add_argument("--ratio", default="0D:100S",
                    help="starting precision map, e.g. 0D:100S or "
                         "0D:80S:20Q")
    ap.add_argument("--formats", default="",
                    help="format-set spec, e.g. fp8_e5m2+fp16+fp32 or "
                         "the short form d:s:q")
    ap.add_argument("--method", default="lu", choices=["lu", "cg"])
    ap.add_argument("--tol", type=float, default=1.0)
    ap.add_argument("--max-sweeps", type=int, default=60)
    ap.add_argument("--escalation", default="",
                    choices=["", "tile", "balanced"],
                    help="default: balanced with --summa, else tile")
    ap.add_argument("--compute-escalation", default="store",
                    choices=["store", "split", "auto"],
                    help="stalled tiles escalate storage (store), switch "
                         "to split-accumulate recovery (split), or let "
                         "the cost model choose (auto)")
    ap.add_argument("--split-format", default="split2_fp16",
                    help="split compound format the compute-higher mode "
                         "substitutes for HIGH")
    ap.add_argument("--summa", default="",
                    help="P x Q residual-GEMM grid of ranks, e.g. 2x2")
    ap.add_argument("--local-path", default="ref",
                    choices=["ref", "grouped"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend of the --summa grid "
                         "(default: nccl when P*Q cards are visible, else "
                         "gloo)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the GEMMs (cuda or cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stats", action="store_true",
                    help="print per-sweep wall-times and per-escalation "
                         "promotion records (JSON)")
    ap.add_argument("--trace", default="",
                    help="record a repro_torch.obs JSONL trace to this "
                         "path (a Perfetto-loadable .trace.json is "
                         "written beside it)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core.formats import DEFAULT_FORMATS, FormatSet
    from repro_torch.launch.grid import placement
    from repro_torch.solve import (SolveConfig, diag_dominant, graded_spd,
                                   rhs_for_solution, solve)

    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.trace:
        obs.configure(enabled=True, trace_path=args.trace)
    grid = (tuple(int(v) for v in args.summa.lower().split("x"))
            if args.summa else None)
    device, backend = args.device, args.backend
    if grid:
        device, backend = placement(*grid, args.device, args.backend)
        print(f"summa grid {grid[0]}x{grid[1]}: ranks on {device} over "
              f"{backend}")
    escalation = args.escalation or ("balanced" if grid else "tile")
    hi, lo8 = _parse_ratio(args.ratio)
    fset = (FormatSet.parse(args.formats) if args.formats
            else DEFAULT_FORMATS)
    if args.matrix == "graded-spd":
        a = graded_spd(args.n, cond=args.cond, rho=args.rho, seed=args.seed)
    else:
        a = diag_dominant(args.n, seed=args.seed)
    x_true, b = rhs_for_solution(a, nrhs=args.nrhs, seed=args.seed + 1)

    cfg = SolveConfig(
        tile=args.tile, fset=fset, ratio_high=hi, ratio_low8=lo8,
        seed=args.seed, tol=args.tol, max_sweeps=args.max_sweeps,
        method=args.method, escalation=escalation, summa_grid=grid,
        local_path=args.local_path,
        compute_escalation=args.compute_escalation,
        split_format=args.split_format)
    print(f"solve {args.matrix} n={args.n} nrhs={args.nrhs} "
          f"tile={args.tile} [{fset.key()}] start {args.ratio} "
          f"method={args.method} device={args.device}"
          + (f" summa={grid[0]}x{grid[1]}" if grid else ""))
    rep = solve(a, b, cfg, device=device, backend=backend)

    if args.compute_escalation != "store":
        print(f"compute escalation: {rep.compute_mode} "
              f"(model store {rep.store_cost_s * 1e6:.1f}us vs "
              f"split {rep.split_cost_s * 1e6:.1f}us)")
    for i, m in enumerate(rep.metric_history):
        print(f"  sweep {i + 1:3d}  metric {m:10.3g}")
    print("map trajectory:", " -> ".join(rep.ratio_history))
    err = float(np.abs(rep.x - x_true).max() / np.abs(x_true).max())
    saving = 100.0 * (1.0 - rep.storage_bytes / rep.uniform_high_bytes)
    print(f"converged={rep.converged} sweeps={rep.sweeps} "
          f"escalations={rep.escalations} "
          f"factorizations={rep.factorizations}")
    print(f"final metric {rep.metric:.3g} (tol {cfg.tol}), "
          f"forward err vs x_true {err:.3g}")
    print(f"final map {rep.final_ratio}: {rep.storage_bytes} B vs "
          f"uniform-HIGH {rep.uniform_high_bytes} B "
          f"({saving:.1f}% saved)")
    print(f"GEMM fraction {100 * rep.gemm_fraction:.0f}% of "
          f"{rep.total_seconds:.2f}s; factorizations "
          f"{rep.factor_seconds:.2f}s, of which trailing-update copies "
          f"{rep.trail_copy_seconds:.2f}s; {rep.plan_keys} plans "
          f"prefetched; mid-solve fresh resolutions "
          f"{rep.fresh_resolutions}"
          + (f"; SUMMA table rebuilds {rep.summa_recompiles}, broadcasts "
             f"{rep.broadcast_seconds:.3f}s ({rep.broadcast_bytes} B, "
             "rank 0)" if grid else ""))
    if args.stats:
        import json
        print("per-sweep wall-time (s):",
              " ".join(f"{s:.4f}" for s in rep.sweep_seconds))
        for p in rep.promotions:
            print("promotion:", json.dumps(p, sort_keys=True))
    if args.trace:
        from repro_torch.obs.trace import export_chrome
        obs.configure(enabled=False)     # flush and close the JSONL file
        print(f"trace: {args.trace} (chrome: {export_chrome(args.trace)})")
    # only the data-driven tile mode is gated on a strict storage saving:
    # balanced escalation may saturate at uniform-HIGH, and a split solve
    # saves compute passes, not bytes
    ok = (rep.converged and rep.fresh_resolutions == 0
          and rep.summa_recompiles == 0
          and (escalation == "balanced" or rep.compute_mode == "split"
               or rep.storage_bytes < rep.uniform_high_bytes))
    if not ok:
        print("FAILED: not converged, mid-solve retune, or no storage "
              "saving", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
