"""The readings that a cell's limits are set from, many seeds in one
process (the benchmark's own runs never run this).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds S] [--out FILE]

For each seed it prints one JSON line of the numbers the cell compares:

* ``program``: the program's readings (the lower reading of a limit is
  the largest over a dozen seeds or more);
* ``control``: the reference put in the program's place with every
  weight stored one precision lower (the upper reading is the smallest);
* for a training cell, ``fault_half``: the reference with half of each
  batch left out of the loss (step 3 of the rules for ``correct``).

A serving cell runs one short window per seed (one burst with the
default ``--seconds``) so it reads as many requests as a run does.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def serve_seed(ctx, cell, seconds: float) -> dict:
    from portbench.reference import checks
    cell.setup()
    cell.window(seconds, False)
    reqs = cell.sample()
    cell.free()
    ref = ctx.family.REFERENCE
    prog = checks.served_gaps(ref, ctx.config, ctx.seed, reqs, ctx.device)
    ctl = checks.control_gaps(ref, ctx.config, ctx.seed, reqs, ctx.device)
    return {"program": {"served_logit_gap": max(prog)},
            "control": {"served_logit_gap": max(ctl)},
            "served_tokens": sum(len(r["served"]) for r in reqs)}


def train_seed(ctx, cell) -> dict:
    from portbench.reference import checks
    from portbench.traffic import train_steps as TS
    cell.setup()
    cell.free()
    opt = ctx.workload["traffic"]["optimizer"]
    batches = [cell.batch_at(k) for k in range(len(cell.losses))]
    args = (ctx.family.REFERENCE, ctx.config, ctx.seed, opt, batches,
            ctx.device)
    ref = checks.train_readings(*args)

    def readings(r):
        return TS.gaps(r["loss"], r["grad1"], r["change"], ref)

    return {"program": readings({"loss": cell.losses, "grad1": cell.grad1,
                                 "change": cell.change}),
            "control": readings(checks.train_readings(*args,
                                                      demote=True)),
            "fault_half": readings(checks.train_readings(*args,
                                                         half=True))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.001)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(
        ROOT, ".portbench_cache", "plans.json")
    import torch
    if not torch.cuda.is_available():
        print("calibration reads the card: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from portbench import harness
    from repro_torch.kernels import ops
    ops.ensure_built()
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.time()
            ctx = harness.make_context(args.workload, seed, "cuda")
            kind = ctx.workload["traffic"]["kind"]
            cell = harness.load_module("traffic", kind).Cell(ctx)
            got = (train_seed(ctx, cell) if kind == "train_steps"
                   else serve_seed(ctx, cell, args.seconds))
            got.update(workload=args.workload, seed=seed,
                       seconds=time.time() - t0)
            line = json.dumps(got)
            print("calibration " + line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
