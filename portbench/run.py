"""Run one cell of the port's benchmark once, on an NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  In order: build or reuse the port's
kernels (``src/repro_torch/kernels/_build/``), make the weights and
inputs from ``--seed``, warm the cell's own shapes, measure for
``--seconds``, compare what the timed path produced with the plain
reference, and print one JSON line last: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` (and ``breakdown`` when
traced), then ``checks``: each number compared beside its limit, also
printed as the last lines on standard error.

Exits non-zero, printing no result, without a card (it never falls back
to the CPU), with fewer cards than the cell asks for, for an unknown
cell, or when the process has loaded ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro``.  Caches of the program live at fixed paths
inside the checkout (``.portbench_cache/``).
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
CACHE = os.path.join(ROOT, ".portbench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness
    bench = harness.load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(CACHE, "plans.json")
    os.environ["USE_FLAX"] = "0"
    import torch
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 3
    # one process drives the card; its host work is small tensors and
    # Python, which a pool of CPU threads only makes jitter
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.zeros(1, device="cuda")
    t0 = time.time()
    print(f"set-up: torch imported and the card's context made "
          f"{t0 - T_START:.4f} s after start", flush=True)
    from repro_torch.kernels import ops
    ops.ensure_built()
    print(f"set-up: kernels ready in {time.time() - t0:.4f} s", flush=True)
    line, errors = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), t_start=T_START,
                                    bench=bench)
    bad = harness.banned_modules()
    if bad:
        print(f"the run loaded {bad}: no result", file=sys.stderr)
        return 4
    print(line, flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
