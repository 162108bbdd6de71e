#!/usr/bin/env python3
"""Time the ksplit, split, tile and convert kernels of two or more
checkouts of the port on one card, by the same methods in all:

    python3 kernel_ab.py PARENT_DIR CHANGE_DIR [MORE_DIRS ...] [--out FILE]

Runs the trees in order and then in reverse (PARENT, CHANGE, CHANGE,
PARENT for two), each in a process of its own (``python3 kernel_ab.py
--worker DIR``) that imports ``repro_torch`` from ``DIR/src`` (building
its kernels there) and takes the cases and timers from the
``chip_smoke.py`` beside this script, so every checkout sees the same
inputs (one seeded generator) and the same clocks:

- ``held``: CUDA events with the stream held while the call is enqueued
  (``chip_smoke.event_ms``); ``held_lasted`` is the share of calls whose
  hold lasted (0 where the wrapper waits on the stream: the time then
  holds host work);
- ``unheld``: CUDA events without the hold (the host time the call spends
  after the first event falls inside the span);
- ``device``: the kernels' own time per call from ``torch.profiler``;
- ``host_us``: the ksplit wrapper's host time per call, launches queued
  back to back, and where the checkout caches argument blocks
  (``ksplit_gemm._templates``) also with that cache emptied before every
  call.

- ``host_clock``: the host's time per call followed by a device sync
  (the convert cases).

The convert cases: the plain form 8192² fp32 -> bf16 and -> e4m3, and
the storage cast of ``chip_smoke.CLASS_TIMES`` (the solve's 8064²
uniform-HIGH C, an 8192² operand under 5D95S) as ``MPMatrix.from_dense``
runs it: the class-map form where the checkout has one, else the
per-class chain; their ``device`` sums every kernel and copy.

Each kernel output's SHA-256 (prefix) shows whether the checkouts give
the same bits.  Prints one JSON line per run, a summary
per case, and the card's name and power limit; ``--out`` also writes the
runs as JSON.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: ksplit cases (m, K, N): the served InternLM2-1.8B shapes at batch 4,
#: and up/gate at batch 1
KSPLIT_CASES = ((4, 2048, 1024), (4, 2048, 2048), (4, 2048, 8192),
                (4, 2048, 92544), (1, 2048, 8192))
#: GEMM cases (label, kernel, format-set key, ratio_high, seed), 4096³
#: at t = 128: chip_smoke.py's kernels-line rows of the split, tile and
#: grouped kernels, and the tile and grouped kernels under 50D50S (both
#: of the staged dot's paths in one launch)
GEMM_CASES = (("split 4096^3 split2 50D50S", "split",
               "fp8_e4m3+bf16+split2_fp16", 0.5, 51),
              ("tile 4096^3 0D100S", "tile", "fp8_e4m3+bf16+fp32", 0.0, 21),
              ("tile 4096^3 50D50S", "tile", "fp8_e4m3+bf16+fp32", 0.5, 22),
              ("grouped 4096^3 0D100S", "grouped", "fp8_e4m3+bf16+fp32",
               0.0, 21),
              ("grouped 4096^3 50D50S", "grouped", "fp8_e4m3+bf16+fp32",
               0.5, 22))
#: host-time runs: repeats of CALLS back-to-back calls
HOST_REPEATS, HOST_CALLS = 5, 200


def host_us(fn) -> float:
    """Median over HOST_REPEATS of the host's time per call of ``fn``
    over HOST_CALLS calls queued back to back."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(HOST_REPEATS):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        runs.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return float(np.median(runs))


def timed(S, fn, kernel: str, iters: int, flush=None) -> dict:
    held, lasted = S.event_ms(fn, iters, flush)
    unheld, _ = S.event_ms(fn, iters, flush, hold=False)
    return {"held": held, "held_lasted": lasted, "unheld": unheld,
            "device": S.device_ms(fn, kernel, iters, flush)}


def sha(t) -> str:
    import torch
    torch.cuda.synchronize()
    return hashlib.sha256(t.cpu().contiguous().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()[:16]


def worker(tree: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as S
    from repro_torch.core.layout import CompactMPMatrix, MPMatrix
    from repro_torch.core.precision import Policy
    from repro_torch.kernels import convert as CV
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.kernels import ksplit_gemm as K
    from repro_torch.kernels import mp_gemm_tile as MT
    from repro_torch.kernels import ops
    from repro_torch.kernels import split_gemm as SG
    from repro_torch.split import split_format_specs
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ops.ensure_built()
    out = {"tree": tree, "build_s": time.perf_counter() - t0, "cases": {}}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    policy = Policy(kind="ratio", ratio_high=0.5)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    for m, k, n in KSPLIT_CASES:
        x, ws = S.ksplit_case(m, k, n, gen, policy)
        run = lambda: ops.ksplit_matmul_kernel(x, ws)  # noqa: E731
        row = timed(S, run, "ksplit", 20, flush)
        y = run()
        torch.cuda.synchronize()
        row["sha256"] = hashlib.sha256(
            y.cpu().numpy().tobytes()).hexdigest()[:16]
        row["host_us"] = host_us(run)
        if hasattr(K, "_templates"):
            def emptied():
                K._templates.clear()
                return run()
            row["host_us_cache_emptied"] = host_us(emptied)
        out["cases"][f"ksplit m={m} K={k} N={n}"] = row
        del x, ws
    for label, kern, fkey, hi, seed in GEMM_CASES:
        fs, (A, B, C), maps = S.gemm_case(4096, 4096, 4096, 128, fkey, hi,
                                          0.0, gen, seed0=seed)
        if kern == "split":
            specs = split_format_specs(fs)
            run = lambda: SG.split_gemm_tile_multi(  # noqa: E731
                A.bufs, B.bufs, C.bufs, *maps, tile=128, specs=specs)
            name = "split_"
        elif kern == "grouped":
            ac = CompactMPMatrix.from_dense(A.to_dense(), A.cls, 128, fs)
            bc = CompactMPMatrix.from_dense(B.to_dense(), B.cls, 128, fs)
            run = lambda: GG.grouped_mp_gemm(  # noqa: E731
                ac, bc, C.cls).tiles
            name = "grouped_gemm"
        else:
            specs = MT.format_specs(fs)
            run = lambda: MT.mp_gemm_tile_multi(  # noqa: E731
                A.bufs, B.bufs, C.bufs, *maps, tile=128, specs=specs)
            name = "mp_gemm_tile"
        row = timed(S, run, name, 10)
        row["sha256"] = sha(torch.cat([o.float().view(-1) for o in run()]))
        out["cases"][label] = row
        del A, B, C
    x = torch.randn((S.CONVERT_SIZE, S.CONVERT_SIZE), generator=gen,
                    device="cuda")
    for dt in (torch.bfloat16, torch.float8_e4m3fn):
        run = lambda: CV.convert(x, dt)  # noqa: E731
        row = timed(S, run, "convert", 20)
        row["sha256"] = sha(run())
        out["cases"][f"convert {S.CONVERT_SIZE}^2 -> {dt}"] = row
    for label, m, n, fkey, hi, q in S.CLASS_TIMES:
        fs, cls = S.class_case(m, n, fkey, hi, q)
        xs = x[:m, :n].contiguous()
        run = lambda: MPMatrix.from_dense(xs, cls, S.TILE, fs)  # noqa: E731
        row = timed(S, run, "", 10)
        row["host_clock"] = S.host_clock_ms(run)
        row["form"] = ("class map" if hasattr(CV, "convert_by_class")
                       else "per-class chain")
        row["sha256"] = sha(torch.cat([b.float().view(-1)
                                       for b in run().bufs]))
        out["cases"][f"from_dense {label}"] = row
        del xs
    return out


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--worker"]:
        print(json.dumps(worker(args[1])))
        return
    out_path = None
    if "--out" in args:
        i = args.index("--out")
        out_path = args[i + 1]
        del args[i:i + 2]
    runs = []
    order = args + args[::-1]
    for tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", tree], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"kernel_ab: the run of {tree} failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    for case in runs[0]["cases"]:
        for k, who in enumerate(args):
            rows = [runs[k]["cases"][case],
                    runs[len(order) - 1 - k]["cases"][case]]
            keys = list(rows[0])
            cells = ", ".join(
                f"{key} " + " / ".join(
                    str(r[key]) if isinstance(r[key], str)
                    else f"{r[key]:.4f}" for r in rows) for key in keys)
            print(f"{case} {who}: {cells}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": smi, "order": order, "runs": runs}, f,
                      indent=1)


if __name__ == "__main__":
    main()
