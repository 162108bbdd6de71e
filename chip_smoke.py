#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases (each raises on failure, so a failing run never exits 0):

1. print the card (``nvidia-smi`` name and power limit) and build both CUDA
   kernels from ``src/repro_torch/csrc`` (nvcc in parallel);
2. hold each kernel to its plain PyTorch version on the card: the ksplit
   kernel at the served InternLM2-1.8B shapes (m = 1 and 4) and at
   m = 4096, the tile kernel at M = N = K = 1024 and 4096, t = 128, over
   four class mixes and one integer-class format set;
3. ``mp_matmul`` at 1024³ through dispatch: the plan must be ``tile``, the
   tile kernel must launch, and the result must sit inside the
   registry-derived error bounds against numpy fp64;
4. serve InternLM2-1.8B at full width (random weights from a seeded
   ``torch.Generator``): 8 requests, 16 greedy tokens each, batched tokens
   equal to the unbatched reference, no fresh plan resolution after
   warmup, every KSplit linear on the ksplit kernel;
   A profiled decode step then shows where its time goes (wall vs device
   busy time, top kernels by device time);
5. time each kernel (CUDA events, median) beside its bound, its plain
   version and ``torch.matmul`` at the same shape.

The second-to-last lines are a JSON object ``{"kernels": [...]}`` and the
card's ``name, power.limit``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
there is no CUDA device or the package is not next to this script.
It imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet), the denominators of
#: every bound below: HBM3 bytes/s, dense bf16 FLOP/s, fp32 (non-tensor)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

#: served ksplit shapes (K, N) of InternLM2-1.8B on one card: wq, wk/wv,
#: up/gate, lm_head; the large-M ksplit check; the tile-kernel checks
SERVED_KN = ((2048, 2048), (2048, 1024), (2048, 8192), (2048, 92544))
KSPLIT_BIG = (4096, 2048, 8192)
TILE_SIZES = (1024, 4096)
TILE = 128
DEVICE = "cuda"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def peak_for(dtype) -> float:
    import torch
    return PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS


def time_ms(fn, iters: int = 20, flush=None) -> float:
    """Median of per-launch CUDA-event times (warm-up first; ``flush``
    runs between launches, outside the timed span)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def ksplit_case(m, k, n, gen, policy):
    """A KSplitWeight [k, n] under ``policy`` (InternLM2's default map)
    and bf16 activations [m, k]."""
    import torch
    from repro_torch.core.formats import DEFAULT_FORMATS as FS
    from repro_torch.core.layout import KSplitWeight
    from repro_torch.core.linear import split_cls
    w = torch.randn((k, n), generator=gen, device=DEVICE) / k ** 0.5
    ws = KSplitWeight.from_dense(w, split_cls(k // TILE, policy, fset=FS),
                                 TILE, FS)
    x = torch.randn((m, k), generator=gen, device=DEVICE).to(torch.bfloat16)
    return x, ws


def ksplit_within(x, ws, y_kernel, y_plain) -> tuple[float, float]:
    """(max |kernel - plain|, worst ratio to the summation-order bound
    ``ksplit_gemm.order_bound``)."""
    from repro_torch.kernels import ksplit_gemm as K
    fs = ws.fset
    bound = K.order_bound(x, [ws.bufs[c] for c in fs.class_order],
                          [fs.fmt(c) for c in fs.class_order])
    err = (y_kernel - y_plain).abs()
    return float(err.max()), float((err / (bound + 1e-30)).max())


def check_ksplit(gen, policy) -> dict:
    import torch
    from repro_torch.kernels import ksplit_gemm as K
    from repro_torch.kernels import ops
    out = {}
    for m in (1, 4):
        for k, n in SERVED_KN:
            x, ws = ksplit_case(4, k, n, gen, policy)
            y4 = ops.ksplit_matmul_kernel(x, ws)
            y = ops.ksplit_matmul_kernel(x[:m].contiguous(), ws)
            fs = ws.fset
            yp = K.ksplit_gemm_plain(
                x[:m], [ws.bufs[c] for c in fs.class_order],
                [fs.fmt(c) for c in fs.class_order])
            sync()
            err, ratio = ksplit_within(x[:m], ws, y, yp)
            if not torch.equal(y, y4[:m]):
                fail(f"ksplit m={m} k={k} n={n}: rows differ from the m=4 "
                     "launch (batch invariance)")
            print(f"ksplit m={m} K={k} N={n}: max|kernel-plain| {err:.3e}, "
                  f"worst/bound {ratio:.3e} (bound 2*K*2^-24*sum|x*w|), "
                  "rows bitwise equal to the m=4 launch")
            if not ratio <= 1.0:
                fail(f"ksplit m={m} K={k} N={n} outside tolerance")
            out[(m, k, n)] = err
    mb, kb, nb = KSPLIT_BIG
    x, ws = ksplit_case(mb, kb, nb, gen, policy)
    y = ops.ksplit_matmul_kernel(x, ws)
    y4 = ops.ksplit_matmul_kernel(x[:4].contiguous(), ws)
    fs = ws.fset
    yp = K.ksplit_gemm_plain(x, [ws.bufs[c] for c in fs.class_order],
                             [fs.fmt(c) for c in fs.class_order])
    sync()
    err, ratio = ksplit_within(x, ws, y, yp)
    if not torch.equal(y[:4], y4):
        fail(f"ksplit m={mb}: first rows differ from the m=4 launch")
    print(f"ksplit m={mb} K={kb} N={nb}: max|kernel-plain| {err:.3e}, "
          f"worst/bound {ratio:.3e}, rows 0-3 bitwise equal to m=4")
    if not ratio <= 1.0:
        fail(f"ksplit m={mb} outside tolerance")
    out[KSPLIT_BIG] = err
    return out


TILE_MIXES = (
    # (label, format-set key, ratio_high, ratio_low8) of every map
    ("0D100S", "fp8_e4m3+bf16+fp32", 0.0, 0.0),
    ("50D50S", "fp8_e4m3+bf16+fp32", 0.5, 0.0),
    ("100D0S", "fp8_e4m3+bf16+fp32", 1.0, 0.0),
    ("40D40S20Q", "fp8_e4m3+bf16+fp32", 0.4, 0.2),
    ("40D40S20Q-int8", "int8_pt+bf16+fp32", 0.4, 0.2),
)


def tile_case(size, t, fkey, hi, q, gen, seed0=1):
    import torch
    from repro_torch.core.formats import FormatSet
    from repro_torch.core.layout import MPMatrix
    from repro_torch.core.precision import Policy, make_map
    fs = FormatSet.from_key(fkey)
    mats, maps = [], []
    for s in range(3):
        v = torch.randn((size, size), generator=gen, device=DEVICE)
        p = make_map((size, size), t, Policy("ratio", hi, q, seed=seed0 + s),
                     fset=fs)
        mats.append(MPMatrix.from_dense(v, p, t, fs))
        maps.append(p)
    return fs, mats, maps


def check_tile(gen) -> dict:
    import torch
    from repro_torch.kernels import mp_gemm_tile as MT
    out = {}
    alpha, beta = 1.5, 0.5
    for size in TILE_SIZES:
        for label, fkey, hi, q in TILE_MIXES:
            fs, (A, B, C), maps = tile_case(size, TILE, fkey, hi, q, gen)
            specs = MT.format_specs(fs)
            ok = MT.mp_gemm_tile_multi(A.bufs, B.bufs, C.bufs, *maps,
                                       tile=TILE, specs=specs, alpha=alpha,
                                       beta=beta)
            op = MT.mp_gemm_tile_plain(A.bufs, B.bufs, C.bufs, *maps,
                                       tile=TILE, specs=specs, alpha=alpha,
                                       beta=beta)
            sync()
            dk = sum(o.float() for o in ok)
            dp = sum(o.float() for o in op)
            allow = MT.order_allowance(A.bufs, B.bufs, C.bufs, maps[2], dp,
                                       tile=TILE, specs=specs, alpha=alpha,
                                       beta=beta)
            err, ratio = MT.within(dk, dp, allow)
            print(f"tile {size}^3 t={TILE} {label} [{fkey}]: "
                  f"max|kernel-plain| {err:.3e}, worst/allowance "
                  f"{ratio:.3e} (2*K*2^-24*(|a||A||B|+|b||C|) + one output "
                  "rounding or quantization step)")
            if not ratio <= 1.0:
                fail(f"tile {size} {label} outside tolerance")
            out[(size, label)] = err
            del A, B, C, ok, op, dk, dp, allow
    return out


# ---------------------------------------------------------------------------
# phase 3: mp_matmul through dispatch
# ---------------------------------------------------------------------------

def check_mp_matmul(gen) -> dict:
    import torch
    from repro_torch.core.accuracy import check_against_fp64
    from repro_torch.core.formats import DEFAULT_FORMATS as FS
    from repro_torch.core.layout import MPMatrix
    from repro_torch.core.precision import Policy, make_map
    from repro_torch.kernels import ops
    from repro_torch.tune import dispatch as D
    n, t = TILE_SIZES[0], TILE
    dense = [torch.randn((n, n), generator=gen, device=DEVICE)
             for _ in range(3)]
    maps = [make_map((n, n), t, Policy("ratio", 0.4, 0.2, seed=s), fset=FS)
            for s in (11, 12, 13)]
    A, B, C = (MPMatrix.from_dense(d, p, t, FS) for d, p in zip(dense, maps))
    prob = D.problem_of(A, B, C, beta=0.5)
    plan, _ = D.resolve_plan(prob, D.detect_device(A.device))
    if plan.path != "tile":
        fail(f"mp_matmul resolved {plan.path!r}, not 'tile'")
    ops.reset_launch_counts()
    out = D.mp_matmul(A, B, C, beta=0.5)
    sync()
    launches = ops.launch_counts()["mp_gemm_tile"]
    if launches < 1:
        fail("mp_matmul did not launch the tile kernel")
    rep = check_against_fp64(out.to_dense().cpu().numpy(),
                             dense[0].cpu().numpy(), dense[1].cpu().numpy(),
                             dense[2].cpu().numpy(), *maps, t, FS, beta=0.5)
    print(f"mp_matmul {n}^3 plan={plan.key()} tile launches={launches} "
          f"fp64 worst/bound per C class {rep['worst_ratio']}")
    if not rep["ok"]:
        fail(f"mp_matmul outside the fp64 error bounds: {rep}")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 4: serve InternLM2-1.8B at full width
# ---------------------------------------------------------------------------

def serve(cfg, seed: int = 0) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, Request, ServeConfig
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = T.init_model(gen, cfg)
    sync()
    init_s = time.perf_counter() - t0
    eng = Engine(cfg, params, ServeConfig(
        max_batch=4, max_seq=256, refill=False, prefix_cache=False,
        chunked_prefill=False))
    eng.warmup()
    rng = np.random.default_rng(seed)
    lens = np.linspace(8, 96, 8).astype(int)
    prompts = [rng.integers(0, cfg.vocab, L).astype(np.int64) for L in lens]
    reqs = [Request(p, max_new_tokens=16) for p in prompts]
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    eng.generate(reqs)
    sync()
    serve_s = time.perf_counter() - t1
    launches = ops.launch_counts()
    st = eng.stats()
    refs = eng.generate_reference([Request(p, max_new_tokens=16)
                                   for p in prompts])
    bad = [i for i, (r, f) in enumerate(zip(reqs, refs))
           if not r.done or r.out_tokens != f.out_tokens]
    lin = st["linear_dispatch_since_warmup"]
    fresh = st["plans"]["post_warmup_fresh_resolutions"]
    gen_toks = st["tokens"]["generated"]
    print(f"serve {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
          f"vocab={cfg.vocab}, weights {param_bytes(params) / 1e9:.3f} GB, "
          f"init {init_s:.2f} s")
    print(f"serve: {len(reqs)} requests (prompts {[int(v) for v in lens]}), "
          f"{gen_toks} tokens in {serve_s:.3f} s = {gen_toks / serve_s:.2f} "
          f"tokens/s; microbatches {st['microbatches']}; prefill steps "
          f"{st['prefill_steps']}, decode steps {st['decode_steps']}")
    print(f"serve: kernel launches {launches}; linear dispatch since "
          f"warmup {lin}; post-warmup fresh resolutions {fresh}")
    print(f"serve: batched tokens == unbatched reference for "
          f"{len(reqs) - len(bad)}/{len(reqs)} requests")
    if bad:
        fail(f"batched tokens differ from the reference for requests {bad}")
    if fresh != 0:
        fail(f"{fresh} fresh plan resolutions after warmup")
    if launches["ksplit_gemm"] < 1:
        fail("serving never launched the ksplit kernel")
    if lin.get("ksplit_torch", 0) != 0:
        fail(f"{lin['ksplit_torch']} KSplit linears ran off the kernel")
    for r in reqs:
        if len(r.out_tokens) != 16 or not all(
                0 <= tok < cfg.vocab for tok in r.out_tokens):
            fail("malformed output tokens")
    steps = st["prefill_steps"] + st["decode_steps"]
    prof = profile_decode(cfg, params)
    return {"launches": launches["ksplit_gemm"], "tokens_per_s":
            gen_toks / serve_s, "launches_per_step":
            launches["ksplit_gemm"] / max(1, steps), **prof}


def profile_decode(cfg, params, steps: int = 5) -> dict:
    """Where a decode step's time goes: wall time per step (host clock
    around synchronized steps) and, under ``torch.profiler``, the device
    time per step by kernel name.  The device's idle share is 1 - busy /
    wall (the profiler's own overhead is kept out of the wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    B = 4
    tok = torch.zeros((B, 1), dtype=torch.int64, device=DEVICE)
    caches = T.init_cache(cfg, B, 256, DEVICE)
    T.forward_decode(params, cfg, tok, caches, 0)
    sync()
    t0 = time.perf_counter()
    for s in range(steps):
        T.forward_decode(params, cfg, tok, caches, 1 + s)
    sync()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in range(steps):
            T.forward_decode(params, cfg, tok, caches, 1 + s)
        sync()
    # kernel rows only: a CPU op's row repeats its kernels' device time
    rows = [(e.key, e.self_device_time_total / steps / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms in rows)
    if not busy_ms:
        print(f"profile decode step (batch {B}): wall {wall_ms:.2f} ms; "
              "the profiler saw no device time: busy share not measured")
        return {"wall_ms": wall_ms, "busy_ms": None}
    print(f"profile decode step (batch {B}): wall {wall_ms:.2f} ms, device "
          f"busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.1%}")
    for name, ms in rows[:8]:
        print(f"profile   {ms:8.3f} ms/step  {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


def param_bytes(params) -> int:
    from repro_torch.core.linear import MPLinear
    total = 0

    def visit(node):
        nonlocal total
        if isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)
        elif isinstance(node, MPLinear):
            total += sum(b.numel() * b.element_size() for b in node.w.bufs)
        else:
            total += node.numel() * node.element_size()
    visit(params)
    return total


# ---------------------------------------------------------------------------
# phase 5: timings beside bounds
# ---------------------------------------------------------------------------

def time_ksplit(gen, policy) -> list[dict]:
    import torch
    from repro_torch.kernels import ksplit_gemm as K
    from repro_torch.kernels import ops
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=DEVICE)
    flush = lambda: flush_buf.zero_()   # noqa: E731  (evict the 50 MB L2)
    rows = []
    for m, k, n in [(4, k, n) for k, n in SERVED_KN] + [(1, 2048, 8192)]:
        x, ws = ksplit_case(m, k, n, gen, policy)
        fs = ws.fset
        bufs = [ws.bufs[c] for c in fs.class_order]
        fmts = [fs.fmt(c) for c in fs.class_order]
        ms = time_ms(lambda: ops.ksplit_matmul_kernel(x, ws), flush=flush)
        plain_ms = time_ms(lambda: K.ksplit_gemm_plain(x, bufs, fmts),
                           iters=5, flush=flush)
        wb = torch.randn((k, n), generator=gen, device=DEVICE).to(
            torch.bfloat16)
        lib_ms = time_ms(lambda: torch.matmul(x, wb), flush=flush)
        nbytes = (x.numel() * x.element_size()
                  + sum(b.numel() * b.element_size() for b in bufs)
                  + m * n * 4)
        ops_s = sum(2.0 * m * n * b.shape[0] / peak_for(f.compute_dtype)
                    for b, f in zip(bufs, fmts))
        bound_ms = max(nbytes / PEAK_BYTES_S, ops_s) * 1e3
        by = "bytes" if nbytes / PEAK_BYTES_S >= ops_s else "operations"
        print(f"time ksplit m={m} K={k} N={n}: kernel {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB), plain "
              f"{plain_ms:.4f} ms, torch.matmul bf16 {lib_ms:.4f} ms")
        rows.append({"m": m, "k": k, "n": n, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": by,
                     "library_ms": lib_ms})
        del x, ws, bufs, wb
    return rows


def time_tile(gen) -> dict:
    import torch
    from repro_torch.core.precision import map_storage_bytes
    from repro_torch.kernels import mp_gemm_tile as MT
    size, t = TILE_SIZES[-1], TILE
    fs, (A, B, C), maps = tile_case(size, t, "fp8_e4m3+bf16+fp32", 0.5, 0.0,
                                    gen, seed0=21)
    specs = MT.format_specs(fs)
    run = lambda: MT.mp_gemm_tile_multi(   # noqa: E731
        A.bufs, B.bufs, C.bufs, *maps, tile=t, specs=specs)
    ms = time_ms(run, iters=10)
    plain_ms = time_ms(lambda: MT.mp_gemm_tile_plain(
        A.bufs, B.bufs, C.bufs, *maps, tile=t, specs=specs), iters=5)
    a16 = A.to_dense().to(torch.bfloat16)
    b16 = B.to_dense().to(torch.bfloat16)
    lib_ms = time_ms(lambda: torch.matmul(a16, b16), iters=10)
    pc = maps[2]
    nbytes = (sum(map_storage_bytes(p, t, fs) for p in maps)
              + sum(size * size * torch.empty((), dtype=s[1]).element_size()
                    for s in specs))
    ops_s = sum(2.0 * int((pc == c).sum()) * t * t * size
                / peak_for(fs.fmt(int(c)).compute_dtype)
                for c in np.unique(pc))
    bound_ms = max(nbytes / PEAK_BYTES_S, ops_s) * 1e3
    by = "bytes" if nbytes / PEAK_BYTES_S >= ops_s else "operations"
    print(f"time tile {size}^3 t={t} 50D50S: kernel {ms:.3f} ms "
          f"({2 * size ** 3 / ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.3f} "
          f"ms ({by}), plain {plain_ms:.3f} ms, torch.matmul bf16 "
          f"{lib_ms:.3f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": lib_ms}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA card")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.kernels import _build, ops
        from repro_torch.core.precision import Policy
    except ImportError as e:
        fail(f"the repro_torch package is not next to this script ({e})")
    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the port imported jax or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = smi_line()
    print(f"card: {smi}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    ops.ensure_built()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, in parallel)")
    for name, info in _build.BUILD_INFO.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build {name}: " + " | ".join(regs[:8]))

    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    policy = Policy(kind="ratio", ratio_high=0.5)   # InternLM2's default
    ks_err = check_ksplit(gen, policy)
    tile_err = check_tile(gen)
    mm = check_mp_matmul(gen)
    from repro_torch.configs import get
    cfg = get("internlm2-1.8b")
    sv = serve(cfg)
    ks_rows = time_ksplit(gen, policy)
    tl = time_tile(gen)

    main_row = next(r for r in ks_rows if (r["m"], r["n"]) == (4, 8192))
    kernels = [
        {"name": "ksplit_gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/ksplit_gemm.cu",
         "replaces": "src/repro/kernels/ksplit_gemm.py:97",
         "launches": sv["launches"],
         "max_abs_err": max(ks_err.values()),
         "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
         "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
         "library_ms": main_row["library_ms"]},
        {"name": "mp_gemm_tile", "route": "cuda",
         "source": "src/repro_torch/csrc/mp_gemm_tile.cu",
         "replaces": "src/repro/kernels/mp_gemm_tile.py:121",
         "launches": mm["launches"],
         "max_abs_err": max(tile_err.values()),
         "ms": tl["ms"], "plain_ms": tl["plain_ms"],
         "bound_ms": tl["bound_ms"], "bound_by": tl["bound_by"],
         "library_ms": tl["library_ms"]},
    ]
    print(f"serve tokens/s {sv['tokens_per_s']:.2f}; ksplit launches per "
          f"model step {sv['launches_per_step']:.1f}; total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
