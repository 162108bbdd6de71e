#!/usr/bin/env python3
"""Time the convert kernel's kept designs (``src/repro_torch/csrc/
convert.cu``) against the designs they were chosen over, on one card:

    python3 convert_designs.py [--out FILE]

The rejected designs are built here, from the source below, which
includes ``convert.cu`` itself (so the class-map kernel is the kept one,
at another chunk count):

- plain cast ``multi U=2`` / ``multi U=4``: U chunks of 8 elements per
  thread and pass, every 16-byte load (``ld.global.nc.L1::no_allocate``)
  issued before the first store, over one wave of blocks (four per SM,
  the SM count read once per device) striding over the array;
- plain cast ``bulk``: each block streams 8 KB chunks of x into a
  four-stage shared-memory ring with Hopper's bulk copy
  (``cp.async.bulk``, completion counted on an mbarrier per stage) and
  converts out of shared memory;
- class-map form ``U=1``: one chunk per thread and a block per 256
  chunks, no striding (the kept form runs U = 4 over one wave).

The kept plain cast runs one chunk per thread, a block per 256 chunks,
cached loads.  Cases: 8192² fp32 to each 8- and 16-bit dtype (beside
``x.to``), and the class-map form at ``chip_smoke.CLASS_TIMES``.  Each
design's output must equal the kept kernel's bit for bit.  Times are
``chip_smoke.event_ms`` held CUDA events (median of 20; the designs run
in order, then reversed: two values each) and ``chip_smoke.device_ms``
profiler device time.  Prints one line per case, the card's name and
power limit, and the rows as one JSON line (``--out`` also writes them).
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

SOURCE = r'''
#include "convert.cu"

namespace {

__device__ __forceinline__ float4 load_no_l1(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

template <int ODT, int UC>
__global__ void __launch_bounds__(NTH) convert_multi_kernel(const float* __restrict__ x,
                                                            void* __restrict__ out, long long n) {
  const long long chunks = n / 8;
  const long long step = static_cast<long long>(gridDim.x) * NTH * UC;
  for (long long base = static_cast<long long>(blockIdx.x) * NTH * UC + threadIdx.x;
       base < chunks; base += step) {
    float v[UC][8];
#pragma unroll
    for (int u = 0; u < UC; ++u) {
      const long long q = base + static_cast<long long>(u) * NTH;
      if (q >= chunks) continue;
      const float4* p = reinterpret_cast<const float4*>(x + q * 8);
      const float4 a = load_no_l1(p), b = load_no_l1(p + 1);
      v[u][0] = a.x, v[u][1] = a.y, v[u][2] = a.z, v[u][3] = a.w;
      v[u][4] = b.x, v[u][5] = b.y, v[u][6] = b.z, v[u][7] = b.w;
    }
#pragma unroll
    for (int u = 0; u < UC; ++u) {
      const long long q = base + static_cast<long long>(u) * NTH;
      if (q < chunks) store8(out, ODT, q * 8, v[u]);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (long long e = chunks * 8; e < n; ++e) store_any(out, ODT, e, x[e]);
}

constexpr int BULK_STAGES = 4;
constexpr int BULK_FLOATS = 2048;   // 8 KB per stage: 8 floats per thread

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Chunk k of the array (BULK_FLOATS elements; the last one may be short,
// its whole 16-byte words by bulk copy and the rest by plain loads) runs
// through stage k % BULK_STAGES of block k % gridDim.x's ring.
template <int ODT>
__global__ void __launch_bounds__(NTH) convert_bulk_kernel(const float* __restrict__ x,
                                                           void* __restrict__ out, long long n) {
  __shared__ __align__(128) float ring[BULK_STAGES][BULK_FLOATS];
  __shared__ __align__(8) unsigned long long bar[BULK_STAGES];
  const long long chunks = (n + BULK_FLOATS - 1) / BULK_FLOATS;
  auto words = [&](long long k) {
    const long long left = n - k * BULK_FLOATS;
    return static_cast<unsigned>((left < BULK_FLOATS ? left : BULK_FLOATS) / 4 * 16);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < BULK_STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&bar[s])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < BULK_STAGES; ++s) {
      const long long k = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (k < chunks && words(k)) bulk_load(ring[s], x + k * BULK_FLOATS, words(k), &bar[s]);
    }
  }
  __syncthreads();
  int it = 0;
  for (long long k = blockIdx.x; k < chunks; k += gridDim.x, ++it) {
    const int s = it % BULK_STAGES;
    const long long e0 = k * BULK_FLOATS;
    const long long left = n - e0;
    const int len = static_cast<int>(left < BULK_FLOATS ? left : BULK_FLOATS);
    const int bulk = static_cast<int>(words(k) / 4);
    if (bulk) bulk_wait(&bar[s], (it / BULK_STAGES) & 1);
    for (int c = threadIdx.x * 8; c < len; c += NTH * 8) {
      float v[8];
      if (c + 8 <= bulk) {
        const float4 a = *reinterpret_cast<const float4*>(&ring[s][c]);
        const float4 b = *reinterpret_cast<const float4*>(&ring[s][c + 4]);
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
        v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
        store8(out, ODT, e0 + c, v);
      } else {
        for (int i = c; i < c + 8 && i < len; ++i)
          store_any(out, ODT, e0 + i, i < bulk ? ring[s][i] : x[e0 + i]);
      }
    }
    __syncthreads();   // every thread is done with stage s
    const long long nk = k + static_cast<long long>(BULK_STAGES) * gridDim.x;
    if (threadIdx.x == 0 && nk < chunks && words(nk)) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bulk_load(ring[s], x + nk * BULK_FLOATS, words(nk), &bar[s]);
    }
  }
}

template <int ODT>
cudaError_t launch_design(int design, const float* x, void* out, long long n, int cap,
                          cudaStream_t st) {
  if (design == 3) {
    const long long need = (n + BULK_FLOATS - 1) / BULK_FLOATS;
    convert_bulk_kernel<ODT><<<static_cast<int>(need < cap ? need : cap), NTH, 0, st>>>(x, out, n);
  } else {
    const int uc = design == 1 ? 2 : 4;
    const long long need = (n / 8 + NTH * uc - 1) / (NTH * uc) + 1;
    const int blocks = static_cast<int>(need < cap ? need : cap);
    if (uc == 2)
      convert_multi_kernel<ODT, 2><<<blocks, NTH, 0, st>>>(x, out, n);
    else
      convert_multi_kernel<ODT, 4><<<blocks, NTH, 0, st>>>(x, out, n);
  }
  return cudaGetLastError();
}

}  // namespace

// design 1: multi U=2, 2: multi U=4, 3: bulk.  Same contract as convert_launch.
extern "C" int design_launch(const void* x, void* out, long long n, int odt, int design,
                             int device, void* stream) {
  if (n < 1 || (reinterpret_cast<unsigned long long>(x) & 15) ||
      (reinterpret_cast<unsigned long long>(out) & 15) || !dtype_ok(odt) || design < 1 ||
      design > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cap = resident_blocks(device);
  if (!cap) return static_cast<int>(cudaErrorInvalidDevice);
  const float* xf = static_cast<const float*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (odt) {
    case DT_F32: e = launch_design<DT_F32>(design, xf, out, n, cap, st); break;
    case DT_BF16: e = launch_design<DT_BF16>(design, xf, out, n, cap, st); break;
    case DT_F16: e = launch_design<DT_F16>(design, xf, out, n, cap, st); break;
    case DT_E4M3: e = launch_design<DT_E4M3>(design, xf, out, n, cap, st); break;
    default: e = launch_design<DT_E5M2>(design, xf, out, n, cap, st); break;
  }
  return static_cast<int>(e);
}

// The class-map form at one chunk per thread, a block per 256 chunks (the
// arguments as convert_by_class_launch takes them, already checked there).
extern "C" int class_u1_launch(const void* x, const ClassArgs* args, int device,
                               void* stream) {
  const ClassArgs a = *args;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long chunks = static_cast<long long>(a.mt) * a.tile * a.nt * a.tile / 8;
  const int blocks = static_cast<int>((chunks + NTH - 1) / NTH);
  const float* xf = static_cast<const float*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(reinterpret_cast<unsigned long long>(x) & 15) && !(a.N % 4))
    convert_class_kernel<true, 1><<<blocks, NTH, 0, st>>>(xf, a);
  else
    convert_class_kernel<false, 1><<<blocks, NTH, 0, st>>>(xf, a);
  return static_cast<int>(cudaGetLastError());
}
'''

#: plain-cast designs: name -> design_launch code (0: the kept kernel)
DESIGNS = {"kept": 0, "multi U=2": 1, "multi U=4": 2, "bulk": 3}
#: profiler name fragment of each design's kernel
KERNEL_NAMES = {"kept": "convert_kernel", "multi U=2": "convert_multi",
                "multi U=4": "convert_multi", "bulk": "convert_bulk",
                "x.to": "elementwise"}


def build(B, CV) -> ctypes.CDLL:
    """Compile SOURCE (and the kept convert library, in parallel) into the
    git-ignored build directory; returns the designs' library."""
    h = hashlib.sha256(SOURCE.encode())
    for f in ("convert.cu", "common.cuh"):
        with open(os.path.join(B.CSRC, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(B.NVCC_FLAGS).encode())
    os.makedirs(B.BUILD_DIR, exist_ok=True)
    base = os.path.join(B.BUILD_DIR, f"convert_designs-{h.hexdigest()[:16]}")
    proc = None
    if not os.path.exists(base + ".so"):
        with open(base + ".cu", "w") as f:
            f.write(SOURCE)
        proc = subprocess.Popen(
            [B.nvcc_path(), *B.NVCC_FLAGS, "-I", B.CSRC, "-o",
             base + ".so.tmp", base + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    CV._lib()
    if proc is not None:
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"convert_designs: nvcc failed\n{out}{err}")
        os.replace(base + ".so.tmp", base + ".so")
    lib = ctypes.CDLL(base + ".so")
    lib.design_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.class_u1_launch.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(CV._ClassArgs),
                                    ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.design_launch, lib.class_u1_launch):
        fn.restype = ctypes.c_int
    return lib


def bits(t):
    import torch
    return t.contiguous().view(-1).view(torch.uint8)


def rounds(S, runs: dict, kernels: dict) -> dict:
    """Held event times of every run in order, then reversed, and each
    one's profiler device time."""
    rows = {k: {"held": [], "lasted": []} for k in runs}
    for name in list(runs) + list(runs)[::-1]:
        ms, lasted = S.event_ms(runs[name], 20)
        rows[name]["held"].append(ms)
        rows[name]["lasted"].append(lasted)
    for name, fn in runs.items():
        rows[name]["device"] = S.device_ms(fn, kernels[name], 20)
    return rows


def main() -> None:
    args = sys.argv[1:]
    out_path = args[args.index("--out") + 1] if "--out" in args else None
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("convert_designs: no CUDA device")
    import chip_smoke as S
    from repro_torch.kernels import _build as B
    from repro_torch.kernels import convert as CV
    lib = build(B, CV)
    dev, stream = 0, torch.cuda.current_stream().cuda_stream

    def design(x, dt, code):
        out = torch.empty(x.shape, dtype=dt, device=x.device)
        B.check_launch("convert design", lib.design_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), B.DTYPE_CODES[dt],
            code, dev, stream))
        return out

    class U1:
        """``convert_by_class``'s library with the U = 1 launch in the
        kept one's place."""
        convert_by_class_launch = lib.class_u1_launch

    def class_u1(xs, cls, fs):
        kept = CV._lib
        CV._lib = lambda: U1
        try:
            return CV.convert_by_class(xs, cls, S.TILE, fs)
        finally:
            CV._lib = kept

    gen = torch.Generator(device="cuda").manual_seed(1234)
    x = torch.randn((S.CONVERT_SIZE, S.CONVERT_SIZE), generator=gen,
                    device="cuda")
    # the odd length runs every tail path
    odd = torch.randn(S.CONVERT_SIZE * 3 + 5, generator=gen, device="cuda")
    result = {}
    for dt in (torch.bfloat16, torch.float16, torch.float8_e4m3fn,
               torch.float8_e5m2):
        for src in (x, odd):
            want = bits(CV.convert(src, dt))
            for name, code in DESIGNS.items():
                if code and not torch.equal(bits(design(src, dt, code)),
                                            want):
                    raise SystemExit(f"convert_designs: {name} -> {dt} "
                                     "differs from the kept kernel")
        runs = {name: (lambda c=code: CV.convert(x, dt) if not c
                       else design(x, dt, c))
                for name, code in DESIGNS.items()}
        runs["x.to"] = lambda: x.to(dt)
        label = f"convert {S.CONVERT_SIZE}^2 fp32 -> {dt}"
        result[label] = rounds(S, runs, KERNEL_NAMES)
    for label, m, n, fkey, hi, q in S.CLASS_TIMES:
        fs, cls = S.class_case(m, n, fkey, hi, q)
        xs = x[:m, :n].contiguous()
        runs = {"kept U=4": lambda: CV.convert_by_class(xs, cls, S.TILE, fs),
                "U=1": lambda: class_u1(xs, cls, fs)}
        for a, b in zip(runs["kept U=4"](), runs["U=1"]()):
            if not torch.equal(bits(a), bits(b)):
                raise SystemExit(f"convert_designs: U=1 differs at {label}")
        result[f"convert_by_class {label} [{fkey}]"] = rounds(
            S, runs, {k: "convert_class_kernel" for k in runs})
        del xs
    for case, rows in result.items():
        cells = "; ".join(
            f"{name} " + " / ".join(f"{v:.4f}" for v in r["held"])
            + f" (device {r['device']:.4f})" for name, r in rows.items())
        print(f"{case}: held ms {cells}")
    card = S.smi_line()
    print(f"card: {card}")
    print(json.dumps({"card": card, "cases": result}))
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": card, "cases": result}, f, indent=1)


if __name__ == "__main__":
    main()
