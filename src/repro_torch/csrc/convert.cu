// Elementwise precision conversion, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/convert.py (convert ->
// pallas_call, body _convert_kernel): x [M, N] fp32 -> out_dtype, the
// paper's datatype-conversion task.  Rounding is the reference's:
// round-to-nearest-even into bf16, fp16, fp8 e4m3 or e5m2; fp16 and e5m2
// overflow to +-inf, e4m3 gives NaN above 464 (common.cuh's store casts,
// never a saturating conversion).
//
// Two entry points:
//   - convert_launch: the plain cast of a flat array;
//   - convert_by_class_launch: the layouts' storage cast (MPMatrix's
//     per-class buffers) in one pass.  Element (r, c) of the padded
//     matrix goes to the buffer of class map[r / t][c / t], cast to that
//     buffer's dtype (a split class takes its split round trip and is
//     stored in fp32); every other buffer gets zero there, and the
//     padding to the tile grid is zero.  It reads x once and writes every
//     buffer in the same pass, where the per-class form read x, a host-
//     expanded class map and one masked copy per class.  Classes whose
//     cast needs a whole tile (per-tile-scaled integers) are not taken.
//
// What bounds both on an H100: one read of 4 bytes and the writes of the
// output dtypes per element, no arithmetic to speak of: bytes (HBM).
//
// Design: a thread converts chunks of 8 elements, two 16-byte loads
// (both issued before any store) and then one 8-byte, 16-byte or two
// 16-byte stores per output buffer; a warp's chunks are contiguous, so
// every access is coalesced.  Stores are plain, so converted panels stay
// in L2 for the GEMM that reads them next.
//   - plain cast: one chunk per thread and as many blocks as chunks need,
//     so each SM keeps many short blocks in flight and overlaps one
//     block's stores with the next one's loads;
//   - class-map form: CLASS_U = 4 chunks per thread and pass (8 loads in
//     flight before the first store, the class map read once per chunk),
//     over a grid of as many blocks as fit on the card at once (the SM
//     count is read once per device), striding over the matrix.
// convert_designs.py times the designs these were chosen over on the card
// (several chunks per thread with loads that bypass L1 over one wave of
// blocks; a bulk-copy ring; the class-map form at one chunk per thread),
// and PERF.md records the times.

#include "common.cuh"

constexpr int CV_MAX_NF = 4;

// The class-map form's arguments (mirrored by kernels/convert.py).
struct ClassArgs {
  void* o[CV_MAX_NF];          // [mt * t, nt * t] buffer per class code
  int odt[CV_MAX_NF];          // buffer dtype codes
  int slices[CV_MAX_NF];       // 1: plain cast; 2 or 3: split round trip
  int sdt[CV_MAX_NF];          // slice dtype code of a split class
  const int* map;              // [mt, nt] class codes
  int nf;
  int M, N;                    // x's (unpadded) shape, row stride N
  int mt, nt, tile;
};

namespace {

constexpr int NTH = 256;       // threads per block
constexpr int CLASS_U = 4;     // chunks of 8 per thread and pass (class-map form)
constexpr int BPS = 4;         // its blocks per SM (64 registers per thread)

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// The plain cast: thread q converts chunk q of the n / 8 whole chunks;
// thread n / 8 the last n % 8 elements.
template <int ODT>
__global__ void __launch_bounds__(NTH) convert_kernel(const float* __restrict__ x,
                                                      void* __restrict__ out, long long n) {
  const long long q = static_cast<long long>(blockIdx.x) * NTH + threadIdx.x;
  if (q < n / 8) {
    float v[8];
    load8(x + q * 8, v);
    store8(out, ODT, q * 8, v);
  } else if (q == n / 8) {
    for (long long e = q * 8; e < n; ++e) store_any(out, ODT, e, x[e]);
  }
}

// The class-map form: chunk q of the padded [mt * t, nt * t] matrix is
// row q / (nt * t / 8), columns 8 * (q % (nt * t / 8)) + 0..7 (t is a
// multiple of 8, so a chunk lies in one tile).  VEC: x is 16-byte aligned
// with N % 4 == 0, so a chunk wholly inside x is two vector loads.  U:
// chunks per thread and pass.
template <bool VEC, int U>
__global__ void __launch_bounds__(NTH, BPS) convert_class_kernel(const float* __restrict__ x,
                                                            const ClassArgs a) {
  const int cpr = a.nt * a.tile / 8;
  const long long chunks = static_cast<long long>(a.mt) * a.tile * cpr;
  const long long step = static_cast<long long>(gridDim.x) * NTH * U;
  const long long ldo = static_cast<long long>(a.nt) * a.tile;
  for (long long base = static_cast<long long>(blockIdx.x) * NTH * U + threadIdx.x;
       base < chunks; base += step) {
    float v[U][8];
    int code[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long q = base + u * NTH;
      code[u] = -1;
      if (q >= chunks) continue;
      const int r = static_cast<int>(q / cpr), c = static_cast<int>(q % cpr) * 8;
      code[u] = __ldg(a.map + (r / a.tile) * a.nt + c / a.tile);
      const float* p = x + static_cast<long long>(r) * a.N + c;
      if (VEC && r < a.M && c + 8 <= a.N) {
        load8(p, v[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[u][i] = (r < a.M && c + i < a.N) ? __ldg(p + i) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long q = base + u * NTH;
      if (q >= chunks) continue;
      const long long o = (q / cpr) * ldo + (q % cpr) * 8;
      const float zero[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
      for (int f = 0; f < a.nf; ++f) {
        if (f != code[u]) {
          store8(a.o[f], a.odt[f], o, zero);
        } else if (a.slices[f] > 1) {
          float w[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) w[i] = roundtrip_any(v[u][i], a.slices[f], a.sdt[f]);
          store8(a.o[f], a.odt[f], o, w);
        } else {
          store8(a.o[f], a.odt[f], o, v[u]);
        }
      }
    }
  }
}

// Blocks that fit on device `dev` at once (BPS per SM); the SM count is
// read once per device.
int resident_blocks(int dev) {
  static int sms[64] = {0};
  if (dev < 0 || dev >= 64) return 0;
  if (!sms[dev] &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return BPS * sms[dev];
}

// Make `dev` current if it is not (the stream belongs to it).
cudaError_t use_device(int dev) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess || cur == dev) return e;
  return cudaSetDevice(dev);
}

bool dtype_ok(int dt) { return dt >= DT_F32 && dt <= DT_E5M2; }

}  // namespace

// Launch the plain cast on `stream`; returns the cudaError_t of the
// launch (0 = ok).  `x` is fp32 with 16-byte alignment, `n` its element
// count, `out` 16-byte aligned.
extern "C" int convert_launch(const void* x, void* out, long long n, int odt,
                              int device, void* stream) {
  if (n < 1 || (reinterpret_cast<unsigned long long>(x) & 15) ||
      (reinterpret_cast<unsigned long long>(out) & 15) || !dtype_ok(odt))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int blocks = static_cast<int>((n / 8 + 1 + NTH - 1) / NTH);
#define CV_LAUNCH(D) convert_kernel<D><<<blocks, NTH, 0, st>>>(xf, out, n)
  switch (odt) {
    case DT_F32: CV_LAUNCH(DT_F32); break;
    case DT_BF16: CV_LAUNCH(DT_BF16); break;
    case DT_F16: CV_LAUNCH(DT_F16); break;
    case DT_E4M3: CV_LAUNCH(DT_E4M3); break;
    default: CV_LAUNCH(DT_E5M2); break;
  }
#undef CV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// Launch the class-map form on `stream`; returns the cudaError_t of the
// launch (0 = ok).  `x` is fp32 [M, N] (row stride N), every a->o[f] a
// 16-byte aligned [mt * t, nt * t] buffer of dtype a->odt[f], t a
// multiple of 8, and the map covers x.
extern "C" int convert_by_class_launch(const void* x, const ClassArgs* args, int device,
                                       void* stream) {
  const ClassArgs a = *args;
  if (a.nf < 1 || a.nf > CV_MAX_NF || a.tile < 8 || a.tile % 8 || a.M < 1 || a.N < 1 ||
      static_cast<long long>(a.mt) * a.tile < a.M || static_cast<long long>(a.nt) * a.tile < a.N)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int f = 0; f < a.nf; ++f) {
    if (!dtype_ok(a.odt[f]) || (reinterpret_cast<unsigned long long>(a.o[f]) & 15))
      return static_cast<int>(cudaErrorInvalidValue);
    if (a.slices[f] != 1 &&
        (a.slices[f] < 2 || a.slices[f] > 3 || a.odt[f] != DT_F32 ||
         (a.sdt[f] != DT_F16 && a.sdt[f] != DT_E5M2)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cap = resident_blocks(device);
  if (!cap) return static_cast<int>(cudaErrorInvalidDevice);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const long long chunks = static_cast<long long>(a.mt) * a.tile * a.nt * a.tile / 8;
  const long long need = (chunks + NTH * CLASS_U - 1) / (NTH * CLASS_U);
  const int blocks = static_cast<int>(need < cap ? need : cap);
  const bool vec = !(reinterpret_cast<unsigned long long>(x) & 15) && !(a.N % 4);
  if (vec)
    convert_class_kernel<true, CLASS_U><<<blocks, NTH, 0, st>>>(xf, a);
  else
    convert_class_kernel<false, CLASS_U><<<blocks, NTH, 0, st>>>(xf, a);
  return static_cast<int>(cudaGetLastError());
}
