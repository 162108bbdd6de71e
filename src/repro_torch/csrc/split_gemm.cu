// Split-accumulation tile-centric GEMM, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/split_gemm.py
// (split_gemm_tile_multi -> pallas_call, body _kernel, dot _spec_dot):
//
//     C <- alpha * A . B + beta * C
//
// over per-format buffers (MPMatrix.bufs) and tile class maps, like the
// tile kernel (csrc/mp_gemm_tile.cu), plus split compound C classes: for
// a C tile whose format is a split format (split2_fp16, split3_e5m2) each
// k tile's fp32 A and B tiles are split into `slices` slices (slice i is
// the slice-dtype rounding of the residual left by slices 0..i-1, as
// repro.core.formats.split_slices), the slices^2 pair dots are computed
// as separate t-long fp32 sums, added in slice_pair_order (the order
// comes from the host), and only then added to the accumulator — the
// reference's order per k tile.  Simple classes (slices = 1) take the
// tile kernel's dot.  The store writes a split class's split round trip,
// an integer class's per-tile absmax quantize-dequantize, and zeros into
// every other class's buffer.
//
// What bounds it on an H100: a split2 C tile does 4x, a split3 tile 9x
// the multiply-adds of a plain tile, all on the fp32 pipes here (every
// pair product of fp16 or e5m2 slices is exact in fp32); at 4096^3 that
// is far above the ridge point, so it is bound by operations.
//
// Design: one block per C tile, a 32 x 32 thread grid (at t >= 32) with
// the accumulator in registers, looping over k tiles (the TPU's
// sequential k grid axis).  A split k tile stages all slices of its A and
// B tiles in dynamic shared memory in their slice dtype (fp16 bits or
// e5m2 bytes: 2 x 2 x 32 KiB for split2 at t = 128, 2 x 3 x 16 KiB for
// split3), so each pair dot reads its slices from shared memory without
// re-staging; a thread keeps three register tiles (the accumulator, the
// k tile's pair sum and the current pair's dot).  tensor-core passes
// (fp16 and fp8 wgmma) are for a later kernel.

#include "tile_dot.cuh"

constexpr int SP_MAX_NF = 3;
constexpr int SP_MAX_PAIRS = 9;

struct SplitArgs {
  const void* a[SP_MAX_NF];   // [M, K] per class code
  const void* b[SP_MAX_NF];   // [K, N]
  const void* c[SP_MAX_NF];   // [M, N]
  void* o[SP_MAX_NF];         // [M, N] outputs
  const int* pa;              // [M/t, K/t] class map of A
  const int* pb;              // [K/t, N/t]
  const int* pc;              // [M/t, N/t]
  int adt[SP_MAX_NF];         // buffer dtype codes
  int bdt[SP_MAX_NF];
  int cdt[SP_MAX_NF];
  int odt[SP_MAX_NF];
  int comp[SP_MAX_NF];        // compute dtype code per class
  int qmax[SP_MAX_NF];        // > 0: per-tile-scaled integer class
  int slices[SP_MAX_NF];      // 1: simple class; 2 or 3: split class
  int sdt[SP_MAX_NF];         // slice dtype code (DT_F16 or DT_E5M2)
  int pairs[SP_MAX_NF][SP_MAX_PAIRS];   // slice_pair_order as i * 4 + j
  int nf;
  int M, K, N;
  float alpha, beta;
};

namespace {

// Slice storage: fp16 bits or e5m2 bytes.
template <int SDT>
struct Slice;

template <>
struct Slice<DT_F16> {
  using T = unsigned short;
  __device__ static T bits(float v) { return __half_as_ushort(__float2half_rn(v)); }
  __device__ static float value(T b) { return __half2float(__ushort_as_half(b)); }
};

template <>
struct Slice<DT_E5M2> {
  using T = unsigned char;
  __device__ static T bits(float v) { return e5m2_bits(v); }
  __device__ static float value(T b) { return e5m2_value(b); }
};

template <int T, int S, int SDT>
constexpr int split_smem() {
  return 2 * S * T * T * static_cast<int>(sizeof(typename Slice<SDT>::T));
}

// acc += (sum over slice pairs, in the host's order, of the pair's t-long
// dot) for one k tile.
template <int T, int S, int SDT>
__device__ __forceinline__ void dot_split(Acc<T>& acc, unsigned char* smem,
                                          const void* A, int adt, long long a0,
                                          long long lda, const void* B, int bdt,
                                          long long b0, long long ldb,
                                          const int* pairs) {
  using G = Geo<T>;
  using SL = Slice<SDT>;
  using ST = typename SL::T;
  ST* As = reinterpret_cast<ST*>(smem);      // [S][T][T]
  ST* Bs = As + S * T * T;                   // [S][T][T]
  for (int e = threadIdx.x; e < T * T; e += G::NTH) {
    const int r = e / T, q = e % T;
    float va = load_any(A, adt, a0 + r * lda + q);
    float vb = load_any(B, bdt, b0 + r * ldb + q);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const ST ba = SL::bits(va), bb = SL::bits(vb);
      As[s * T * T + e] = ba;
      Bs[s * T * T + e] = bb;
      va = __fsub_rn(va, SL::value(ba));
      vb = __fsub_rn(vb, SL::value(bb));
    }
  }
  __syncthreads();
  const int tx = threadIdx.x % G::TDX, ty = threadIdx.x / G::TDX;
  float upd[G::TMR][G::TMC];
#pragma unroll 1
  for (int p = 0; p < S * S; ++p) {
    const ST* Ai = As + (pairs[p] >> 2) * T * T;
    const ST* Bj = Bs + (pairs[p] & 3) * T * T;
    float pd[G::TMR][G::TMC];
#pragma unroll
    for (int r = 0; r < G::TMR; ++r)
#pragma unroll
      for (int q = 0; q < G::TMC; ++q) pd[r][q] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < T; ++k) {
      float av[G::TMR], bv[G::TMC];
#pragma unroll
      for (int r = 0; r < G::TMR; ++r) av[r] = SL::value(Ai[(ty + G::TDY * r) * T + k]);
#pragma unroll
      for (int q = 0; q < G::TMC; ++q) bv[q] = SL::value(Bj[k * T + tx + G::TDX * q]);
#pragma unroll
      for (int r = 0; r < G::TMR; ++r)
#pragma unroll
        for (int q = 0; q < G::TMC; ++q)
          pd[r][q] = __fmaf_rn(av[r], bv[q], pd[r][q]);
    }
#pragma unroll
    for (int r = 0; r < G::TMR; ++r)
#pragma unroll
      for (int q = 0; q < G::TMC; ++q)
        upd[r][q] = p == 0 ? pd[r][q] : __fadd_rn(upd[r][q], pd[r][q]);
  }
#pragma unroll
  for (int r = 0; r < G::TMR; ++r)
#pragma unroll
    for (int q = 0; q < G::TMC; ++q) acc[r][q] = __fadd_rn(acc[r][q], upd[r][q]);
  __syncthreads();
}

// The split storage round trip of v: the fp32 sum of its slices.
template <int S, int SDT>
__device__ __forceinline__ float split_roundtrip(float v) {
  using SL = Slice<SDT>;
  float out = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float sv = SL::value(SL::bits(v));
    out = s == 0 ? sv : __fadd_rn(out, sv);
    v = __fsub_rn(v, sv);
  }
  return out;
}

__device__ __forceinline__ float roundtrip_any(float v, int slices, int sdt) {
  if (sdt == DT_F16) return slices == 2 ? split_roundtrip<2, DT_F16>(v)
                                        : split_roundtrip<3, DT_F16>(v);
  return slices == 2 ? split_roundtrip<2, DT_E5M2>(v) : split_roundtrip<3, DT_E5M2>(v);
}

template <int T>
__global__ void __launch_bounds__(Geo<T>::NTH)
split_gemm_kernel(const SplitArgs a) {
  using G = Geo<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[(G::NTH + 31) / 32];

  const int j = blockIdx.x, i = blockIdx.y;
  const int nt = a.N / T, kt = a.K / T;
  const int cls = a.pc[i * nt + j];
  const int slices = a.slices[cls], sdt = a.sdt[cls], ct = a.comp[cls];
  const int* pairs = a.pairs[cls];

  float acc[G::TMR][G::TMC];
#pragma unroll
  for (int r = 0; r < G::TMR; ++r)
#pragma unroll
    for (int q = 0; q < G::TMC; ++q) acc[r][q] = 0.0f;

  for (int kk = 0; kk < kt; ++kk) {
    const int ca = a.pa[i * kt + kk];
    const int cb = a.pb[kk * nt + j];
    const long long a0 = static_cast<long long>(i) * T * a.K + static_cast<long long>(kk) * T;
    const long long b0 = static_cast<long long>(kk) * T * a.N + static_cast<long long>(j) * T;
    // the branch is uniform across the block (one C class per tile)
    if (slices == 1) {
      dot_simple<T>(acc, reinterpret_cast<float*>(smem), a.a[ca], a.adt[ca], a0, a.K,
                    a.b[cb], a.bdt[cb], b0, a.N, ct);
    } else if (slices == 2 && sdt == DT_F16) {
      dot_split<T, 2, DT_F16>(acc, smem, a.a[ca], a.adt[ca], a0, a.K, a.b[cb], a.bdt[cb],
                              b0, a.N, pairs);
    } else if (slices == 3 && sdt == DT_E5M2) {
      dot_split<T, 3, DT_E5M2>(acc, smem, a.a[ca], a.adt[ca], a0, a.K, a.b[cb], a.bdt[cb],
                               b0, a.N, pairs);
    } else if (slices == 2) {
      dot_split<T, 2, DT_E5M2>(acc, smem, a.a[ca], a.adt[ca], a0, a.K, a.b[cb], a.bdt[cb],
                               b0, a.N, pairs);
    } else {
      dot_split<T, 3, DT_F16>(acc, smem, a.a[ca], a.adt[ca], a0, a.K, a.b[cb], a.bdt[cb],
                              b0, a.N, pairs);
    }
  }

  const long long c0 = static_cast<long long>(i) * T * a.N + static_cast<long long>(j) * T;
  axpby_c<T>(acc, a.c[cls], a.cdt[cls], c0, a.N, a.alpha, a.beta);
  if (slices > 1) {
#pragma unroll
    for (int r = 0; r < G::TMR; ++r)
#pragma unroll
      for (int q = 0; q < G::TMC; ++q) acc[r][q] = roundtrip_any(acc[r][q], slices, sdt);
  } else if (a.qmax[cls] > 0) {   // uniform across the block
    quantize_tile<T>(acc, a.qmax[cls], red);
  }
  store_classes<T>(acc, a.o, a.odt, a.nf, cls, c0, a.N);
}

template <int T>
int launch_t(const SplitArgs& a, cudaStream_t st) {
  int smem = Geo<T>::SIMPLE_SMEM;
  for (int f = 0; f < a.nf; ++f) {
    if (a.slices[f] < 1 || a.slices[f] > 3) return static_cast<int>(cudaErrorInvalidValue);
    if (a.slices[f] == 1) continue;
    if (a.sdt[f] != DT_F16 && a.sdt[f] != DT_E5M2) return static_cast<int>(cudaErrorInvalidValue);
    const int need = a.sdt[f] == DT_F16
                         ? (a.slices[f] == 2 ? split_smem<T, 2, DT_F16>() : split_smem<T, 3, DT_F16>())
                         : (a.slices[f] == 2 ? split_smem<T, 2, DT_E5M2>()
                                             : split_smem<T, 3, DT_E5M2>());
    smem = need > smem ? need : smem;
  }
  cudaError_t e = cudaFuncSetAttribute(split_gemm_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.N / T, a.M / T);
  split_gemm_kernel<T><<<grid, Geo<T>::NTH, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int split_gemm_launch(const SplitArgs* args, int tile, int device, void* stream) {
  const SplitArgs a = *args;
  if (a.nf < 1 || a.nf > SP_MAX_NF || a.M % tile || a.K % tile || a.N % tile ||
      a.M < tile || a.K < tile || a.N < tile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 16: return launch_t<16>(a, st);
    case 32: return launch_t<32>(a, st);
    case 64: return launch_t<64>(a, st);
    case 128: return launch_t<128>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
