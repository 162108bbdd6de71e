// Tile-centric mixed-precision GEMM (the paper's Algorithm 1), hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mp_gemm_tile.py
// (mp_gemm_tile_multi -> pallas_call, body _kernel, epilogue
// quantize_block):
//
//     C <- alpha * A . B + beta * C
//
// A, B and C each come as one full buffer per format of the FormatSet
// (MPMatrix.bufs); tile (i, j) of a matrix is valid in the buffer its
// class map selects and zero in the others.  The class of the C tile picks
// the compute dtype of its whole update; accumulation is fp32; the store
// writes alpha*acc + beta*C into the buffer of C's class and zeros into
// the others, integer classes after a per-tile absmax quantize-dequantize.
//
// What bounds it on an H100: at M = N = K = 4096 and t = 128 it does
// 2*M*N*K = 137 GFLOP against ~0.3 GB of buffers, far above the card's
// ridge point, so it is bound by operations — fp32 FMA for fp32-class
// tiles (this kernel runs every class on the fp32 pipes).
//
// Design: one block per C tile, looping over k (blocks run in parallel in
// any order, so the TPU's sequential k grid axis becomes this loop and the
// accumulator stays in registers).  The block is a TD x TD thread grid,
// TD = min(t, 32); each thread owns a (t/TD) x (t/TD) micro-tile, rows
// ty + TD r, columns tx + TD c, so a warp stores 32 consecutive columns.  For each
// k tile the block reads the A and B tiles only from the buffer their
// class maps name (bit-identical to the reference's sum of upcasts, where
// the other buffers are zero), rounds them to the C class's compute dtype
// while staging a (t x 32) / (32 x t) slice in shared memory, and runs a
// sequential fp32 FMA chain.  The epilogue reduces the tile's absmax
// across the block for integer classes (NaN-propagating, like the
// reference's max).  wgmma/TMA and tensor-core classes come later.

#include "common.cuh"

constexpr int TL_MAX_NF = 3;

struct TileArgs {
  const void* a[TL_MAX_NF];   // [M, K] per class code
  const void* b[TL_MAX_NF];   // [K, N]
  const void* c[TL_MAX_NF];   // [M, N]
  void* o[TL_MAX_NF];         // [M, N] outputs
  const int* pa;              // [M/t, K/t] class map of A
  const int* pb;              // [K/t, N/t]
  const int* pc;              // [M/t, N/t]
  int adt[TL_MAX_NF];         // buffer dtype codes
  int bdt[TL_MAX_NF];
  int cdt[TL_MAX_NF];
  int odt[TL_MAX_NF];
  int comp[TL_MAX_NF];        // compute dtype code per class
  int qmax[TL_MAX_NF];        // > 0: per-tile-scaled integer class
  int nf;
  int M, K, N;
  float alpha, beta;
};

namespace {

__device__ __forceinline__ float nanmax(float m, float v) {
  return (isnan(v) || v > m) ? v : m;   // NaN wins, as in the reference
}

template <int T>
__global__ void __launch_bounds__(T < 32 ? T * T : 1024)
mp_gemm_tile_kernel(const TileArgs a) {
  constexpr int TD = T < 32 ? T : 32;    // thread grid edge
  constexpr int NTH = TD * TD;
  constexpr int TM = T / TD;             // micro-tile edge
  constexpr int BK = T < 32 ? T : 32;    // k slice staged per step
  __shared__ float As[T][BK + 1];
  __shared__ float Bs[BK][T + 1];
  __shared__ float red[(NTH + 31) / 32];

  const int j = blockIdx.x, i = blockIdx.y;
  const int nt = a.N / T, kt = a.K / T;
  const int tx = threadIdx.x % TD, ty = threadIdx.x / TD;
  const int cls = a.pc[i * nt + j];
  const int ct = a.comp[cls];

  float acc[TM][TM];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TM; ++q) acc[r][q] = 0.0f;

  for (int kk = 0; kk < kt; ++kk) {
    const int ca = a.pa[i * kt + kk];
    const int cb = a.pb[kk * nt + j];
    const void* A = a.a[ca];
    const void* B = a.b[cb];
    const int adt = a.adt[ca], bdt = a.bdt[cb];
    for (int ks = 0; ks < T; ks += BK) {
      const long long k0 = static_cast<long long>(kk) * T + ks;
      for (int e = threadIdx.x; e < T * BK; e += NTH) {
        const int r = e / BK, q = e % BK;
        const long long idx = (static_cast<long long>(i) * T + r) * a.K + k0 + q;
        As[r][q] = round_to(load_any(A, adt, idx), ct);
      }
      for (int e = threadIdx.x; e < BK * T; e += NTH) {
        const int r = e / T, q = e % T;
        const long long idx = (k0 + r) * a.N + static_cast<long long>(j) * T + q;
        Bs[r][q] = round_to(load_any(B, bdt, idx), ct);
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float av[TM], bv[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) av[r] = As[ty + TD * r][k];
#pragma unroll
        for (int q = 0; q < TM; ++q) bv[q] = Bs[k][tx + TD * q];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int q = 0; q < TM; ++q)
            acc[r][q] = __fmaf_rn(av[r], bv[q], acc[r][q]);
      }
      __syncthreads();
    }
  }

  // epilogue: alpha*acc + beta*C (C read from its class's buffer)
  const void* C = a.c[cls];
  const int cdt = a.cdt[cls];
  float amax = 0.0f;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const long long idx = (static_cast<long long>(i) * T + ty + TD * r) * a.N
                            + static_cast<long long>(j) * T + tx + TD * q;
      const float cv = load_any(C, cdt, idx);
      acc[r][q] = __fadd_rn(__fmul_rn(a.alpha, acc[r][q]), __fmul_rn(a.beta, cv));
      amax = nanmax(amax, fabsf(acc[r][q]));
    }

  const int qmax = a.qmax[cls];
  if (qmax > 0) {   // uniform across the block: the tile has one class
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = nanmax(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
    __syncthreads();
    amax = red[0];
    for (int w = 1; w < (NTH + 31) / 32; ++w) amax = nanmax(amax, red[w]);
    const float fq = static_cast<float>(qmax);
    const float scale = amax > 0.0f ? __fdiv_rn(amax, fq) : 1.0f;
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int q = 0; q < TM; ++q) {
        float v = rintf(__fdiv_rn(acc[r][q], scale));
        v = v < -fq ? -fq : (v > fq ? fq : v);   // NaN stays NaN
        acc[r][q] = __fmul_rn(v, scale);
      }
  }

#pragma unroll 1
  for (int code = 0; code < a.nf; ++code) {
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int q = 0; q < TM; ++q) {
        const long long idx = (static_cast<long long>(i) * T + ty + TD * r) * a.N
                              + static_cast<long long>(j) * T + tx + TD * q;
        store_any(a.o[code], a.odt[code], idx, code == cls ? acc[r][q] : 0.0f);
      }
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int mp_gemm_tile_launch(const TileArgs* args, int tile, int device,
                                   void* stream) {
  const TileArgs a = *args;
  if (a.nf < 1 || a.nf > TL_MAX_NF || a.M % tile || a.K % tile || a.N % tile ||
      a.M < tile || a.K < tile || a.N < tile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(a.N / tile, a.M / tile);
  switch (tile) {
    case 16: mp_gemm_tile_kernel<16><<<grid, 16 * 16, 0, st>>>(a); break;
    case 32: mp_gemm_tile_kernel<32><<<grid, 32 * 32, 0, st>>>(a); break;
    case 64: mp_gemm_tile_kernel<64><<<grid, 32 * 32, 0, st>>>(a); break;
    case 128: mp_gemm_tile_kernel<128><<<grid, 32 * 32, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
