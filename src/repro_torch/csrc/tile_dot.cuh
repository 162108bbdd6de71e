// Per-tile dot products and epilogues shared by the tile, split and
// grouped kernels: one block owns one t x t C tile and accumulates it
// over k tiles in registers.  The block is a TDY x TDX thread grid (32 x
// 32 at t >= 32); thread (ty, tx) owns rows ty + TDY*r and columns
// tx + TDX*q of the tile, so a warp reads one row of A (a broadcast) and
// 32 consecutive columns of B from shared memory, and stores 32
// consecutive columns.
//
// An operand tile is addressed by the offset of its (0, 0) element and
// its row stride: a dense MPMatrix buffer (stride K or N) and a compact
// class-sorted tile array (stride t) look the same to these functions.
#pragma once

#include "common.cuh"

template <int T>
struct Geo {
  static constexpr int TDX = T < 32 ? T : 32;   // threads along columns
  static constexpr int TDY = T < 32 ? T : 32;   // threads along rows
  static constexpr int NTH = TDX * TDY;
  static constexpr int TMR = T / TDY;           // rows per thread
  static constexpr int TMC = T / TDX;           // columns per thread
  static constexpr int BK = T < 32 ? T : 32;    // k slice staged per step
  // shared memory of dot_simple: fp32 A [T][BK+1] and B [BK][T+1]
  static constexpr int SIMPLE_SMEM = (T * (BK + 1) + BK * (T + 1)) * 4;
};

template <int T>
using Acc = float[Geo<T>::TMR][Geo<T>::TMC];

// acc += round(A) . round(B) over one k tile: operands rounded to the
// compute dtype `ct` while staged in shared memory (BK k-columns at a
// time), then one sequential fp32 FMA chain per element (the tile
// kernel's dot; products of rounded operands are exact in fp32).
template <int T>
__device__ __forceinline__ void dot_simple(Acc<T>& acc, float* smem,
                                           const void* A, int adt,
                                           long long a0, long long lda,
                                           const void* B, int bdt,
                                           long long b0, long long ldb,
                                           int ct) {
  using G = Geo<T>;
  constexpr int BK = G::BK;
  float* As = smem;                     // [T][BK + 1]
  float* Bs = smem + T * (BK + 1);      // [BK][T + 1]
  const int tx = threadIdx.x % G::TDX, ty = threadIdx.x / G::TDX;
  for (int ks = 0; ks < T; ks += BK) {
    for (int e = threadIdx.x; e < T * BK; e += G::NTH) {
      const int r = e / BK, q = e % BK;
      As[r * (BK + 1) + q] = round_to(load_any(A, adt, a0 + r * lda + ks + q), ct);
    }
    for (int e = threadIdx.x; e < BK * T; e += G::NTH) {
      const int r = e / T, q = e % T;
      Bs[r * (T + 1) + q] = round_to(load_any(B, bdt, b0 + (ks + r) * ldb + q), ct);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float av[G::TMR], bv[G::TMC];
#pragma unroll
      for (int r = 0; r < G::TMR; ++r) av[r] = As[(ty + G::TDY * r) * (BK + 1) + k];
#pragma unroll
      for (int q = 0; q < G::TMC; ++q) bv[q] = Bs[k * (T + 1) + tx + G::TDX * q];
#pragma unroll
      for (int r = 0; r < G::TMR; ++r)
#pragma unroll
        for (int q = 0; q < G::TMC; ++q)
          acc[r][q] = __fmaf_rn(av[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float nanmax(float m, float v) {
  return (isnan(v) || v > m) ? v : m;   // NaN wins, as in the reference
}

// Per-tile symmetric absmax quantize-dequantize of the block's tile (the
// integer-class store epilogue; NaN-propagating like the reference's
// max).  `red` holds one float per warp.  Every thread of the block must
// call it.
template <int T>
__device__ __forceinline__ void quantize_tile(Acc<T>& v, int qmax, float* red) {
  using G = Geo<T>;
  float amax = 0.0f;
#pragma unroll
  for (int r = 0; r < G::TMR; ++r)
#pragma unroll
    for (int q = 0; q < G::TMC; ++q) amax = nanmax(amax, fabsf(v[r][q]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nanmax(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
  for (int w = 1; w < (G::NTH + 31) / 32; ++w) amax = nanmax(amax, red[w]);
  const float fq = static_cast<float>(qmax);
  const float scale = amax > 0.0f ? __fdiv_rn(amax, fq) : 1.0f;
#pragma unroll
  for (int r = 0; r < G::TMR; ++r)
#pragma unroll
    for (int q = 0; q < G::TMC; ++q) {
      float x = rintf(__fdiv_rn(v[r][q], scale));
      x = x < -fq ? -fq : (x > fq ? fq : x);   // NaN stays NaN
      v[r][q] = __fmul_rn(x, scale);
    }
}

// acc <- alpha * acc + beta * C, C read from its class's buffer (element
// (r, q) of the tile at offset c0 + r * ldc + q).
template <int T>
__device__ __forceinline__ void axpby_c(Acc<T>& acc, const void* C, int cdt,
                                        long long c0, long long ldc,
                                        float alpha, float beta) {
  using G = Geo<T>;
  const int tx = threadIdx.x % G::TDX, ty = threadIdx.x / G::TDX;
#pragma unroll
  for (int r = 0; r < G::TMR; ++r)
#pragma unroll
    for (int q = 0; q < G::TMC; ++q) {
      const float cv = load_any(C, cdt, c0 + (ty + G::TDY * r) * ldc + tx + G::TDX * q);
      acc[r][q] = __fadd_rn(__fmul_rn(alpha, acc[r][q]), __fmul_rn(beta, cv));
    }
}

// Store the tile into the output buffer of class `cls` and zeros into the
// other nf - 1 buffers (the multi-buffer layout of MPMatrix).
template <int T>
__device__ __forceinline__ void store_classes(const Acc<T>& acc, void* const* o,
                                              const int* odt, int nf, int cls,
                                              long long o0, long long ldo) {
  using G = Geo<T>;
  const int tx = threadIdx.x % G::TDX, ty = threadIdx.x / G::TDX;
#pragma unroll 1
  for (int code = 0; code < nf; ++code) {
#pragma unroll
    for (int r = 0; r < G::TMR; ++r)
#pragma unroll
      for (int q = 0; q < G::TMC; ++q)
        store_any(o[code], odt[code], o0 + (ty + G::TDY * r) * ldo + tx + G::TDX * q,
                  code == cls ? acc[r][q] : 0.0f);
  }
}
