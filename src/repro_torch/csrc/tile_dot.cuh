// Per-tile dot products and epilogues shared by the tile, split and
// grouped kernels: one block owns one t x t C tile and accumulates it over
// the k tiles of its row of A and column of B, in place of the per-tile
// dot of the Pallas TPU kernels src/repro/kernels/mp_gemm_tile.py
// (_kernel: a dot at the C class's compute dtype, preferred_element_type
// fp32) and src/repro/kernels/grouped_gemm.py (_kernel).  Two designs
// live here.
//
// The staged dot (t = 64 and 128; the tile, grouped and split kernels).  What
// bounds it on an H100 is operations: 2*t^2*K per C tile, on the tensor
// cores (989 TFLOP/s dense) for a bf16 or fp16 compute class, on the fp32
// FMA pipes (67 TFLOP/s) for an fp32 or integer class (TF32 is not
// allowed, so those classes stay off the tensor cores).  Design:
//   - the k loop runs in stages of BK = 64; each stage is an A slice
//     (t x 64) and a B slice (64 x t), each 8-element chunk owned by one
//     thread;
//   - an operand already stored in the compute dtype goes straight to
//     shared memory by cp.async (16 bytes per copy); any other one is
//     converted as the reference's receiver-side cast does: fp8 and
//     bf16/fp16 upcast exactly, then round to nearest even to the compute
//     dtype (built without fast math: no flush to zero);
//   - bf16/fp16 compute classes: six compute slots in the 128-byte-
//     swizzled layouts the wgmma descriptors read (A K-major, B MN-major,
//     so B is never transposed), copies four stages ahead, operands to
//     convert loaded into registers a stage early; each warpgroup runs
//     m64 x t x k16 wgmma with fp32 accumulators in registers (t = 128:
//     two warpgroups of 64 rows), one stage's wgmma left in flight across
//     the next barrier; one barrier per stage;
//   - fp32 and integer compute classes: two slots of fp32 operands (A
//     rows padded) and a raw area for the next stage's operands to
//     upcast; each thread keeps an 8 x 8 (t = 128) or 4 x 8 (t = 64)
//     register tile fed by float4 shared-memory reads, one fp32 FMA chain
//     per element in k order, while the next stage's copies land;
//   - the path is picked by the C tile's class, so it is uniform per block;
//   - epilogue (store_tile): the accumulators go through shared memory,
//     every C read of the block is issued before its first store, then
//     alpha*acc + beta*C, the integer classes' NaN-propagating absmax
//     quantize-dequantize over the whole tile, and 8-element vector
//     stores into every class buffer.
//
// The simple dot (dot_simple, t = 16 and 32 of the tile, grouped and
// split kernels): a 32 x 32
// thread grid (t x t below 32); thread (ty, tx) owns rows ty + TDY*r and
// columns tx + TDX*q of the tile; operands rounded to the compute dtype
// into fp32 shared memory, one sequential fp32 FMA chain per element.
// wgmma needs 64 rows, so the two small tiles keep it; no main-path shape
// uses them.
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

// ---------------------------------------------------------------------------
// The staged dot (t = 64, 128)
// ---------------------------------------------------------------------------

// Shared-memory plan of the staged dot; kernels/mp_gemm_tile.py's
// staged_smem_bytes mirrors SMEM, and the launch functions refuse any
// other value.
template <int T>
struct Big {
  static_assert(T == 64 || T == 128, "the staged dot serves t = 64 and 128");
  static constexpr int NTH = T == 128 ? 256 : 128;   // one warpgroup per 64 rows
  static constexpr int BK = 64;                       // k per stage: a 128-byte bf16 row
  static constexpr int ACC = T * T / NTH;             // accumulators per thread
  static constexpr int CH_A = T * 8 / NTH;            // 8-element chunks per thread of
  static constexpr int CH_B = BK * (T / 8) / NTH;     // ... an A slice, a B slice
  // tensor-core path: NS compute slots of bf16/fp16 A and B slices in the
  // wgmma layouts, stages copied DIST ahead of the one multiplied
  static constexpr int MMA_A = T * BK * 2;
  static constexpr int MMA_SLOT = 2 * MMA_A;
  static constexpr int NS = 6;
  static constexpr int DIST = NS - 2;
  static constexpr int RING = NS * MMA_SLOT;          // from the 1024-byte-aligned base
  // fp32 path: two slots of A [T][F32_LDA] and B [BK][T] in the same
  // ring, then the raw bytes of the next stage's operands not stored in
  // fp32 (2 bytes an element at most: A [T][BK], then B [BK][T])
  static constexpr int F32_LDA = BK + 4;              // padded: conflict-free row reads
  static constexpr int F32_A = T * F32_LDA * 4;
  static constexpr int F32_SLOT = F32_A + BK * T * 4;
  static constexpr int F32_RAW = 2 * F32_SLOT;
  static constexpr int RAW_A = T * BK * 2;
  static constexpr int OUT_LD = T + 8;                // epilogue tile row stride, floats
  static constexpr int RED = 64;                      // per-warp absmax scratch
  static constexpr int SMEM = 1024 + RING + RED;
  static_assert(F32_RAW + 2 * RAW_A <= RING, "the fp32 path's slots fit the ring");
  static_assert(T * OUT_LD * 4 <= RING, "the epilogue tile reuses the ring");
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

// Where a stage's operand slice starts: the buffer, its dtype code, the
// element offset of the slice's (0, 0) and the row stride in elements.
struct Opnd {
  const void* p;
  int dt;
  long long off;
  long long ld;
};

// The class codes (and, for compact operands, the slots) of a stage's A
// and B tiles.  A staged dot reads operands through a source `src` with
//   src.codes(s) -> Codes            (loads from the class maps), and
//   src.operands(s, codes, a, b)     (no memory access),
// so the class-map loads of a stage can be issued an iteration before
// the stage needs them.
struct Codes {
  int ca, sa, cb, sb;
};

__device__ __forceinline__ int dt_bytes(int dt) {
  return dt == DT_F32 ? 4 : (dt <= DT_F16 ? 2 : 1);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (which it cannot see writing the registers).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D (64 x N, fp32, in registers) += A (64 x 16, K-major) . B (16 x N,
// MN-major: trans-b = 1), both from shared memory.
__device__ __forceinline__ void wgmma_m64n128_bf16(float (&d)[64], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128_f16(float (&d)[64], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64_bf16(float (&d)[32], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64_f16(float (&d)[32], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// The raw words of eight consecutive elements of `es` bytes each at p
// (16-byte aligned for 2- and 4-byte elements, 8-byte for 1-byte ones).
__device__ __forceinline__ void load_words(const unsigned char* p, int es, uint4 (&w)[2]) {
  if (es == 1) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = make_uint4(u.x, u.y, 0u, 0u);
  } else {
    w[0] = *reinterpret_cast<const uint4*>(p);
    if (es == 4) w[1] = *reinterpret_cast<const uint4*>(p + 16);
  }
}

// Those eight elements of dtype `dt`, upcast exactly to fp32.
__device__ __forceinline__ void decode_words(const uint4 (&w)[2], int dt, float (&v)[8]) {
  if (dt == DT_F32) {
    const unsigned u[8] = {w[0].x, w[0].y, w[0].z, w[0].w, w[1].x, w[1].y, w[1].z, w[1].w};
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __uint_as_float(u[i]);
  } else if (dt == DT_BF16 || dt == DT_F16) {
    const unsigned u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned short lo = static_cast<unsigned short>(u[i] & 0xFFFFu);
      const unsigned short hi = static_cast<unsigned short>(u[i] >> 16);
      if (dt == DT_BF16) {
        v[2 * i] = __uint_as_float(static_cast<unsigned>(lo) << 16);
        v[2 * i + 1] = __uint_as_float(static_cast<unsigned>(hi) << 16);
      } else {
        v[2 * i] = __half2float(__ushort_as_half(lo));
        v[2 * i + 1] = __half2float(__ushort_as_half(hi));
      }
    }
  } else {
    const __nv_fp8_interpretation_t kind = dt == DT_E4M3 ? __NV_E4M3 : __NV_E5M2;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned b = ((i < 4 ? w[0].x : w[0].y) >> (8 * (i & 3))) & 0xFFu;
      v[i] = __half2float(__half(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(b), kind)));
    }
  }
}

// Eight zeros (all-zero bits in every dtype) at element index i of p.
__device__ __forceinline__ void zero8(void* p, int dt, long long i) {
  const int es = dt_bytes(dt);
  unsigned char* q = reinterpret_cast<unsigned char*>(p) + i * es;
  if (es == 1) {
    *reinterpret_cast<uint2*>(q) = make_uint2(0u, 0u);
  } else {
    *reinterpret_cast<uint4*>(q) = make_uint4(0u, 0u, 0u, 0u);
    if (es == 4) *reinterpret_cast<uint4*>(q + 16) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The wgmma layouts of a compute slot (bf16/fp16, 1024-byte aligned).
// A (T x BK, K-major): row r is 128 bytes, its 16-byte chunk c at
// c ^ (r & 7).  B (BK x T, MN-major): 64-column blocks of [BK][64] (8192
// bytes each), row k's chunk c at c ^ (k & 7).
__device__ __forceinline__ int swz_a(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }
template <int BK>
__device__ __forceinline__ int swz_b(int k, int n8) {
  return (n8 >> 3) * (BK * 128) + k * 128 + (((n8 & 7) ^ (k & 7)) << 4);
}

__device__ __forceinline__ const unsigned char* slice_ptr(const Opnd& x) {
  return reinterpret_cast<const unsigned char*>(x.p) + x.off * dt_bytes(x.dt);
}

// A thread's chunks of a stage: 8 consecutive elements each, A chunk u at
// row r, column 8c of the A slice, B chunk u at row k, column 8 n8 of the
// B slice (consecutive threads on consecutive chunks of a row).
template <int T>
struct Chunk {
  __device__ static int q(int u) { return threadIdx.x + u * Big<T>::NTH; }
  __device__ static int ar(int u) { return q(u) >> 3; }
  __device__ static int ac(int u) { return q(u) & 7; }
  __device__ static int bk(int u) { return q(u) / (T / 8); }
  __device__ static int bn(int u) { return q(u) % (T / 8); }
};

// Raw words of this thread's chunks of the operands not stored in `want`
// (they are converted; the others are copied by cp.async).
template <int T>
struct Staged {
  uint4 a[Big<T>::CH_A][2];
  uint4 b[Big<T>::CH_B][2];
};

template <int T>
__device__ __forceinline__ void load_staged(Staged<T>& w, const Opnd& a, const Opnd& b,
                                            int want) {
  using G = Big<T>;
  using Q = Chunk<T>;
  if (a.dt != want) {
    const int es = dt_bytes(a.dt);
    const unsigned char* p = slice_ptr(a);
#pragma unroll
    for (int u = 0; u < G::CH_A; ++u)
      load_words(p + (Q::ar(u) * a.ld + Q::ac(u) * 8) * es, es, w.a[u]);
  }
  if (b.dt != want) {
    const int es = dt_bytes(b.dt);
    const unsigned char* p = slice_ptr(b);
#pragma unroll
    for (int u = 0; u < G::CH_B; ++u)
      load_words(p + (Q::bk(u) * b.ld + Q::bn(u) * 8) * es, es, w.b[u]);
  }
}

// Tensor-core path: operands stored in the compute dtype CT go straight
// into the slot's swizzled layout by cp.async; commits one group.
template <int T, int CT>
__device__ __forceinline__ void copy_mma(unsigned char* slot, bool live, const Opnd& a,
                                         const Opnd& b) {
  using G = Big<T>;
  using Q = Chunk<T>;
  if (live && a.dt == CT) {
    const unsigned char* p = slice_ptr(a);
#pragma unroll
    for (int u = 0; u < G::CH_A; ++u)
      cp_async16(slot + swz_a(Q::ar(u), Q::ac(u)), p + (Q::ar(u) * a.ld + Q::ac(u) * 8) * 2);
  }
  if (live && b.dt == CT) {
    const unsigned char* p = slice_ptr(b);
#pragma unroll
    for (int u = 0; u < G::CH_B; ++u)
      cp_async16(slot + G::MMA_A + swz_b<G::BK>(Q::bk(u), Q::bn(u)),
                 p + (Q::bk(u) * b.ld + Q::bn(u) * 8) * 2);
  }
  cp_async_commit();
}

// ... and the others, from raw words, rounded to CT into the layout.
template <int T, int CT>
__device__ __forceinline__ void convert_mma(unsigned char* slot, const Staged<T>& w,
                                            const Opnd& a, const Opnd& b) {
  using G = Big<T>;
  using Q = Chunk<T>;
  if (a.dt != CT) {
#pragma unroll
    for (int u = 0; u < G::CH_A; ++u) {
      float v[8];
      decode_words(w.a[u], a.dt, v);
      *reinterpret_cast<uint4*>(slot + swz_a(Q::ar(u), Q::ac(u))) = pack8(v, CT);
    }
  }
  if (b.dt != CT) {
#pragma unroll
    for (int u = 0; u < G::CH_B; ++u) {
      float v[8];
      decode_words(w.b[u], b.dt, v);
      *reinterpret_cast<uint4*>(slot + G::MMA_A + swz_b<G::BK>(Q::bk(u), Q::bn(u))) =
          pack8(v, CT);
    }
  }
}

// One stage of wgmma: this warpgroup's 64 rows of A times all T columns
// of B, four k16 steps back to back (no branch between them, so none
// waits for the one before).  No wgmma.fence: between wgmma of one shape
// accumulating into the same registers the order is kept by the
// hardware; the loop fences once before its first stage.
template <int T, int CT>
__device__ __forceinline__ void mma_stage(float (&acc)[Big<T>::ACC], const unsigned char* slot) {
  using G = Big<T>;
  const unsigned a0 = smem_u32(slot) + (threadIdx.x >> 7) * 64 * 128;
  const unsigned b0 = smem_u32(slot + G::MMA_A);
#pragma unroll
  for (int j = 0; j < G::BK / 16; ++j) {
    const uint64_t da = wgmma_desc(a0 + j * 32, 16, 1024);
    const uint64_t db = wgmma_desc(b0 + j * 2048, G::BK * 128, 1024);
    if constexpr (T == 128 && CT == DT_BF16) wgmma_m64n128_bf16(acc, da, db);
    else if constexpr (T == 128) wgmma_m64n128_f16(acc, da, db);
    else if constexpr (CT == DT_BF16) wgmma_m64n64_bf16(acc, da, db);
    else wgmma_m64n64_f16(acc, da, db);
  }
  wgmma_commit();
}

// Tensor-core path over `steps` stages, NS slots.  Iteration s: the
// wgmma of stage s start on slot s % NS; stage s + DIST's cp.async go to
// the slot stage s - 2 used; stage s + 1's raw words (loaded into
// registers one iteration earlier) are converted into its slot; stage
// s + 2's raw words are loaded; then at most the wgmma of stage s stay in
// flight.  One barrier per stage.
template <int T, int CT, class Src>
__device__ __forceinline__ void dot_mma(float (&acc)[Big<T>::ACC], unsigned char* ring,
                                        int steps, const Src& src) {
  using G = Big<T>;
  Staged<T> w;
  Opnd a, b;
  for (int p = 0; p < G::DIST; ++p) {
    if (p < steps) src.operands(p, src.codes(p), a, b);
    copy_mma<T, CT>(ring + p * G::MMA_SLOT, p < steps, a, b);
  }
  Opnd na, nb;   // stage s + 1's operands
  src.operands(0, src.codes(0), na, nb);
  load_staged<T>(w, na, nb, CT);
  convert_mma<T, CT>(ring, w, na, nb);
  if (steps > 1) {
    src.operands(1, src.codes(1), na, nb);
    load_staged<T>(w, na, nb, CT);
  }
  // the codes of stages s + DIST and s + 2, loaded an iteration ahead
  Codes cd = G::DIST < steps ? src.codes(G::DIST) : Codes{};
  Codes c2 = 2 < steps ? src.codes(2) : Codes{};
  fence_regs(acc);
  wgmma_fence();   // the accumulators' first values, before the first wgmma
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<G::DIST - 1>();   // stage s's copies are here
    fence_proxy_async();            // copies and conversions, read next by wgmma
    __syncthreads();                // ... for every thread; stage s - 2's wgmma are done
    mma_stage<T, CT>(acc, ring + (s % G::NS) * G::MMA_SLOT);
    const int p = s + G::DIST;
    if (p < steps) src.operands(p, cd, a, b);
    copy_mma<T, CT>(ring + (p % G::NS) * G::MMA_SLOT, p < steps, a, b);
    if (s + 1 < steps) {
      convert_mma<T, CT>(ring + ((s + 1) % G::NS) * G::MMA_SLOT, w, na, nb);
      if (s + 2 < steps) {
        src.operands(s + 2, c2, na, nb);
        load_staged<T>(w, na, nb, CT);
      }
    }
    if (p + 1 < steps) cd = src.codes(p + 1);
    if (s + 3 < steps) c2 = src.codes(s + 3);
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// The source of stage s of C tile (i, j) over dense MPMatrix buffers (the
// tile and split kernels): the A tile (i, kk) and B tile (kk, j) of k tile
// kk = s * BK / T, from the buffers their classes name.  Args holds the
// buffers a/b, their dtype codes adt/bdt, the class maps pa/pb and K, N.
template <int T, class Args>
struct TileSource {
  const Args& a;
  int i, j;
  __device__ Codes codes(int s) const {
    const int kk = s * Big<T>::BK / T;
    return {a.pa[i * (a.K / T) + kk], 0, a.pb[kk * (a.N / T) + j], 0};
  }
  __device__ void operands(int s, const Codes& c, Opnd& x, Opnd& y) const {
    const int kk = s * Big<T>::BK / T, ko = s * Big<T>::BK % T;
    x = {a.a[c.ca], a.adt[c.ca], static_cast<long long>(i) * T * a.K + kk * T + ko, a.K};
    y = {a.b[c.cb], a.bdt[c.cb], (static_cast<long long>(kk) * T + ko) * a.N + j * T, a.N};
  }
};

// fp32 FMA path: thread (ty, tx) owns rows (i / 4) * 4*TY + 4*ty + i % 4
// and columns (j / 4) * 4*TX + 4*tx + j % 4 of the tile.
template <int T>
struct F32Geo {
  static constexpr int TX = T / 8;                   // threads along columns
  static constexpr int TY = Big<T>::NTH / TX;        // threads along rows
  static constexpr int RM = T / TY;                  // rows per thread (8 or 4)
  __device__ static int row(int i) { return (i >> 2) * 4 * TY + 4 * (threadIdx.x / TX) + (i & 3); }
  __device__ static int col(int j) { return (j >> 2) * 4 * TX + 4 * (threadIdx.x % TX) + (j & 3); }
};

// fp32 path: fp32 operands go straight into the slot (A rows padded to
// F32_LDA), the others' raw bytes into the raw area, by cp.async; commits
// one group.
template <int T>
__device__ __forceinline__ void copy_f32(unsigned char* slot, unsigned char* raw, bool live,
                                         const Opnd& a, const Opnd& b) {
  using G = Big<T>;
  using Q = Chunk<T>;
  if (live) {
    const unsigned char* p = slice_ptr(a);
    const int es = dt_bytes(a.dt);
#pragma unroll
    for (int u = 0; u < G::CH_A; ++u) {
      const unsigned char* g = p + (Q::ar(u) * a.ld + Q::ac(u) * 8) * es;
      if (es == 4) {
        unsigned char* d = slot + (Q::ar(u) * G::F32_LDA + Q::ac(u) * 8) * 4;
        cp_async16(d, g);
        cp_async16(d + 16, g + 16);
      } else if (es == 2) {
        cp_async16(raw + (Q::ar(u) * G::BK + Q::ac(u) * 8) * 2, g);
      } else {
        cp_async8(raw + Q::ar(u) * G::BK + Q::ac(u) * 8, g);
      }
    }
  }
  if (live) {
    const unsigned char* p = slice_ptr(b);
    const int es = dt_bytes(b.dt);
#pragma unroll
    for (int u = 0; u < G::CH_B; ++u) {
      const unsigned char* g = p + (Q::bk(u) * b.ld + Q::bn(u) * 8) * es;
      if (es == 4) {
        unsigned char* d = slot + G::F32_A + (Q::bk(u) * T + Q::bn(u) * 8) * 4;
        cp_async16(d, g);
        cp_async16(d + 16, g + 16);
      } else if (es == 2) {
        cp_async16(raw + G::RAW_A + (Q::bk(u) * T + Q::bn(u) * 8) * 2, g);
      } else {
        cp_async8(raw + G::RAW_A + Q::bk(u) * T + Q::bn(u) * 8, g);
      }
    }
  }
  cp_async_commit();
}

// ... and the others upcast exactly from the raw area into the slot.
template <int T>
__device__ __forceinline__ void convert_f32(unsigned char* slot, const unsigned char* raw,
                                            const Opnd& a, const Opnd& b) {
  using G = Big<T>;
  using Q = Chunk<T>;
  if (a.dt != DT_F32) {
    const int es = dt_bytes(a.dt);
#pragma unroll
    for (int u = 0; u < G::CH_A; ++u) {
      uint4 w[2];
      float v[8];
      load_words(raw + (Q::ar(u) * G::BK + Q::ac(u) * 8) * es, es, w);
      decode_words(w, a.dt, v);
      float4* d = reinterpret_cast<float4*>(slot + (Q::ar(u) * G::F32_LDA + Q::ac(u) * 8) * 4);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  if (b.dt != DT_F32) {
    const int es = dt_bytes(b.dt);
#pragma unroll
    for (int u = 0; u < G::CH_B; ++u) {
      uint4 w[2];
      float v[8];
      load_words(raw + G::RAW_A + (Q::bk(u) * T + Q::bn(u) * 8) * es, es, w);
      decode_words(w, b.dt, v);
      float4* d = reinterpret_cast<float4*>(slot + G::F32_A + (Q::bk(u) * T + Q::bn(u) * 8) * 4);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// acc += A . B over one fp32 slot: per 4 k, RM float4 reads of A rows and
// two float4 reads of each B row, one fp32 FMA chain per element.
template <int T>
__device__ __forceinline__ void fma_stage(float (&acc)[Big<T>::ACC], const unsigned char* slot) {
  using G = Big<T>;
  using F = F32Geo<T>;
  const float* A = reinterpret_cast<const float*>(slot);
  const float* B = reinterpret_cast<const float*>(slot + G::F32_A);
#pragma unroll 2
  for (int k4 = 0; k4 < G::BK; k4 += 4) {
    float4 av[F::RM];
#pragma unroll
    for (int i = 0; i < F::RM; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + F::row(i) * G::F32_LDA + k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* brow = B + (k4 + kk) * T;
      const float4 b0 = *reinterpret_cast<const float4*>(brow + F::col(0));
      const float4 b1 = *reinterpret_cast<const float4*>(brow + F::col(4));
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < F::RM; ++i) {
        const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i * 8 + j] = __fmaf_rn(x, bv[j], acc[i * 8 + j]);
      }
    }
  }
}

// fp32 path over `steps` stages, two slots.  Iteration s: stage s + 1's
// copies are issued, stage s is multiplied from slot s & 1, then stage
// s + 1's raw operands (if any) are upcast into slot (s + 1) & 1.
template <int T, class Src>
__device__ __forceinline__ void dot_f32(float (&acc)[Big<T>::ACC], unsigned char* ring,
                                        int steps, const Src& src) {
  using G = Big<T>;
  unsigned char* raw = ring + G::F32_RAW;
  Opnd a, b;
  src.operands(0, src.codes(0), a, b);
  copy_f32<T>(ring, raw, true, a, b);
  cp_async_wait<0>();
  __syncthreads();
  convert_f32<T>(ring, raw, a, b);
  Codes c1 = 1 < steps ? src.codes(1) : Codes{};   // stage s + 1's, an iteration ahead
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();   // stage s's copies are here
    __syncthreads();      // ... for every thread; stage s - 1's FMAs are done
    unsigned char* next = ring + ((s + 1) & 1) * G::F32_SLOT;
    const bool more = s + 1 < steps;
    if (more) src.operands(s + 1, c1, a, b);
    copy_f32<T>(next, raw, more, a, b);
    if (s + 2 < steps) c1 = src.codes(s + 2);
    fma_stage<T>(acc, ring + (s & 1) * G::F32_SLOT);
    if (more && (a.dt != DT_F32 || b.dt != DT_F32)) {   // uniform per block
      cp_async_wait<0>();
      __syncthreads();
      convert_f32<T>(next, raw, a, b);
    }
  }
}

// Each thread's accumulators from the fp32 tile at `init` (row stride T),
// in the layout the path keeps them in (see the epilogue of
// tile_dot_staged): the accumulate-into form starts a dot from a running
// sum, and since fp32 round-trips through memory exactly, a dot split over
// launches runs the same operations as one launch over all its stages.
template <int T>
__device__ __forceinline__ void load_acc(float (&acc)[Big<T>::ACC], const float* init,
                                         bool mma) {
  if (mma) {
    const int lane = threadIdx.x & 31;
    const int r0 = 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 u = *reinterpret_cast<const float2*>(init + r0 * T + c);
      const float2 v = *reinterpret_cast<const float2*>(init + (r0 + 8) * T + c);
      acc[4 * j] = u.x;
      acc[4 * j + 1] = u.y;
      acc[4 * j + 2] = v.x;
      acc[4 * j + 3] = v.y;
    }
  } else {
    using F = F32Geo<T>;
#pragma unroll
    for (int i = 0; i < F::RM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 u = *reinterpret_cast<const float4*>(init + F::row(i) * T + F::col(4 * h));
        acc[i * 8 + 4 * h] = u.x;
        acc[i * 8 + 4 * h + 1] = u.y;
        acc[i * 8 + 4 * h + 2] = u.z;
        acc[i * 8 + 4 * h + 3] = u.w;
      }
  }
}

// The staged dot of one C tile: stages 0..steps-1 of BK = 64 k each,
// operands from the source `src` (see Codes); the tensor-core path for a bf16/fp16
// compute dtype `ct`, else fp32 FMA.  The accumulators start at zero, or
// from the fp32 tile `init` (row stride T) when it is given.  Leaves the
// fp32 tile in shared memory ([T][OUT_LD], reusing the ring) and returns
// it; every thread of the block must call it.
template <int T, class Src>
__device__ __forceinline__ float* tile_dot_staged(unsigned char* smem_raw, int steps, int ct,
                                                  const Src& src,
                                                  const float* init = nullptr) {
  using G = Big<T>;
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* out = reinterpret_cast<float*>(ring);
  float acc[G::ACC];
#pragma unroll
  for (int i = 0; i < G::ACC; ++i) acc[i] = 0.0f;
  const bool mma = ct == DT_BF16 || ct == DT_F16;   // uniform per block
  if (init) load_acc<T>(acc, init, mma);            // uniform per launch
  if (ct == DT_BF16) dot_mma<T, DT_BF16>(acc, ring, steps, src);
  else if (ct == DT_F16) dot_mma<T, DT_F16>(acc, ring, steps, src);
  else dot_f32<T>(acc, ring, steps, src);
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for the epilogue tile
  if (mma) {
    // wgmma accumulator layout: warp w of warpgroup g holds rows
    // 64g + 16w + lane/4 (+ 8) and column pairs 8j + 2 (lane % 4)
    const int lane = threadIdx.x & 31;
    const int r0 = 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + r0 * G::OUT_LD + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (r0 + 8) * G::OUT_LD + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  } else {
    using F = F32Geo<T>;
#pragma unroll
    for (int i = 0; i < F::RM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(out + F::row(i) * G::OUT_LD + F::col(4 * h)) =
            make_float4(acc[i * 8 + 4 * h], acc[i * 8 + 4 * h + 1], acc[i * 8 + 4 * h + 2],
                        acc[i * 8 + 4 * h + 3]);
  }
  __syncthreads();
  return out;
}

// Store the staged dot's tile: v = alpha * acc + beta * C when C is given
// (C's class buffer, element (r, q) at c0 + r * ldc + q; the tile kernel),
// else v = acc (the grouped kernel); integer classes (qmax > 0) get one
// NaN-propagating absmax quantize-dequantize over the whole tile.  v goes
// to buffer o[cls] at o0 + r * ldo + q; with `others`, zeros go to the
// other nf - 1 buffers.  A thread owns CPT chunks of 8 elements along a
// row; all its C reads are issued before any store, then 8-element vector
// stores follow.  Every thread of the block must call it.
template <int T>
__device__ __forceinline__ void store_tile(float* out, const void* C, int cdt, long long c0,
                                           long long ldc, float alpha, float beta, int qmax,
                                           void* const* o, const int* odt, int nf, int cls,
                                           long long o0, long long ldo, bool others) {
  using G = Big<T>;
  constexpr int CH = T / 8;                 // 8-element chunks per row
  constexpr int CPT = T * CH / G::NTH;      // chunks per thread
  float* red = out + G::RING / 4;
  uint4 cw[CPT][2];
  if (C) {
    const int ce = dt_bytes(cdt);
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int q = threadIdx.x + u * G::NTH, r = q / CH, c = (q % CH) * 8;
      load_words(reinterpret_cast<const unsigned char*>(C) + (c0 + r * ldc + c) * ce, ce, cw[u]);
    }
  }
  float amax = 0.0f;
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int q = threadIdx.x + u * G::NTH, r = q / CH, c = (q % CH) * 8;
    float* t = out + r * G::OUT_LD + c;
    const float4 x = *reinterpret_cast<const float4*>(t);
    const float4 y = *reinterpret_cast<const float4*>(t + 4);
    float v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
    if (C) {
      float cv[8];
      decode_words(cw[u], cdt, cv);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __fadd_rn(__fmul_rn(alpha, v[k]), __fmul_rn(beta, cv[k]));
    }
    if (qmax > 0) {   // uniform per block
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        t[k] = v[k];
        amax = nanmax(amax, fabsf(v[k]));
      }
      continue;
    }
    const long long e = o0 + r * ldo + c;
    for (int code = 0; code < nf; ++code) {
      if (code == cls) store8(o[code], odt[code], e, v);
      else if (others) zero8(o[code], odt[code], e);
    }
  }
  if (qmax <= 0) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nanmax(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
  for (int w = 1; w < G::NTH / 32; ++w) amax = nanmax(amax, red[w]);
  const float fq = static_cast<float>(qmax);
  const float scale = amax > 0.0f ? __fdiv_rn(amax, fq) : 1.0f;
#pragma unroll
  for (int u = 0; u < CPT; ++u) {   // the same chunks as above
    const int q = threadIdx.x + u * G::NTH, r = q / CH, c = (q % CH) * 8;
    const float* t = out + r * G::OUT_LD + c;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float x = rintf(__fdiv_rn(t[k], scale));
      x = x < -fq ? -fq : (x > fq ? fq : x);   // NaN stays NaN
      v[k] = __fmul_rn(x, scale);
    }
    const long long e = o0 + r * ldo + c;
    for (int code = 0; code < nf; ++code) {
      if (code == cls) store8(o[code], odt[code], e, v);
      else if (others) zero8(o[code], odt[code], e);
    }
  }
}
