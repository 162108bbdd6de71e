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
// What bounds it on an H100: operations.  At M = N = K = 4096 it does
// 2*M*N*K = 137 GFLOP against ~0.3 GB of buffers, far above the card's
// ridge point: a bf16/fp16-class C tile (fp8 storage classes compute in
// bf16) is bound by the tensor cores (989 TFLOP/s dense), an fp32 or
// integer-class tile by the fp32 FMA pipes (67 TFLOP/s; TF32 is not
// allowed).  The solve's GEMMs have fp32-class C, so they are bound by
// fp32 operations, at its trailing update (K = t) with the bytes of C
// written into every class buffer close behind.
//
// Design: one block per C tile, looping over k (blocks run in parallel in
// any order, so the TPU's sequential k grid axis becomes this loop and the
// accumulator stays in registers).  For each k tile the block reads the A
// and B tiles only from the buffer their class maps name (bit-identical to
// the reference's sum of upcasts, where the other buffers are zero).  At
// t = 64 and 128 it runs tile_dot.cuh's staged dot: operands already in
// the C class's compute dtype by cp.async straight into shared memory,
// the others converted on the way, then wgmma on the tensor cores for a
// bf16/fp16 class or an 8 x 8 register tile of fp32 FMAs otherwise; the
// epilogue (alpha/beta with C read by vector loads, the integer classes'
// absmax quantize-dequantize, 8-element vector stores into every class
// buffer) goes through shared memory.  At t = 16 and 32 (wgmma needs 64
// rows) it keeps the simple dot and epilogue it shares with the split
// kernel.

#include "tile_dot.cuh"

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

template <int T>
__global__ void __launch_bounds__(Geo<T>::NTH)
mp_gemm_tile_kernel(const TileArgs a) {
  using G = Geo<T>;
  __shared__ float smem[G::SIMPLE_SMEM / 4];
  __shared__ float red[(G::NTH + 31) / 32];

  const int j = blockIdx.x, i = blockIdx.y;
  const int nt = a.N / T, kt = a.K / T;
  const int cls = a.pc[i * nt + j];

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
    dot_simple<T>(acc, smem, a.a[ca], a.adt[ca], a0, a.K, a.b[cb], a.bdt[cb], b0, a.N,
                  a.comp[cls]);
  }

  const long long c0 = static_cast<long long>(i) * T * a.N + static_cast<long long>(j) * T;
  axpby_c<T>(acc, a.c[cls], a.cdt[cls], c0, a.N, a.alpha, a.beta);
  if (a.qmax[cls] > 0) quantize_tile<T>(acc, a.qmax[cls], red);   // uniform per block
  store_classes<T>(acc, a.o, a.odt, a.nf, cls, c0, a.N);
}

template <int T>
__global__ void __launch_bounds__(Big<T>::NTH, 1)
mp_gemm_tile_staged(const TileArgs a) {
  extern __shared__ unsigned char smem[];
  const int j = blockIdx.x, i = blockIdx.y;
  const int cls = a.pc[i * (a.N / T) + j];
  float* out = tile_dot_staged<T>(smem, a.K / Big<T>::BK, a.comp[cls],
                                  TileSource<T, TileArgs>{a, i, j});
  const long long c0 = static_cast<long long>(i) * T * a.N + static_cast<long long>(j) * T;
  store_tile<T>(out, a.c[cls], a.cdt[cls], c0, a.N, a.alpha, a.beta, a.qmax[cls], a.o, a.odt,
                a.nf, cls, c0, a.N, true);
}

template <int T>
int launch_staged(const TileArgs& a, int smem, cudaStream_t st) {
  if (smem != Big<T>::SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(mp_gemm_tile_staged<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mp_gemm_tile_staged<T><<<dim3(a.N / T, a.M / T), Big<T>::NTH, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; `smem` is the staged dot's dynamic shared memory
// (kernels/mp_gemm_tile.py's launch plan; ignored at t < 64).  Returns the
// cudaError_t of the launch (0 = ok).
extern "C" int mp_gemm_tile_launch(const TileArgs* args, int tile, int smem, int device,
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
    case 16: mp_gemm_tile_kernel<16><<<grid, Geo<16>::NTH, 0, st>>>(a); break;
    case 32: mp_gemm_tile_kernel<32><<<grid, Geo<32>::NTH, 0, st>>>(a); break;
    case 64: return launch_staged<64>(a, smem, st);
    case 128: return launch_staged<128>(a, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
