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
// accumulator stays in registers).  For each k tile the block reads the A
// and B tiles only from the buffer their class maps name (bit-identical to
// the reference's sum of upcasts, where the other buffers are zero) and
// runs tile_dot.cuh's dot_simple: operands rounded to the C class's
// compute dtype while staged in shared memory, one sequential fp32 FMA
// chain per element.  The epilogue is tile_dot.cuh's too (alpha/beta,
// the integer classes' NaN-propagating absmax quantize-dequantize, the
// per-class store), shared with the split kernel.  wgmma/TMA and
// tensor-core classes come later.

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
    case 16: mp_gemm_tile_kernel<16><<<grid, Geo<16>::NTH, 0, st>>>(a); break;
    case 32: mp_gemm_tile_kernel<32><<<grid, Geo<32>::NTH, 0, st>>>(a); break;
    case 64: mp_gemm_tile_kernel<64><<<grid, Geo<64>::NTH, 0, st>>>(a); break;
    case 128: mp_gemm_tile_kernel<128><<<grid, Geo<128>::NTH, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
