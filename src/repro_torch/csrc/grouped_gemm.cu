// Grouped GEMM over compact class-sorted tiles (CompactMPMatrix),
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_gemm.py
// (grouped_mp_gemm -> _grouped_class_call -> pallas_call, body _kernel):
//
//     C = A . B
//
// A and B arrive as one compact tile array per format (tiles[code] of
// shape [n_code, t, t]) with class and slot maps; the output C map names
// each C tile's class, and C comes back as one compact array per class,
// slots in row-major order within the class (CompactMPMatrix.make_slots).
// Each C tile is computed at its class's compute dtype (receiver-side
// conversion), accumulated in fp32, and integer classes get one absmax
// quantize-dequantize per tile.
//
// The accumulate-into form (SUMMA's local update, one launch per k-panel;
// the reference passes the fp32 output spec (compute, precision,
// "float32") to _grouped_class_call there): the outputs are fp32 running
// sums, each C tile's accumulator starts from its output tile and the sum
// is written back in place, with no storage rounding and no per-tile
// quantization.  A block reads its own tile before writing it, so the
// launches of a k loop split one panel per launch run the same operations
// as one launch over every panel.
//
// The TPU kernel fetched one candidate tile from every format buffer at
// every k step and routed mismatched classes to an appended zero tile,
// because a BlockSpec fetch cannot be skipped.  Here a block reads each
// A(i,k) and B(k,j) tile once, from the array and slot its class maps
// name: the bytes moved are the storage bytes.
//
// What bounds it on an H100: operations.  At 4096^3, t = 128 it does 137
// GFLOP against ~0.2 GB of compact tiles: the tensor cores (989 TFLOP/s)
// for bf16/fp16 compute classes (fp8 storage classes compute in bf16),
// the fp32 FMA pipes (67 TFLOP/s) for fp32 and integer classes.
//
// Design: ONE launch for all output classes over a host-built work list
// of (i, j, class, output slot), one block per C tile, the accumulator in
// registers over the k loop.  At t = 64 and 128 a block runs
// tile_dot.cuh's staged dot (cp.async of operands already in the compute
// dtype, conversion of the others on the way, wgmma for bf16/fp16
// classes, an fp32 FMA register tile otherwise) and its vector epilogue
// into the class's compact slot; a compact tile is one contiguous t x t
// block, so every row of a stage's slice is whole 16-byte chunks.  At t =
// 16 and 32 (wgmma needs 64 rows) it keeps the simple dot.

#include "tile_dot.cuh"

constexpr int GR_MAX_NF = 3;

struct GroupedArgs {
  const void* a[GR_MAX_NF];   // [n_code, t, t] compact A tiles per code
  const void* b[GR_MAX_NF];   // [n_code, t, t] compact B tiles per code
  void* o[GR_MAX_NF];         // [n_out_code, t, t] outputs per code
  const int* pa;              // [mt, kt] class map of A
  const int* a_slot;          // [mt, kt] slot of each A tile in its array
  const int* pb;              // [kt, nt]
  const int* b_slot;          // [kt, nt]
  const int* work;            // [n_work][4]: i, j, class, output slot
  int adt[GR_MAX_NF];         // tile dtype codes
  int bdt[GR_MAX_NF];
  int odt[GR_MAX_NF];
  int comp[GR_MAX_NF];        // compute dtype code per class
  int qmax[GR_MAX_NF];        // > 0: per-tile-scaled integer class
  int nf;
  int kt, nt;
  int n_work;
  int accumulate;             // 1: o[] are fp32 running sums, read then written
};

namespace {

template <int T>
__global__ void __launch_bounds__(Geo<T>::NTH)
grouped_gemm_kernel(const GroupedArgs a) {
  using G = Geo<T>;
  __shared__ float smem[G::SIMPLE_SMEM / 4];
  __shared__ float red[(G::NTH + 31) / 32];
  constexpr long long TT = static_cast<long long>(T) * T;

  const int* w = a.work + 4 * static_cast<long long>(blockIdx.x);
  const int i = w[0], j = w[1], cls = w[2], slot = w[3];
  const int tx = threadIdx.x % G::TDX, ty = threadIdx.x / G::TDX;

  const float* init = a.accumulate ? static_cast<const float*>(a.o[cls]) + slot * TT : nullptr;
  float acc[G::TMR][G::TMC];
#pragma unroll
  for (int r = 0; r < G::TMR; ++r)
#pragma unroll
    for (int q = 0; q < G::TMC; ++q)
      acc[r][q] = init ? init[(ty + G::TDY * r) * T + tx + G::TDX * q] : 0.0f;

  for (int kk = 0; kk < a.kt; ++kk) {
    const int ca = a.pa[i * a.kt + kk], sa = a.a_slot[i * a.kt + kk];
    const int cb = a.pb[kk * a.nt + j], sb = a.b_slot[kk * a.nt + j];
    dot_simple<T>(acc, smem, a.a[ca], a.adt[ca], sa * TT, T, a.b[cb], a.bdt[cb], sb * TT, T,
                  a.comp[cls]);
  }
  if (a.qmax[cls] > 0) quantize_tile<T>(acc, a.qmax[cls], red);   // uniform per block

  void* O = a.o[cls];
  const int odt = a.odt[cls];
#pragma unroll
  for (int r = 0; r < G::TMR; ++r)
#pragma unroll
    for (int q = 0; q < G::TMC; ++q)
      store_any(O, odt, slot * TT + (ty + G::TDY * r) * T + tx + G::TDX * q, acc[r][q]);
}

// Stage s of C tile (i, j): the compact A tile (i, kk) and B tile (kk, j)
// of k tile kk = s * BK / T, from the array and slot their classes name.
template <int T>
struct GroupedSource {
  const GroupedArgs& a;
  int i, j;
  __device__ Codes codes(int s) const {
    const int kk = s * Big<T>::BK / T;
    return {a.pa[i * a.kt + kk], a.a_slot[i * a.kt + kk], a.pb[kk * a.nt + j],
            a.b_slot[kk * a.nt + j]};
  }
  __device__ void operands(int s, const Codes& c, Opnd& x, Opnd& y) const {
    constexpr long long TT = static_cast<long long>(T) * T;
    const int ko = s * Big<T>::BK % T;
    x = {a.a[c.ca], a.adt[c.ca], c.sa * TT + ko, T};
    y = {a.b[c.cb], a.bdt[c.cb], c.sb * TT + ko * T, T};
  }
};

// ACCUM: the accumulate-into form, a kernel of its own so that the store
// form compiles as it did without it (no start-value path).
template <int T, bool ACCUM>
__global__ void __launch_bounds__(Big<T>::NTH, 1)
grouped_gemm_staged(const GroupedArgs a) {
  extern __shared__ unsigned char smem[];
  constexpr long long TT = static_cast<long long>(T) * T;
  const int* w = a.work + 4 * static_cast<long long>(blockIdx.x);
  const int i = w[0], j = w[1], cls = w[2], slot = w[3];
  const float* init = ACCUM ? static_cast<const float*>(a.o[cls]) + slot * TT : nullptr;
  float* out = tile_dot_staged<T>(smem, a.kt * (T / Big<T>::BK), a.comp[cls],
                                  GroupedSource<T>{a, i, j}, init);
  store_tile<T>(out, nullptr, 0, 0, 0, 1.0f, 0.0f, a.qmax[cls], a.o, a.odt, a.nf, cls,
                slot * TT, T, false);
}

template <int T, bool ACCUM>
int launch_staged(const GroupedArgs& a, int smem, cudaStream_t st) {
  if (smem != Big<T>::SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(grouped_gemm_staged<T, ACCUM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  grouped_gemm_staged<T, ACCUM><<<a.n_work, Big<T>::NTH, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; `smem` is the staged dot's dynamic shared memory
// (kernels/mp_gemm_tile.py's launch plan; ignored at t < 64).  Returns the
// cudaError_t of the launch (0 = ok).
extern "C" int grouped_gemm_launch(const GroupedArgs* args, int tile, int smem, int device,
                                   void* stream) {
  const GroupedArgs a = *args;
  if (a.nf < 1 || a.nf > GR_MAX_NF || a.kt < 1 || a.nt < 1 || a.n_work < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 16: grouped_gemm_kernel<16><<<a.n_work, Geo<16>::NTH, 0, st>>>(a); break;
    case 32: grouped_gemm_kernel<32><<<a.n_work, Geo<32>::NTH, 0, st>>>(a); break;
    case 64:
      return a.accumulate ? launch_staged<64, true>(a, smem, st)
                          : launch_staged<64, false>(a, smem, st);
    case 128:
      return a.accumulate ? launch_staged<128, true>(a, smem, st)
                          : launch_staged<128, false>(a, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
