// Split-accumulation tile-centric GEMM, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/split_gemm.py
// (split_gemm_tile_multi -> pallas_call, body _kernel, dot _spec_dot):
//
//     C <- alpha * A . B + beta * C
//
// over per-format buffers (MPMatrix.bufs) and tile class maps, like the
// tile kernel (csrc/mp_gemm_tile.cu), plus split compound C classes: for
// a C tile whose format is a split format (split2_fp16, split3_e5m2) A
// and B are split into `slices` slices (slice i is the slice-dtype
// rounding of the residual left by slices 0..i-1, as
// repro.core.formats.split_slices), and per k tile the slices^2 pair dots
// run in slice_pair_order (the order comes from the host) with fp32
// accumulation.  Simple classes (slices = 1) take the tile kernel's dot.
// The store writes a split class's split round trip, an integer class's
// per-tile absmax quantize-dequantize, and zeros into every other
// class's buffer.
//
// What bounds it on an H100: a split2 C tile does 4x, a split3 tile 9x
// the multiply-adds of a plain tile.  Every slice is exact in the
// format's compute dtype (fp16 slices in fp16; e5m2 slices, subnormals
// and inf included, in bf16) and every product of two slices is exact in
// fp32, so the passes belong on the tensor cores (989 TFLOP/s dense at
// fp16/bf16): at 4096^3 that is far above the ridge point, bound by
// operations.  At the solve's trailing update (K = t) the bytes of C
// written into every class buffer come close behind.
//
// Design at t = 64 and 128:
//   - the slices are made once per launch, not once per C tile: a
//     separate elementwise pass (split_prep_launch) reads every A and B
//     element from the buffer its tile's class names, splits it with the
//     reference's steps and writes slice s of A to sa [s][M][K] and of B
//     to sb [s][K][N] (workspaces the wrapper allocates), stored in the
//     class's compute dtype;
//   - a split C tile runs tile_dot.cuh's staged dot through SliceSource:
//     its stages walk (k tile, pair in slice_pair_order, 64-wide k
//     sub-stage), each stage's operands are slice tiles already in the
//     compute dtype, so they go by cp.async straight into the swizzled
//     wgmma layouts (no conversion, B never transposed), and the wgmma
//     (fp16 or bf16 m64 x t x k16) accumulate every stage into one fp32
//     accumulator.  That reorders the K * slices^2 exact products inside
//     fp32 accumulation, which the split order allowance covers
//     (kernels/split_gemm.py::order_allowance; the tensor cores'
//     truncating sum is modelled against it in
//     tests/test_torch_tc_accumulation.py);
//   - a simple C tile runs the same staged dot with the tile kernel's
//     addressing (wgmma for bf16/fp16 classes, the fp32 register tile
//     for fp32 and integer classes);
//   - epilogue: alpha * acc + beta * C and the split round trip in shared
//     memory for a split class, then tile_dot.cuh's vector store.
// At t = 16 and 32 (wgmma needs 64 rows) a 32 x 32 thread grid keeps the
// earlier design: slices staged per k tile in shared memory in their
// slice dtype, pair dots on the fp32 pipes, simple classes on dot_simple.
// Its order of sums is fixed, and split/recovery.py::split_gemm_ref
// follows it operation for operation (bit for bit on the card).  No
// main-path shape uses those tiles.

#include "tile_dot.cuh"

constexpr int SP_MAX_NF = 3;
constexpr int SP_MAX_PAIRS = 9;

struct SplitArgs {
  const void* a[SP_MAX_NF];   // [M, K] per class code
  const void* b[SP_MAX_NF];   // [K, N]
  const void* c[SP_MAX_NF];   // [M, N]
  void* o[SP_MAX_NF];         // [M, N] outputs
  void* sa[SP_MAX_NF];        // split class at t >= 64: A's slices [slices][M][K]
  void* sb[SP_MAX_NF];        // ... and B's [slices][K][N], in the compute dtype
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

// ---------------------------------------------------------------------------
// The slice pass (t = 64, 128)
// ---------------------------------------------------------------------------

// One operand of the slice pass: X [rows, cols] read tile by tile from the
// buffer its class map names, slices written to out [S][rows][cols].
struct SliceOp {
  const void* x[SP_MAX_NF];
  int xdt[SP_MAX_NF];
  const int* map;             // [rows/t, cols/t]
  void* out;
  int rows, cols;
};

// Each thread takes 8 consecutive elements (one tile, one class): upcast
// exactly, then per slice the slice-dtype rounding, its exact value
// stored in the compute dtype ODT (exact: checked by the launch), and the
// residual left for the next slice — the steps of Slice<SDT> and of
// split_slices, so the slices are bit for bit the reference's.
template <int S, int SDT, int ODT>
__global__ void __launch_bounds__(256) split_slices_kernel(const SliceOp A, const SliceOp B,
                                                           int tile) {
  using SL = Slice<SDT>;
  const long long na = static_cast<long long>(A.rows) * A.cols / 8;
  const long long nb = static_cast<long long>(B.rows) * B.cols / 8;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; q < na + nb;
       q += step) {
    const bool in_a = q < na;
    const SliceOp& op = in_a ? A : B;
    const long long e = (in_a ? q : q - na) * 8;
    const int r = static_cast<int>(e / op.cols), col = static_cast<int>(e % op.cols);
    const int code = op.map[(r / tile) * (op.cols / tile) + col / tile];
    const int dt = op.xdt[code];
    uint4 w[2];
    float v[8];
    load_words(reinterpret_cast<const unsigned char*>(op.x[code]) + e * dt_bytes(dt),
               dt_bytes(dt), w);
    decode_words(w, dt, v);
    const long long plane = static_cast<long long>(op.rows) * op.cols;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float sv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sv[i] = SL::value(SL::bits(v[i]));
        v[i] = __fsub_rn(v[i], sv[i]);
      }
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned short*>(op.out) + s * plane + e) =
          pack8(sv, ODT);
    }
  }
}

// ---------------------------------------------------------------------------
// The staged GEMM (t = 64, 128)
// ---------------------------------------------------------------------------

// Stage s of a split C tile (i, j) of class cls: s = (kk * P + p) * SUB +
// u walks k tile kk, pair p of slice_pair_order (P = slices^2 pairs) and
// 64-wide sub-stage u of the k tile; the operands are slice tiles of the
// workspaces, already in the compute dtype (no class map to read).
template <int T>
struct SliceSource {
  static constexpr int SUB = T / Big<T>::BK;
  const SplitArgs& a;
  int i, j, cls, P;
  __device__ Codes codes(int) const { return Codes{}; }
  __device__ void operands(int s, const Codes&, Opnd& x, Opnd& y) const {
    const int u = s % SUB, q = s / SUB;
    const int p = q % P, kk = q / P;
    const int pr = a.pairs[cls][p];
    const long long k0 = static_cast<long long>(kk) * T + u * Big<T>::BK;
    const long long M = a.M, K = a.K, N = a.N;
    x = {a.sa[cls], a.comp[cls], (pr >> 2) * M * K + static_cast<long long>(i) * T * K + k0, K};
    y = {a.sb[cls], a.comp[cls], (pr & 3) * K * N + k0 * N + static_cast<long long>(j) * T, N};
  }
};

// A split class's epilogue on the staged dot's tile in shared memory:
// v = roundtrip(alpha * acc + beta * C), in place (C of the class's
// buffer read by 8-element vector loads, all issued first).
template <int T>
__device__ __forceinline__ void split_epilogue(float* out, const SplitArgs& a, int cls,
                                               long long c0) {
  using G = Big<T>;
  constexpr int CH = T / 8;
  constexpr int CPT = T * CH / G::NTH;
  const int cdt = a.cdt[cls], ce = dt_bytes(cdt);
  uint4 cw[CPT][2];
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int q = threadIdx.x + u * G::NTH, r = q / CH, c = (q % CH) * 8;
    load_words(reinterpret_cast<const unsigned char*>(a.c[cls]) + (c0 + r * a.N + c) * ce, ce,
               cw[u]);
  }
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int q = threadIdx.x + u * G::NTH, r = q / CH, c = (q % CH) * 8;
    float cv[8];
    decode_words(cw[u], cdt, cv);
    float* t = out + r * G::OUT_LD + c;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      t[k] = roundtrip_any(__fadd_rn(__fmul_rn(a.alpha, t[k]), __fmul_rn(a.beta, cv[k])),
                           a.slices[cls], a.sdt[cls]);
  }
  __syncthreads();
}

template <int T>
__global__ void __launch_bounds__(Big<T>::NTH, 1) split_gemm_staged(const SplitArgs a) {
  extern __shared__ unsigned char smem[];
  const int j = blockIdx.x, i = blockIdx.y;
  const int cls = a.pc[i * (a.N / T) + j];
  const int S = a.slices[cls];   // uniform per block
  const long long c0 = static_cast<long long>(i) * T * a.N + static_cast<long long>(j) * T;
  if (S == 1) {
    float* out = tile_dot_staged<T>(smem, a.K / Big<T>::BK, a.comp[cls],
                                    TileSource<T, SplitArgs>{a, i, j});
    store_tile<T>(out, a.c[cls], a.cdt[cls], c0, a.N, a.alpha, a.beta, a.qmax[cls], a.o, a.odt,
                  a.nf, cls, c0, a.N, true);
    return;
  }
  float* out = tile_dot_staged<T>(smem, a.K / Big<T>::BK * S * S, a.comp[cls],
                                  SliceSource<T>{a, i, j, cls, S * S});
  split_epilogue<T>(out, a, cls, c0);
  store_tile<T>(out, nullptr, 0, 0, 0, 1.0f, 0.0f, 0, a.o, a.odt, a.nf, cls, c0, a.N, true);
}

// ---------------------------------------------------------------------------
// The simple design (t = 16, 32)
// ---------------------------------------------------------------------------

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

// The split classes' specs are ones the kernels implement: 2 or 3 slices
// of fp16 or e5m2; at t >= 64 a compute dtype that holds every slice
// exactly (fp16 for fp16 slices, fp16 or bf16 for e5m2 ones) and the
// slice workspaces.
bool specs_ok(const SplitArgs& a, bool staged) {
  for (int f = 0; f < a.nf; ++f) {
    if (a.slices[f] < 1 || a.slices[f] > 3) return false;
    if (a.slices[f] == 1) continue;
    if (a.sdt[f] != DT_F16 && a.sdt[f] != DT_E5M2) return false;
    if (!staged) continue;
    const bool exact = a.comp[f] == DT_F16 || (a.comp[f] == DT_BF16 && a.sdt[f] == DT_E5M2);
    if (!exact) return false;
  }
  return true;
}

template <int T>
int launch_simple(const SplitArgs& a, cudaStream_t st) {
  int smem = Geo<T>::SIMPLE_SMEM;
  for (int f = 0; f < a.nf; ++f) {
    if (a.slices[f] == 1) continue;
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

template <int T>
int launch_staged(const SplitArgs& a, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(split_gemm_staged<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, Big<T>::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  split_gemm_staged<T><<<dim3(a.N / T, a.M / T), Big<T>::NTH, Big<T>::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int S, int SDT, int ODT>
int launch_slices(const SliceOp& A, const SliceOp& B, int tile, cudaStream_t st) {
  const long long chunks = (static_cast<long long>(A.rows) * A.cols +
                            static_cast<long long>(B.rows) * B.cols) / 8;
  const long long want = (chunks + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  split_slices_kernel<S, SDT, ODT><<<blocks, 256, 0, st>>>(A, B, tile);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(const SplitArgs& a, int tile) {
  return a.nf >= 1 && a.nf <= SP_MAX_NF && !(a.M % tile) && !(a.K % tile) && !(a.N % tile) &&
         a.M >= tile && a.K >= tile && a.N >= tile;
}

}  // namespace

// Launch the GEMM on `stream`; at t = 64 and 128 the slice workspaces of
// every split class present in pc must have been filled by
// split_prep_launch on the same stream (the others are never read).  Returns the cudaError_t of the launch (0 = ok).
extern "C" int split_gemm_launch(const SplitArgs* args, int tile, int device, void* stream) {
  const SplitArgs a = *args;
  if (!shape_ok(a, tile) || !specs_ok(a, tile >= 64)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 16: return launch_simple<16>(a, st);
    case 32: return launch_simple<32>(a, st);
    case 64: return launch_staged<64>(a, st);
    case 128: return launch_staged<128>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The slice pass of split class `cls` (t = 64 and 128): the slices of A
// into sa[cls] and of B into sb[cls], in comp[cls].  Classes that share
// a split spec share the workspaces, so one pass per spec suffices.
// Returns the cudaError_t of the launch (0 = ok).
extern "C" int split_prep_launch(const SplitArgs* args, int cls, int tile, int device,
                                 void* stream) {
  const SplitArgs a = *args;
  if (!shape_ok(a, tile) || (tile != 64 && tile != 128) || !specs_ok(a, true) || cls < 0 ||
      cls >= a.nf || a.slices[cls] < 2 || !a.sa[cls] || !a.sb[cls])
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SliceOp A{}, B{};
  for (int f = 0; f < a.nf; ++f) {
    A.x[f] = a.a[f];
    A.xdt[f] = a.adt[f];
    B.x[f] = a.b[f];
    B.xdt[f] = a.bdt[f];
  }
  A.map = a.pa;
  A.out = a.sa[cls];
  A.rows = a.M;
  A.cols = a.K;
  B.map = a.pb;
  B.out = a.sb[cls];
  B.rows = a.K;
  B.cols = a.N;
  const int s = a.slices[cls], sdt = a.sdt[cls], odt = a.comp[cls];
  if (sdt == DT_F16)
    return s == 2 ? launch_slices<2, DT_F16, DT_F16>(A, B, tile, st)
                  : launch_slices<3, DT_F16, DT_F16>(A, B, tile, st);
  if (odt == DT_BF16)
    return s == 2 ? launch_slices<2, DT_E5M2, DT_BF16>(A, B, tile, st)
                  : launch_slices<3, DT_E5M2, DT_BF16>(A, B, tile, st);
  return s == 2 ? launch_slices<2, DT_E5M2, DT_F16>(A, B, tile, st)
                : launch_slices<3, DT_E5M2, DT_F16>(A, B, tile, st);
}
