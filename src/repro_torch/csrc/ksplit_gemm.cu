// Class-split GEMM for MPLinear over a KSplitWeight, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ksplit_gemm.py
// (ksplit_gemm_multi -> _one_class -> pallas_call, body _gemm_kernel):
//
//     y[M, N] = sum_f  x[:, off_f : off_f + K_f] . w_f        (fp32 out)
//
// where segment f is stored in its format's storage dtype (fp32 / bf16 /
// fp16 / fp8) and multiplied at that format's compute dtype: x is rounded
// to the compute dtype, w is upcast, the product is exact in fp32 for
// every 16-bit-or-narrower compute dtype, and sums are fp32.
//
// What bounds it on an H100: on the serve path M is the decode batch
// (1..4), so the weight bytes dominate (2048 x 8192 at half fp32, half
// bf16 is 50 MB against 64 KB of activations) — it is memory-bound, and
// its floor is the weight bytes over 3.35 TB/s.
//
// Design: ONE launch covers all segments.  A block owns 32 output columns
// (one per lane) and MS rows (MS = 1, 2, 4 or 8 by M; grid.y covers
// larger M; rows beyond M are masked).  Its 32 warps stream the weight
// strip cooperatively: K, taken in storage order across the segments, is
// cut into chunks of 64; warp w computes the partial sum of chunk
// (round*32 + w) with a sequential fp32 FMA chain in registers, walking
// the segments that chunk intersects in storage order.  The partials go
// through shared memory and are added to the accumulator in chunk order.
// So every output element is summed in ONE fixed order —
//
//     y = ((p_0 + p_1) + p_2) + ...,   p_c = fma-chain over chunk c, k ascending
//
// which depends only on K and the segment layout: never on M, on MS, on
// the grid, or on the row's index.  A row therefore rounds identically
// whether it is served alone or in a batch (batch invariance), with no
// split of K across blocks and no atomics.  Reads of w are coalesced
// (32 lanes on 32 consecutive columns); x values are warp-broadcast loads.
// wgmma/TMA and a tensor-core path for large M come later.

#include "common.cuh"

constexpr int KS_COLS = 32;    // output columns per block (one per lane)
constexpr int KS_WARPS = 32;   // warps per block = chunks per round
constexpr int KS_CHUNK = 64;   // k per partial sum
constexpr int KS_MAX_SEG = 3;

struct Seg {
  const void* w;   // [klen, N] row-major, storage dtype wdt
  int wdt;         // storage dtype code
  int cdt;         // compute dtype code (DT_F32 / DT_BF16 / DT_F16)
  int k0;          // first column of x this segment consumes
  int klen;        // rows of w
};

struct KSArgs {
  Seg seg[KS_MAX_SEG];
  const void* x;   // [M, K] row-major, dtype xdt (fp32 or bf16)
  float* y;        // [M, N] fp32
  int nseg;
  int xdt;
  int M, K, N;
};

namespace {

// p[r] += round(x[r, k]) * w[k, n] for k in [lo, hi), k ascending.
template <int MS, int XDT, int WDT, int CT>
__device__ __forceinline__ void seg_chunk(const KSArgs& a, const Seg& s,
                                          int lo, int hi, int n, int m0,
                                          int mrows, float (&p)[MS]) {
  const long long N = a.N;
  const long long K = a.K;
#pragma unroll 8
  for (int k = lo; k < hi; ++k) {
    float w = load_t<WDT>(s.w, static_cast<long long>(k - s.k0) * N + n);
    if constexpr (CT != DT_F32) w = round_to(w, CT);
#pragma unroll
    for (int r = 0; r < MS; ++r) {
      const int rr = r < mrows ? r : mrows - 1;   // masked rows reread row 0..M-1
      float xv = load_t<XDT>(a.x, static_cast<long long>(m0 + rr) * K + k);
      // a bf16 x needs no rounding for a bf16 or fp32 compute dtype
      if constexpr (CT == DT_F16 || (CT == DT_BF16 && XDT != DT_BF16))
        xv = round_to(xv, CT);
      p[r] = __fmaf_rn(xv, w, p[r]);
    }
  }
}

template <int MS, int XDT, int WDT>
__device__ __forceinline__ void seg_chunk_ct(const KSArgs& a, const Seg& s,
                                             int lo, int hi, int n, int m0,
                                             int mrows, float (&p)[MS]) {
  switch (s.cdt) {
    case DT_BF16: seg_chunk<MS, XDT, WDT, DT_BF16>(a, s, lo, hi, n, m0, mrows, p); break;
    case DT_F16: seg_chunk<MS, XDT, WDT, DT_F16>(a, s, lo, hi, n, m0, mrows, p); break;
    default: seg_chunk<MS, XDT, WDT, DT_F32>(a, s, lo, hi, n, m0, mrows, p); break;
  }
}

template <int MS, int XDT>
__device__ __forceinline__ void seg_chunk_w(const KSArgs& a, const Seg& s,
                                            int lo, int hi, int n, int m0,
                                            int mrows, float (&p)[MS]) {
  switch (s.wdt) {
    case DT_F32: seg_chunk_ct<MS, XDT, DT_F32>(a, s, lo, hi, n, m0, mrows, p); break;
    case DT_BF16: seg_chunk_ct<MS, XDT, DT_BF16>(a, s, lo, hi, n, m0, mrows, p); break;
    case DT_F16: seg_chunk_ct<MS, XDT, DT_F16>(a, s, lo, hi, n, m0, mrows, p); break;
    case DT_E4M3: seg_chunk_ct<MS, XDT, DT_E4M3>(a, s, lo, hi, n, m0, mrows, p); break;
    default: seg_chunk_ct<MS, XDT, DT_E5M2>(a, s, lo, hi, n, m0, mrows, p); break;
  }
}

template <int MS, int XDT>
__global__ void __launch_bounds__(KS_COLS * KS_WARPS)
ksplit_gemm_kernel(const KSArgs a) {
  __shared__ float part[KS_WARPS][MS][KS_COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * KS_COLS + lane;
  const int m0 = blockIdx.y * MS;
  const int mrows = min(MS, a.M - m0);
  const int nchunks = (a.K + KS_CHUNK - 1) / KS_CHUNK;
  float acc = 0.0f;   // warp r < MS, lane l: output (m0 + r, n)

  for (int c0 = 0; c0 < nchunks; c0 += KS_WARPS) {
    float p[MS];
#pragma unroll
    for (int r = 0; r < MS; ++r) p[r] = 0.0f;
    const int c = c0 + warp;
    if (c < nchunks && n < a.N) {
      const int kbeg = c * KS_CHUNK;
      const int kend = min(a.K, kbeg + KS_CHUNK);
      for (int si = 0; si < a.nseg; ++si) {   // storage order
        const Seg& s = a.seg[si];
        const int lo = max(kbeg, s.k0);
        const int hi = min(kend, s.k0 + s.klen);
        if (lo < hi) seg_chunk_w<MS, XDT>(a, s, lo, hi, n, m0, mrows, p);
      }
    }
#pragma unroll
    for (int r = 0; r < MS; ++r) part[warp][r][lane] = p[r];
    __syncthreads();
    if (warp < MS) {
      const int last = min(KS_WARPS, nchunks - c0);
      for (int j = 0; j < last; ++j) acc = __fadd_rn(acc, part[j][warp][lane]);
    }
    __syncthreads();
  }
  if (warp < mrows && n < a.N)
    a.y[static_cast<long long>(m0 + warp) * a.N + n] = acc;
}

template <int MS>
void launch_ms(const KSArgs& a, cudaStream_t st) {
  dim3 grid((a.N + KS_COLS - 1) / KS_COLS, (a.M + MS - 1) / MS);
  dim3 block(KS_COLS * KS_WARPS);
  if (a.xdt == DT_BF16)
    ksplit_gemm_kernel<MS, DT_BF16><<<grid, block, 0, st>>>(a);
  else
    ksplit_gemm_kernel<MS, DT_F32><<<grid, block, 0, st>>>(a);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int ksplit_gemm_launch(const KSArgs* args, int device, void* stream) {
  const KSArgs a = *args;
  if (a.nseg < 1 || a.nseg > KS_MAX_SEG || a.M < 1 || a.N < 1 || a.K < 1 ||
      (a.xdt != DT_F32 && a.xdt != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.M == 1) launch_ms<1>(a, st);
  else if (a.M == 2) launch_ms<2>(a, st);
  else if (a.M <= 4) launch_ms<4>(a, st);
  else launch_ms<8>(a, st);
  return static_cast<int>(cudaGetLastError());
}
