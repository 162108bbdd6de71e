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
// to the compute dtype, w is upcast (and rounded where the storage dtype
// does not fit the compute dtype exactly), the product is exact in fp32
// for every 16-bit-or-narrower compute dtype, and sums are fp32.
//
// What bounds it on an H100: on the serve path M is the decode batch
// (1..4), so the weight bytes dominate (2048 x 8192 at half fp32, half
// bf16 is 50 MB against 64 KB of activations) — it is memory-bound, and
// its floor is the weight bytes over 3.35 TB/s.  At N = 1024 and 2048
// (wk, wv, wq) that floor is 2-4 us, under the launch latency.
//
// The order every output element is summed in is fixed by K and the
// segment layout alone — never by M, the grid or the block shape:
//
//     y = ((0 + p_0) + p_1) + ...,   p_c = fma-chain over chunk c (64 k), k ascending
//
// so a row rounds identically whether it is served alone or in a batch
// (batch invariance), and the kernel gives the bits of its earlier design.
//
// Design: ONE launch covers all segments.  A thread owns 8 consecutive
// output columns (one 16-byte weight load per k row for bf16/fp16, two
// for fp32, 8 bytes for fp8), so a warp covers a 256-column strip with
// coalesced rows; a block owns one strip and MS rows (MS = 1, 2, 4 or 8
// by M; grid.y covers larger M; rows beyond M are masked).  Each warp
// computes the partials of whole chunks: it stages the chunk's x rows in
// shared memory, already rounded to each segment's compute dtype, then
// runs the FMA chains over the segments the chunk intersects, in storage
// order, with batches of 32 rows of weights (16 of fp32, half that at
// MS = 8) in flight, kept ahead of the FMAs by volatile loads (as plain
// loads the compiler interleaved them with the FMAs, one or two in
// flight).  At decode widths a launch is bound less by its bytes than by
// one warp's latency chain — launch, x and weight latencies, the
// partial's store, the arrival, the final sum — so the design keeps that
// chain short.  The partials are
// added in chunk order one of two ways, the wrapper's choice
// (kernels/ksplit_gemm.py: choose_geometry), both giving the same bits:
//   - zsplit == 1 (enough strips x row blocks to fill the card: lm_head,
//     prefill): the block's 8 warps take chunks round by round, the
//     round's partials go through shared memory and thread t adds them, in
//     chunk order, into its column's accumulators;
//   - zsplit > 1 (narrow N at decode widths: wq, wk, wv, up, gate): the
//     chunks are spread over zsplit blocks per strip (grid.z), a chunk per
//     warp; every partial goes to a workspace [chunks][M][N], and the last
//     block of the strip to arrive (a per-strip counter the kernel resets
//     itself, so no memset launch) adds them in chunk order, its 256
//     threads each summing 4 columns with all partials in flight.
// The workspace and the counters are allocated once per device by the
// wrapper and reused, so launches sharing them run on one stream.

#include "common.cuh"

constexpr int KS_CHUNK = 64;                  // k per partial sum
constexpr int KS_VEC = 8;                     // output columns per thread
constexpr int KS_STRIP = 32 * KS_VEC;         // output columns per block
constexpr int KS_MAX_WARPS = 8;
constexpr int KS_MAX_SEG = 3;
constexpr int KS_MAX_DEVICES = 64;
constexpr int KS_TAIL = 32;                   // partials in flight in the final sum

struct Seg {
  const void* w;   // [klen, N] row-major, storage dtype wdt
  int wdt;         // storage dtype code
  int cdt;         // compute dtype code (DT_F32 / DT_BF16 / DT_F16)
  int k0;          // first column of x this segment consumes
  int klen;        // rows of w
};

struct KSArgs {
  Seg seg[KS_MAX_SEG];
  const void* x;          // [M, K] row-major, dtype xdt (fp32 or bf16)
  float* y;               // [M, N] fp32
  float* ws;              // zsplit > 1: chunk partials [ceil(K/64)][M][N]
  unsigned int* count;    // zsplit > 1: [ceil(M/ms)][ceil(N/256)], 0 between launches
  int nseg;
  int xdt;
  int M, K, N;
  int ms;                 // rows per block: 1, 2, 4 or 8
  int zsplit;             // blocks per column strip along K
  int vec;                // 1: N % 8 == 0 and every weight buffer 16-byte aligned
};

namespace {

// Bytes of one k row of a thread's 8 weights: 32 for fp32, 16 for a
// 16-bit dtype, 8 for fp8.
template <int WDT>
constexpr int kRowBytes = WDT == DT_F32 ? 32 : (WDT == DT_BF16 || WDT == DT_F16) ? 16 : 8;

// The raw words of this thread's 8 weights of one k row (element i of p),
// by non-coherent loads written as volatile PTX with a memory clobber: the
// compiler keeps a batch of them ahead of the shared-memory reads and FMAs
// that use them (as plain loads it interleaves them with the FMAs, one or
// two in flight), so a batch costs one memory latency.
template <int WDT>
__device__ __forceinline__ void load_row(const void* p, long long i, uint4 (&w)[2]) {
  constexpr int B = kRowBytes<WDT>;
  const unsigned char* q = reinterpret_cast<const unsigned char*>(p) + i * (B / 8);
  if constexpr (B == 32) {
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0].x), "=r"(w[0].y), "=r"(w[0].z), "=r"(w[0].w) : "l"(q) : "memory");
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[1].x), "=r"(w[1].y), "=r"(w[1].z), "=r"(w[1].w) : "l"(q + 16) : "memory");
  } else if constexpr (B == 16) {
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0].x), "=r"(w[0].y), "=r"(w[0].z), "=r"(w[0].w) : "l"(q) : "memory");
  } else {
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(w[0].x), "=r"(w[0].y) : "l"(q) : "memory");
  }
}

// Four partials of another block, through L2 (issued as one batch, like
// load_row).
__device__ __forceinline__ float4 load_cg4(const float* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p) : "memory");
  return v;
}

// ... upcast exactly to fp32.
template <int WDT>
__device__ __forceinline__ void decode8(const uint4 (&w)[2], float (&v)[KS_VEC]) {
  if constexpr (WDT == DT_F32) {
    const unsigned u[8] = {w[0].x, w[0].y, w[0].z, w[0].w, w[1].x, w[1].y, w[1].z, w[1].w};
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __uint_as_float(u[i]);
  } else if constexpr (WDT == DT_BF16 || WDT == DT_F16) {
    const unsigned u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned short lo = static_cast<unsigned short>(u[i] & 0xFFFFu);
      const unsigned short hi = static_cast<unsigned short>(u[i] >> 16);
      if constexpr (WDT == DT_BF16) {
        v[2 * i] = __uint_as_float(static_cast<unsigned>(lo) << 16);
        v[2 * i + 1] = __uint_as_float(static_cast<unsigned>(hi) << 16);
      } else {
        v[2 * i] = __half2float(__ushort_as_half(lo));
        v[2 * i + 1] = __half2float(__ushort_as_half(hi));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned b = ((i < 4 ? w[0].x : w[0].y) >> (8 * (i & 3))) & 0xFFu;
      v[i] = __half2float(__half(__nv_cvt_fp8_to_halfraw(
          static_cast<__nv_fp8_storage_t>(b), WDT == DT_E4M3 ? __NV_E4M3 : __NV_E5M2)));
    }
  }
}

// Whether a weight of storage dtype wdt needs rounding to compute dtype
// ct: fp8 values are exact in bf16 and fp16, a dtype is exact in itself,
// and nothing is rounded for an fp32 compute dtype.
__device__ __forceinline__ bool rounds(int wdt, int ct) {
  return (ct == DT_BF16 && (wdt == DT_F32 || wdt == DT_F16)) ||
         (ct == DT_F16 && (wdt == DT_F32 || wdt == DT_BF16));
}

// p[r][j] += xs[r][k] * w[j] for one k row, k ascending across calls (RW:
// w rounded to ct first).
template <int MS, bool RW>
__device__ __forceinline__ void fma_row(float (&wv)[KS_VEC], const float* xk, int ct,
                                        float (&p)[MS][KS_VEC]) {
  if constexpr (RW) {
#pragma unroll
    for (int j = 0; j < KS_VEC; ++j) wv[j] = round_to(wv[j], ct);
  }
#pragma unroll
  for (int r = 0; r < MS; ++r) {
    const float xv = xk[r * KS_CHUNK];
#pragma unroll
    for (int j = 0; j < KS_VEC; ++j) p[r][j] = __fmaf_rn(xv, wv[j], p[r][j]);
  }
}

// Rows of a weight batch per thread: 32 of 16-bit or fp8 weights, 16 of
// fp32 (half that at MS = 8): 128 registers of loads at most.
template <int MS, int WDT>
constexpr int kBatch = (WDT == DT_F32 ? 16 : 32) / (MS == 8 ? 2 : 1);

// The FMA chains of segment s over k in [lo, hi) of the chunk starting at
// kbeg, for this thread's columns n0 .. n0 + ncols - 1.  `full` (all 8
// columns): vector loads, a batch of rows at a time, all of a batch's
// loads issued before its FMAs; otherwise masked scalar loads.
template <int MS, int WDT, bool RW>
__device__ __forceinline__ void seg_chunk(const Seg& s, int lo, int hi, int kbeg, long long N,
                                          int n0, bool full, int ncols, const float* xs,
                                          float (&p)[MS][KS_VEC]) {
  const long long row0 = static_cast<long long>(lo - s.k0) * N + n0;
  const int ct = s.cdt;
  if (full) {
    constexpr int U = kBatch<MS, WDT>;
    int k = lo;
    for (; k + U <= hi; k += U) {
      uint4 w[U][2];
#pragma unroll
      for (int u = 0; u < U; ++u) load_row<WDT>(s.w, row0 + (k - lo + u) * N, w[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float wv[KS_VEC];
        decode8<WDT>(w[u], wv);
        fma_row<MS, RW>(wv, xs + (k + u - kbeg), ct, p);
      }
    }
    for (; k < hi; ++k) {
      uint4 w[2];
      float wv[KS_VEC];
      load_row<WDT>(s.w, row0 + (k - lo) * N, w);
      decode8<WDT>(w, wv);
      fma_row<MS, RW>(wv, xs + (k - kbeg), ct, p);
    }
    return;
  }
  for (int k = lo; k < hi; ++k) {
    float wv[KS_VEC];
#pragma unroll
    for (int j = 0; j < KS_VEC; ++j)
      wv[j] = j < ncols ? load_t<WDT>(s.w, row0 + (k - lo) * N + j) : 0.0f;
    fma_row<MS, RW>(wv, xs + (k - kbeg), ct, p);
  }
}

template <int MS, int WDT>
__device__ __forceinline__ void seg_chunk_ct(const Seg& s, int lo, int hi, int kbeg, long long N,
                                             int n0, bool full, int ncols, const float* xs,
                                             float (&p)[MS][KS_VEC]) {
  if constexpr (WDT == DT_E4M3 || WDT == DT_E5M2) {   // exact in every compute dtype
    seg_chunk<MS, WDT, false>(s, lo, hi, kbeg, N, n0, full, ncols, xs, p);
  } else {
    if (rounds(WDT, s.cdt))
      seg_chunk<MS, WDT, true>(s, lo, hi, kbeg, N, n0, full, ncols, xs, p);
    else
      seg_chunk<MS, WDT, false>(s, lo, hi, kbeg, N, n0, full, ncols, xs, p);
  }
}

template <int MS>
__device__ __forceinline__ void seg_chunk_w(const Seg& s, int lo, int hi, int kbeg, long long N,
                                            int n0, bool full, int ncols, const float* xs,
                                            float (&p)[MS][KS_VEC]) {
#define KS_SEG(WDT) seg_chunk_ct<MS, WDT>(s, lo, hi, kbeg, N, n0, full, ncols, xs, p)
  switch (s.wdt) {
    case DT_F32: KS_SEG(DT_F32); break;
    case DT_BF16: KS_SEG(DT_BF16); break;
    case DT_F16: KS_SEG(DT_F16); break;
    case DT_E4M3: KS_SEG(DT_E4M3); break;
    default: KS_SEG(DT_E5M2); break;
  }
#undef KS_SEG
}

// p = the partial of chunk c for rows m0 .. m0 + MS - 1 (rows past M
// repeat row M - 1 and are never stored) and this thread's columns.  The
// warp stages the chunk's x rows in xs [MS][64], each k rounded to the
// compute dtype of its segment (a bf16 x needs none for a bf16 or fp32
// compute dtype).
template <int MS>
__device__ __forceinline__ void chunk_partial(const KSArgs& a, int c, int m0, int mrows, int n0,
                                              bool full, int ncols, float* xs,
                                              float (&p)[MS][KS_VEC]) {
  const int lane = threadIdx.x & 31;
  const int kbeg = c * KS_CHUNK, kend = min(a.K, kbeg + KS_CHUNK);
#pragma unroll
  for (int r = 0; r < MS; ++r)
#pragma unroll
    for (int j = 0; j < KS_VEC; ++j) p[r][j] = 0.0f;
  __syncwarp();   // the previous chunk's reads of xs are done
  for (int kk = lane; kk < kend - kbeg; kk += 32) {
    const int k = kbeg + kk;
    int ct = DT_F32;
    for (int si = 0; si < a.nseg; ++si)
      if (k >= a.seg[si].k0 && k < a.seg[si].k0 + a.seg[si].klen) ct = a.seg[si].cdt;
#pragma unroll
    for (int r = 0; r < MS; ++r) {
      const int rr = r < mrows ? r : mrows - 1;
      float xv = load_any(a.x, a.xdt, static_cast<long long>(m0 + rr) * a.K + k);
      if (ct == DT_F16 || (ct == DT_BF16 && a.xdt != DT_BF16)) xv = round_to(xv, ct);
      xs[r * KS_CHUNK + kk] = xv;
    }
  }
  __syncwarp();
  if (ncols <= 0) return;
  for (int si = 0; si < a.nseg; ++si) {   // storage order: k ascending
    const Seg& s = a.seg[si];
    const int lo = max(kbeg, s.k0);
    const int hi = min(kend, s.k0 + s.klen);
    if (lo < hi) seg_chunk_w<MS>(s, lo, hi, kbeg, a.N, n0, full, ncols, xs, p);
  }
}

// Dynamic shared memory: per warp its x rows [MS][64] fp32, then (zsplit
// == 1) the round's partials [8][MS][256].
template <int MS>
constexpr int smem_bytes(bool round_buffer) {
  return KS_MAX_WARPS * MS * KS_CHUNK * 4 + (round_buffer ? KS_MAX_WARPS * MS * KS_STRIP * 4 : 0);
}

template <int MS>
__global__ void __launch_bounds__(32 * KS_MAX_WARPS) ksplit_gemm_kernel(const KSArgs a) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ bool last_block;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int strip = blockIdx.x;
  const int n0 = strip * KS_STRIP + lane * KS_VEC;
  const int ncols = min(KS_VEC, a.N - n0);
  const bool full = a.vec && ncols == KS_VEC;
  const int m0 = blockIdx.y * MS;
  const int mrows = min(MS, a.M - m0);
  const int nch = (a.K + KS_CHUNK - 1) / KS_CHUNK;
  float* xs = reinterpret_cast<float*>(sm) + warp * MS * KS_CHUNK;
  float p[MS][KS_VEC];

  if (a.zsplit == 1) {
    // 8 warps; thread t adds column strip * 256 + t of the block's rows
    float* part = reinterpret_cast<float*>(sm) + KS_MAX_WARPS * MS * KS_CHUNK;   // [8][MS][256]
    float acc[MS];
#pragma unroll
    for (int r = 0; r < MS; ++r) acc[r] = 0.0f;
    for (int c0 = 0; c0 < nch; c0 += KS_MAX_WARPS) {
      const int c = c0 + warp;
      if (c < nch) {
        chunk_partial<MS>(a, c, m0, mrows, n0, full, ncols, xs, p);
#pragma unroll
        for (int r = 0; r < MS; ++r) {
          float4* q = reinterpret_cast<float4*>(part + (warp * MS + r) * KS_STRIP + lane * KS_VEC);
          q[0] = make_float4(p[r][0], p[r][1], p[r][2], p[r][3]);
          q[1] = make_float4(p[r][4], p[r][5], p[r][6], p[r][7]);
        }
      }
      __syncthreads();
      const int last = min(KS_MAX_WARPS, nch - c0);
      for (int j = 0; j < last; ++j)
#pragma unroll
        for (int r = 0; r < MS; ++r)
          acc[r] = __fadd_rn(acc[r], part[(j * MS + r) * KS_STRIP + threadIdx.x]);
      __syncthreads();
    }
    const int col = strip * KS_STRIP + threadIdx.x;
    if (col < a.N)
#pragma unroll
      for (int r = 0; r < MS; ++r)
        if (r < mrows) a.y[static_cast<long long>(m0 + r) * a.N + col] = acc[r];
    return;
  }

  // zsplit > 1: this block's chunks, one per warp, to the workspace
  const long long plane = static_cast<long long>(a.M) * a.N;
  const int cpb = (nch + a.zsplit - 1) / a.zsplit;
  const int c_lo = blockIdx.z * cpb, c_hi = min(nch, c_lo + cpb);
  for (int c = c_lo + warp; c < c_hi; c += KS_MAX_WARPS) {
    chunk_partial<MS>(a, c, m0, mrows, n0, full, ncols, xs, p);
    if (ncols <= 0) continue;
#pragma unroll
    for (int r = 0; r < MS; ++r) {
      if (r >= mrows) continue;
      float* q = a.ws + c * plane + static_cast<long long>(m0 + r) * a.N + n0;
      if (full) {
        reinterpret_cast<float4*>(q)[0] = make_float4(p[r][0], p[r][1], p[r][2], p[r][3]);
        reinterpret_cast<float4*>(q)[1] = make_float4(p[r][4], p[r][5], p[r][6], p[r][7]);
      } else {
#pragma unroll
        for (int j = 0; j < KS_VEC; ++j)
          if (j < ncols) q[j] = p[r][j];
      }
    }
  }
  __threadfence();   // this thread's partials, before the block's arrival
  __syncthreads();
  const int slot = blockIdx.y * gridDim.x + strip;
  if (threadIdx.x == 0)
    last_block = atomicAdd(a.count + slot, 1u) == static_cast<unsigned>(a.zsplit - 1);
  __syncthreads();
  if (!last_block) return;
  __threadfence();   // every block's partials, before they are read
  if (threadIdx.x == 0) a.count[slot] = 0u;   // ready for the next launch
  // the strip's MS x 256 outputs, 4 columns per step, chunks in order
  for (int g = threadIdx.x; g < MS * (KS_STRIP / 4); g += blockDim.x) {
    const int r = g / (KS_STRIP / 4);
    const int col = strip * KS_STRIP + (g % (KS_STRIP / 4)) * 4;
    if (r >= mrows || col >= a.N) continue;
    const long long o = static_cast<long long>(m0 + r) * a.N + col;
    if (a.vec && col + 4 <= a.N) {
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int c0 = 0; c0 < nch; c0 += KS_TAIL) {   // KS_TAIL partials in flight
        float4 v[KS_TAIL];
#pragma unroll
        for (int i = 0; i < KS_TAIL; ++i)
          if (c0 + i < nch) v[i] = load_cg4(a.ws + (c0 + i) * plane + o);
#pragma unroll
        for (int i = 0; i < KS_TAIL; ++i) {
          if (c0 + i >= nch) break;
          s.x = __fadd_rn(s.x, v[i].x);
          s.y = __fadd_rn(s.y, v[i].y);
          s.z = __fadd_rn(s.z, v[i].z);
          s.w = __fadd_rn(s.w, v[i].w);
        }
      }
      *reinterpret_cast<float4*>(a.y + o) = s;
    } else {
      for (int q = 0; q < 4 && col + q < a.N; ++q) {
        float s = 0.0f;
        for (int c = 0; c < nch; ++c) s = __fadd_rn(s, __ldcg(a.ws + c * plane + o + q));
        a.y[o + q] = s;
      }
    }
  }
}

template <int MS>
int launch_ms(const KSArgs& a, int device, cudaStream_t st) {
  static bool ready[KS_MAX_DEVICES] = {};
  if (!ready[device]) {   // the round buffer takes over 48 KB at MS = 8
    cudaError_t e = cudaFuncSetAttribute(ksplit_gemm_kernel<MS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<MS>(true));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[device] = true;
  }
  const int smem = smem_bytes<MS>(a.zsplit == 1);
  dim3 grid((a.N + KS_STRIP - 1) / KS_STRIP, (a.M + MS - 1) / MS, a.zsplit);
  ksplit_gemm_kernel<MS><<<grid, 32 * KS_MAX_WARPS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int ksplit_gemm_launch(const KSArgs* args, int device, void* stream) {
  const KSArgs a = *args;
  const int nch = (a.K + KS_CHUNK - 1) / KS_CHUNK;
  if (a.nseg < 1 || a.nseg > KS_MAX_SEG || a.M < 1 || a.N < 1 || a.K < 1 ||
      (a.xdt != DT_F32 && a.xdt != DT_BF16) ||
      (a.ms != 1 && a.ms != 2 && a.ms != 4 && a.ms != 8) || (a.M + a.ms - 1) / a.ms > 65535 ||
      a.zsplit < 1 || a.zsplit > nch || a.zsplit > 65535 || (a.zsplit > 1 && (!a.ws || !a.count)) || device < 0 || device >= KS_MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.ms) {
    case 1: return launch_ms<1>(a, device, st);
    case 2: return launch_ms<2>(a, device, st);
    case 4: return launch_ms<4>(a, device, st);
    default: return launch_ms<8>(a, device, st);
  }
}
