// One-token decode attention over a bf16 KV cache, hand-written for Hopper
// (sm_90a).
//
// Replaces no pl.pallas_call: the JAX package's decode attention
// (src/repro/models/common.py, decode_attention and _attend) is plain jnp
// that XLA fuses on the TPU.  It was added because the port's plain
// composition of the same math (kernels/decode_attention.py,
// decode_attention_plain) repeats the kv heads of the whole cache, casts it
// to fp32 and makes K contiguous every layer and step: on an H100 those
// copies took most of a served decode step's device time.
//
// What it computes, for q [B, n_q, dh] bf16 (one position), K and V
// [B, S, n_kv, dh] bf16 and a visibility mask valid [B, S] (bool, row
// stride vsb, may be 0; element stride vsj), with G = n_q / n_kv and q head
// h * G + g reading kv head h (the plain path's repeat_interleave):
//   s_j   = valid[b, j] ? sum_d (q_d * scale) * k_jd : -1e30   (fp32 FMAs)
//   out   = sum_j softmax(s)_j * v_j                            (fp32)
// written as bf16 (round to nearest even, as .to(torch.bfloat16)) or fp32
// into [B, n_q * dh].  q * scale is one fp32 multiply, as q.float() * scale;
// products are bf16 values widened exactly; expf is the full-precision one
// (no fast math).  Only the order of the fp32 sums differs from the plain
// path.  A row that sees no key gets every score -1e30, hence the mean of V
// over all S slots, as the plain softmax gives.
//
// What bounds it on an H100: bytes.  Each visible 64-key tile of K and V is
// read once, 2 * 64 * dh * 2 bytes per (row, kv head, tile), against
// 2 * G * 64 * dh fp32 FMAs: G FMAs per byte, far below the card's ~10 fp32
// FMAs per byte of HBM.  The whole cache of one layer at B = 128, S = 512,
// 8 kv heads of 128 is 268 MB: 80 us at 3.35 TB/s.
//
// Design:
//   - grouped heads: one block per (key chunk, kv head, row), one warp per
//     q head of the group, so K and V are read once for the whole group and
//     nothing is repeated;
//   - tiles of 64 keys read in place as 16-byte cp.async copies into shared
//     memory, double-buffered so the next tile's loads overlap this tile's
//     FMAs; rows are stored with their 16-byte chunks XOR-swizzled by the key
//     index, so the score phase (lane = key) reads shared memory without
//     bank conflicts;
//   - tile skipping: a block reads its row's mask first and loads no K or V
//     for a tile without a visible key (exact: such keys weigh exactly 0 in
//     the plain path), unless the row sees no key at all;
//   - online softmax within a chunk; with several chunks a second kernel
//     combines their (max, sum, partial output) in chunk order.  The chunk
//     count is fixed by S alone (the wrapper's CHUNK_TILES), never by B or by
//     the other rows, so a row's bits are the same alone as in any batch;
//   - each block adds the number of tiles it read to a device counter (one
//     atomicAdd a block), which the wrapper reads only when asked.

#include <math_constants.h>

#include "common.cuh"

constexpr int DA_TILE = 64;          // keys per tile
constexpr int DA_MAX_G = 16;         // q heads per kv head (warps a block)
constexpr int DA_MAX_CHUNK_TILES = 32;

struct DAArgs {
  const unsigned short* q;           // [B, n_kv * G * dh] bf16
  const unsigned short* k;           // [B, S, n_kv, dh] bf16
  const unsigned short* v;
  const unsigned char* valid;        // valid[b * vsb + j * vsj]
  long long vsb, vsj;
  void* out;                         // [B, n_kv * G * dh] bf16 or fp32
  float* part;                       // [B, n_kv * G, nc, dh + 2] if nc > 1
  unsigned long long* tiles;         // tiles read (device count)
  int S, n_kv, G, nc, chunk_tiles;
  float scale;
};

namespace {

constexpr float DA_MASKED = -1e30f;

template <int DH>
struct DAGeo {
  static constexpr int C = DH / 8;                 // 16-byte chunks a key row
  static constexpr int SW = C % 8 == 0 ? 7 : C % 4 == 0 ? 3 : C % 2 == 0 ? 1 : 0;
  static constexpr int NP = (DH / 2 + 31) / 32;    // bf16 pairs a lane (p.V)
  static constexpr int TILE_BYTES = DA_TILE * DH * 2;
  static constexpr int SMEM = 4 * TILE_BYTES + DA_MAX_G * DH * 4;
};

__device__ __forceinline__ float bf_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The lowest tile left in `todo`, taken out of it; -1 if none.
__device__ __forceinline__ int take_tile(unsigned& todo) {
  if (!todo) return -1;
  const int t = __ffs(todo) - 1;
  todo &= todo - 1;
  return t;
}

template <int DH, bool OUT_F32>
__global__ void __launch_bounds__(32 * DA_MAX_G) decode_attention_kernel(const DAArgs a) {
  using Geo = DAGeo<DH>;
  constexpr int C = Geo::C, SW = Geo::SW, NP = Geo::NP;
  extern __shared__ __align__(16) unsigned char smem[];   // [2][K, V] tiles, q
  __shared__ unsigned s_mask;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nth = blockDim.x;
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = a.G, n_q = a.n_kv * G, S = a.S;
  const int T = (S + DA_TILE - 1) / DA_TILE;
  const int t0 = chunk * a.chunk_tiles, t1 = min(T, t0 + a.chunk_tiles);
  const unsigned char* vrow = a.valid + b * a.vsb;

  // this kv head's G q heads, times the scale, in fp32
  float* qs = reinterpret_cast<float*>(smem + 4 * Geo::TILE_BYTES);
  const unsigned short* qrow = a.q + (static_cast<long long>(b) * n_q + h * G) * DH;
  for (int i = tid; i < G * DH; i += nth)
    qs[i] = __uint_as_float(static_cast<unsigned>(qrow[i]) << 16) * a.scale;

  // which of the chunk's tiles hold a visible key
  if (tid == 0) s_mask = 0u;
  __syncthreads();
  unsigned mine = 0u;
  for (int j = t0 * DA_TILE + tid; j < min(t1 * DA_TILE, S); j += nth)
    if (vrow[j * a.vsj]) mine |= 1u << (j / DA_TILE - t0);
  if (mine) atomicOr(&s_mask, mine);
  __syncthreads();
  unsigned mask = s_mask;
  if (!mask) {
    // none here: read every tile if the row sees no key at all (all
    // scores -1e30, the plain path's mean of V), else none
    int any = 0;
    for (int base = 0; base < S && !any; base += nth) {
      const int j = base + tid;
      any = __syncthreads_or(j < S && vrow[j * a.vsj]);
    }
    if (!any && t1 > t0) mask = t1 - t0 == 32 ? ~0u : (1u << (t1 - t0)) - 1u;
  }
  if (tid == 0 && mask) atomicAdd(a.tiles, static_cast<unsigned long long>(__popc(mask)));

  const long long rstride = static_cast<long long>(a.n_kv) * DH;   // between keys
  const long long head0 = static_cast<long long>(b) * S * rstride + h * DH;
  auto load = [&](int t, int stage) {
    const int k0 = (t0 + t) * DA_TILE, nk = min(DA_TILE, S - k0);
    unsigned char* ks = smem + stage * 2 * Geo::TILE_BYTES;
    unsigned char* vs = ks + Geo::TILE_BYTES;
    const unsigned short* kg = a.k + head0 + k0 * rstride;
    const unsigned short* vg = a.v + head0 + k0 * rstride;
    for (int i = tid; i < nk * C; i += nth) {
      const int r = i / C, c = i - r * C;
      const int off = (r * C + (c ^ (r & SW))) * 16;
      cp_async16(ks + off, kg + r * rstride + c * 8);
      cp_async16(vs + off, vg + r * rstride + c * 8);
    }
    cp_commit();
  };

  float m = -CUDART_INF_F, l = 0.0f, acc[2 * NP];
#pragma unroll
  for (int i = 0; i < 2 * NP; ++i) acc[i] = 0.0f;
  const float4* q4 = reinterpret_cast<const float4*>(qs + warp * DH);

  unsigned todo = mask;
  int cur = take_tile(todo);
  if (cur >= 0) load(cur, 0);
  for (int it = 0; cur >= 0; ++it) {
    const int nxt = take_tile(todo);
    if (nxt >= 0) {
      load(nxt, (it + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = (t0 + cur) * DA_TILE, nk = min(DA_TILE, S - k0);
    const unsigned char* ks = smem + (it & 1) * 2 * Geo::TILE_BYTES;
    const unsigned char* vs = ks + Geo::TILE_BYTES;

    // scores: lane = keys lane and lane + 32, each one fp32 FMA chain in d
    const int j0 = lane, j1 = lane + 32;
    const uint4* k0row = reinterpret_cast<const uint4*>(ks + j0 * C * 16);
    const uint4* k1row = reinterpret_cast<const uint4*>(ks + j1 * C * 16);
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float4 qa = q4[2 * c], qb = q4[2 * c + 1];
      const uint4 x = k0row[c ^ (j0 & SW)], y = k1row[c ^ (j1 & SW)];
      s0 = fmaf(qa.x, bf_lo(x.x), s0); s1 = fmaf(qa.x, bf_lo(y.x), s1);
      s0 = fmaf(qa.y, bf_hi(x.x), s0); s1 = fmaf(qa.y, bf_hi(y.x), s1);
      s0 = fmaf(qa.z, bf_lo(x.y), s0); s1 = fmaf(qa.z, bf_lo(y.y), s1);
      s0 = fmaf(qa.w, bf_hi(x.y), s0); s1 = fmaf(qa.w, bf_hi(y.y), s1);
      s0 = fmaf(qb.x, bf_lo(x.z), s0); s1 = fmaf(qb.x, bf_lo(y.z), s1);
      s0 = fmaf(qb.y, bf_hi(x.z), s0); s1 = fmaf(qb.y, bf_hi(y.z), s1);
      s0 = fmaf(qb.z, bf_lo(x.w), s0); s1 = fmaf(qb.z, bf_lo(y.w), s1);
      s0 = fmaf(qb.w, bf_hi(x.w), s0); s1 = fmaf(qb.w, bf_hi(y.w), s1);
    }
    // past the cache: no key (weight 0); hidden: -1e30 as in the plain path
    s0 = j0 < nk ? (vrow[(k0 + j0) * a.vsj] ? s0 : DA_MASKED) : -CUDART_INF_F;
    s1 = j1 < nk ? (vrow[(k0 + j1) * a.vsj] ? s1 : DA_MASKED) : -CUDART_INF_F;

    // online softmax over the warp's 64 scores
    float mt = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float mn = fmaxf(m, mt);
    const float alpha = expf(m - mn);     // 0 at the first tile (m = -inf)
    const float p0 = expf(s0 - mn), p1 = expf(s1 - mn);
    float ps = p0 + p1;
#pragma unroll
    for (int o = 16; o; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
    l = l * alpha + ps;
    m = mn;
#pragma unroll
    for (int i = 0; i < 2 * NP; ++i) acc[i] *= alpha;

    // p.V: lane = bf16 pairs lane, lane + 32, ... of the head dim
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const float pj = __shfl_sync(0xffffffffu, j < 32 ? p0 : p1, j & 31);
      const unsigned char* vr = vs + j * C * 16;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int pr = lane + 32 * i;
        if ((DH / 2) % 32 == 0 || pr < DH / 2) {
          const unsigned w =
              *reinterpret_cast<const unsigned*>(vr + (((pr >> 2) ^ (j & SW)) << 4) + ((pr & 3) << 2));
          acc[2 * i] = fmaf(pj, bf_lo(w), acc[2 * i]);
          acc[2 * i + 1] = fmaf(pj, bf_hi(w), acc[2 * i + 1]);
        }
      }
    }
    __syncthreads();      // the next iteration's loads reuse this stage
    cur = nxt;
  }

  const long long head = static_cast<long long>(b) * n_q + h * G + warp;
  if (a.nc == 1) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int pr = lane + 32 * i;
      if ((DH / 2) % 32 == 0 || pr < DH / 2) {
        const float x = acc[2 * i] / l, y = acc[2 * i + 1] / l;
        if constexpr (OUT_F32) {
          reinterpret_cast<float2*>(a.out)[head * (DH / 2) + pr] = make_float2(x, y);
        } else {
          reinterpret_cast<__nv_bfloat162*>(a.out)[head * (DH / 2) + pr] = __floats2bfloat162_rn(x, y);
        }
      }
    }
  } else {
    float* pp = a.part + (head * a.nc + chunk) * (DH + 2);
    if (lane == 0) pp[0] = m, pp[1] = l;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int pr = lane + 32 * i;
      if ((DH / 2) % 32 == 0 || pr < DH / 2) {
        pp[2 + 2 * pr] = acc[2 * i];
        pp[3 + 2 * pr] = acc[2 * i + 1];
      }
    }
  }
}

// One block per (row, q head): the chunks' partials combined in chunk order.
// A chunk that read no tile left (-inf, 0, 0...) and weighs 0.
template <bool OUT_F32>
__global__ void decode_attention_combine(const float* __restrict__ part, void* __restrict__ out,
                                         int nc, int dh) {
  const long long head = blockIdx.x;
  const float* pp = part + head * nc * (dh + 2);
  float M = -CUDART_INF_F;
  for (int c = 0; c < nc; ++c) M = fmaxf(M, pp[c * (dh + 2)]);
  float L = 0.0f;
  for (int c = 0; c < nc; ++c) L += pp[c * (dh + 2) + 1] * expf(pp[c * (dh + 2)] - M);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float o = 0.0f;
    for (int c = 0; c < nc; ++c) o += pp[c * (dh + 2) + 2 + d] * expf(pp[c * (dh + 2)] - M);
    o /= L;
    if constexpr (OUT_F32) {
      static_cast<float*>(out)[head * dh + d] = o;
    } else {
      static_cast<__nv_bfloat16*>(out)[head * dh + d] = __float2bfloat16_rn(o);
    }
  }
}

// Make `dev` current if it is not (the stream belongs to it).
cudaError_t da_use_device(int dev) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess || cur == dev) return e;
  return cudaSetDevice(dev);
}

template <int DH, bool OUT_F32>
cudaError_t launch_dh(const DAArgs& a, int B, int device, cudaStream_t st) {
  auto kern = decode_attention_kernel<DH, OUT_F32>;
  static bool opted[64] = {false};       // dynamic shared memory past 48 KB, per device
  if (!opted[device]) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DAGeo<DH>::SMEM);
    if (e != cudaSuccess) return e;
    opted[device] = true;
  }
  const int smem = 4 * DAGeo<DH>::TILE_BYTES + a.G * DH * 4;
  kern<<<dim3(a.nc, a.n_kv, B), 32 * a.G, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nc == 1) return e;
  decode_attention_combine<OUT_F32><<<B * a.n_kv * a.G, 128, 0, st>>>(a.part, a.out, a.nc, DH);
  return cudaGetLastError();
}

template <bool OUT_F32>
cudaError_t launch_out(const DAArgs& a, int B, int dh, int device, cudaStream_t st) {
  switch (dh) {
    case 16: return launch_dh<16, OUT_F32>(a, B, device, st);
    case 128: return launch_dh<128, OUT_F32>(a, B, device, st);
    case 320: return launch_dh<320, OUT_F32>(a, B, device, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launches (0 = ok).
// q, k, v and out as above (k and v 16-byte aligned and contiguous);
// `part` holds B * n_kv * G * nc * (dh + 2) floats when nc > 1; `tiles` is
// an 8-byte device counter.  dh is 16, 128 or 320; 1 <= G <= 16;
// nc = ceil(ceil(S / 64) / chunk_tiles) with chunk_tiles <= 32.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* valid, long long vsb, long long vsj,
                                       void* out, int out_f32, void* part, void* tiles, int B,
                                       int S, int n_kv, int G, int dh, int chunk_tiles,
                                       float scale, int device, void* stream) {
  const int T = (S + DA_TILE - 1) / DA_TILE;
  const int nc = chunk_tiles > 0 ? (T + chunk_tiles - 1) / chunk_tiles : 0;
  if (B < 1 || B > 65535 || S < 1 || n_kv < 1 || n_kv > 65535 || G < 1 || G > DA_MAX_G ||
      chunk_tiles < 1 || chunk_tiles > DA_MAX_CHUNK_TILES || (nc > 1 && !part) ||
      device < 0 || device >= 64 || (reinterpret_cast<unsigned long long>(k) & 15) ||
      (reinterpret_cast<unsigned long long>(v) & 15) ||
      (reinterpret_cast<unsigned long long>(out) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = da_use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  DAArgs a;
  a.q = static_cast<const unsigned short*>(q);
  a.k = static_cast<const unsigned short*>(k);
  a.v = static_cast<const unsigned short*>(v);
  a.valid = static_cast<const unsigned char*>(valid);
  a.vsb = vsb, a.vsj = vsj;
  a.out = out;
  a.part = static_cast<float*>(part);
  a.tiles = static_cast<unsigned long long*>(tiles);
  a.S = S, a.n_kv = n_kv, a.G = G, a.nc = nc, a.chunk_tiles = chunk_tiles;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = out_f32 ? launch_out<true>(a, B, dh, device, st) : launch_out<false>(a, B, dh, device, st);
  return static_cast<int>(e);
}
