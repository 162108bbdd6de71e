// Shared helpers of the port's CUDA kernels: dtype codes, loads that
// upcast any storage dtype to fp32 exactly, rounding to a compute dtype,
// stores that round fp32 into a storage dtype with the reference's
// semantics (round-to-nearest-even; fp8 e4m3 overflow -> NaN, fp8 e5m2
// and fp16 overflow -> inf), one element or eight at a time, and a split
// format's round trip through its slices.  Built without fast math, so
// no conversion here flushes a subnormal to zero.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Dtype codes shared with kernels/_build.py (DTYPE_CODES).
enum DType : int {
  DT_F32 = 0,
  DT_BF16 = 1,
  DT_F16 = 2,
  DT_E4M3 = 3,
  DT_E5M2 = 4,
};

template <int DT>
__device__ __forceinline__ float load_t(const void* p, long long i) {
  if constexpr (DT == DT_F32) {
    return __ldg(reinterpret_cast<const float*>(p) + i);
  } else if constexpr (DT == DT_BF16) {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p) + i);
    return __uint_as_float(static_cast<unsigned int>(u) << 16);
  } else if constexpr (DT == DT_F16) {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p) + i);
    return __half2float(__ushort_as_half(u));
  } else {
    const unsigned char u = __ldg(reinterpret_cast<const unsigned char*>(p) + i);
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(u),
        DT == DT_E4M3 ? __NV_E4M3 : __NV_E5M2);
    return __half2float(__half(h));
  }
}

// Runtime-dtype load (the branch is uniform across a block).
__device__ __forceinline__ float load_any(const void* p, int dt, long long i) {
  switch (dt) {
    case DT_F32: return load_t<DT_F32>(p, i);
    case DT_BF16: return load_t<DT_BF16>(p, i);
    case DT_F16: return load_t<DT_F16>(p, i);
    case DT_E4M3: return load_t<DT_E4M3>(p, i);
    default: return load_t<DT_E5M2>(p, i);
  }
}

// Receiver-side conversion: v rounded to the compute dtype (returned as
// the exact fp32 value of the rounded number).
__device__ __forceinline__ float round_to(float v, int ct) {
  if (ct == DT_BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (ct == DT_F16) return __half2float(__float2half_rn(v));
  return v;
}

// fp32 -> fp8 e5m2 bits, round-to-nearest-even, overflow to +-inf, NaN
// to NaN: the integer algorithm of PyTorch's c10::Float8_e5m2 (so the
// kernels round bit for bit like torch's and the reference's casts).
__device__ __forceinline__ unsigned char e5m2_bits(float f) {
  const unsigned int fp32_inf = 255u << 23;
  const unsigned int fp8_max = 143u << 23;     // 2^16: rounds past 57344
  const unsigned int denorm_mask = 134u << 23;
  unsigned int bits = __float_as_uint(f);
  const unsigned int sign = bits & 0x80000000u;
  bits ^= sign;
  unsigned char r;
  if (bits >= fp8_max) {
    r = bits > fp32_inf ? 0x7F : 0x7C;
  } else if (bits < (113u << 23)) {             // below 2^-14: subnormal
    const float d = __fadd_rn(__uint_as_float(bits), __uint_as_float(denorm_mask));
    r = static_cast<unsigned char>(__float_as_uint(d) - denorm_mask);
  } else {
    const unsigned int odd = (bits >> 21) & 1u;
    bits += (static_cast<unsigned int>(15 - 127) << 23) + 0xFFFFFu + odd;
    r = static_cast<unsigned char>(bits >> 21);
  }
  return r | static_cast<unsigned char>(sign >> 24);
}

// The exact fp32 value of fp8 e5m2 bits (e5m2 is the top byte of fp16).
__device__ __forceinline__ float e5m2_value(unsigned char b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b << 8)));
}

// Largest |v| that fp8 e4m3 rounds to a finite value (448 = max finite;
// 464 rounds half-to-even down to it); above it the reference gives NaN.
#define E4M3_NAN_ABOVE 464.0f

__device__ __forceinline__ void store_any(void* p, int dt, long long i, float v) {
  switch (dt) {
    case DT_F32:
      reinterpret_cast<float*>(p)[i] = v;
      break;
    case DT_BF16:
      reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
      break;
    case DT_F16:
      reinterpret_cast<__half*>(p)[i] = __float2half_rn(v);
      break;
    case DT_E4M3:
      reinterpret_cast<unsigned char*>(p)[i] =
          (isnan(v) || fabsf(v) > E4M3_NAN_ABOVE)
              ? static_cast<unsigned char>(0x7F)
              : static_cast<unsigned char>(
                    __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
      break;
    default:
      reinterpret_cast<unsigned char*>(p)[i] = e5m2_bits(v);
      break;
  }
}

// Eight fp32 values rounded (nearest even) to the compute dtype `ct`
// (bf16 or fp16), packed in element order.
__device__ __forceinline__ uint4 pack8(const float (&v)[8], int ct) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (ct == DT_BF16) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    } else {
      const __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Eight fp32 values stored at element index i of p in dtype `dt`, with
// store_any's rounding (one 16-byte store for 16-bit dtypes, two for
// fp32, one 8-byte store for fp8).
__device__ __forceinline__ void store8(void* p, int dt, long long i, const float (&v)[8]) {
  if (dt == DT_F32) {
    float4* q = reinterpret_cast<float4*>(reinterpret_cast<float*>(p) + i);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else if (dt == DT_BF16 || dt == DT_F16) {
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned short*>(p) + i) = pack8(v, dt);
  } else {
    unsigned w[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      unsigned b;
      if (dt == DT_E4M3)
        b = (isnan(v[k]) || fabsf(v[k]) > E4M3_NAN_ABOVE)
                ? 0x7Fu
                : static_cast<unsigned>(__nv_cvt_float_to_fp8(v[k], __NV_SATFINITE, __NV_E4M3));
      else
        b = e5m2_bits(v[k]);
      w[k >> 2] |= b << (8 * (k & 3));
    }
    *reinterpret_cast<uint2*>(reinterpret_cast<unsigned char*>(p) + i) = make_uint2(w[0], w[1]);
  }
}

// Slice storage: fp16 bits or e5m2 bytes.
template <int SDT>
struct Slice;

template <>
struct Slice<DT_F16> {
  using T = unsigned short;
  __device__ static T bits(float v) { return __half_as_ushort(__float2half_rn(v)); }
  __device__ static float value(T b) { return __half2float(__ushort_as_half(b)); }
};

template <>
struct Slice<DT_E5M2> {
  using T = unsigned char;
  __device__ static T bits(float v) { return e5m2_bits(v); }
  __device__ static float value(T b) { return e5m2_value(b); }
};

// The split round trip of v: the fp32 sum of its slices.
template <int S, int SDT>
__device__ __forceinline__ float split_roundtrip(float v) {
  using SL = Slice<SDT>;
  float out = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float sv = SL::value(SL::bits(v));
    out = s == 0 ? sv : __fadd_rn(out, sv);
    v = __fsub_rn(v, sv);
  }
  return out;
}

__device__ __forceinline__ float roundtrip_any(float v, int slices, int sdt) {
  if (sdt == DT_F16) return slices == 2 ? split_roundtrip<2, DT_F16>(v)
                                        : split_roundtrip<3, DT_F16>(v);
  return slices == 2 ? split_roundtrip<2, DT_E5M2>(v) : split_roundtrip<3, DT_E5M2>(v);
}
