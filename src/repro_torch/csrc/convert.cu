// Elementwise precision conversion, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/convert.py (convert ->
// pallas_call, body _convert_kernel): x [M, N] fp32 -> out_dtype, the
// paper's datatype-conversion task.  Rounding is the reference's:
// round-to-nearest-even into bf16, fp16, fp8 e4m3 or e5m2; fp16 and e5m2
// overflow to +-inf, e4m3 gives NaN above 464 (common.cuh's store casts,
// never a saturating conversion).
//
// What bounds it on an H100: one read of 4 bytes and one write of 1-4
// bytes per element and no arithmetic to speak of, so it is bound by
// bytes (HBM bandwidth).
//
// Design: the TPU kernel streamed 256 x 256 blocks through VMEM; here
// the matrix is one flat array, each thread converts 4 elements per step
// from one 16-byte load and writes them with one 4-, 8- or 16-byte
// store, in a grid-stride loop over as many blocks as keep every SM busy.

#include "common.cuh"

namespace {

template <int ODT>
__device__ __forceinline__ void store4(void* out, long long v, float4 f) {
  if constexpr (ODT == DT_F32) {
    reinterpret_cast<float4*>(out)[v] = f;
  } else if constexpr (ODT == DT_BF16 || ODT == DT_F16) {
    unsigned short h[4];
    const float x[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = ODT == DT_BF16 ? __bfloat16_as_ushort(__float2bfloat16_rn(x[e]))
                            : __half_as_ushort(__float2half_rn(x[e]));
    reinterpret_cast<ushort4*>(out)[v] = make_ushort4(h[0], h[1], h[2], h[3]);
  } else {
    unsigned char b[4];
    const float x[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (ODT == DT_E5M2) {
        b[e] = e5m2_bits(x[e]);
      } else {
        b[e] = (isnan(x[e]) || fabsf(x[e]) > E4M3_NAN_ABOVE)
                   ? static_cast<unsigned char>(0x7F)
                   : static_cast<unsigned char>(
                         __nv_cvt_float_to_fp8(x[e], __NV_SATFINITE, __NV_E4M3));
      }
    }
    reinterpret_cast<uchar4*>(out)[v] = make_uchar4(b[0], b[1], b[2], b[3]);
  }
}

template <int ODT>
__global__ void __launch_bounds__(256)
convert_kernel(const float* __restrict__ x, void* __restrict__ out, long long n) {
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (long long v = t0; v < n4; v += stride) store4<ODT>(out, v, __ldg(x4 + v));
  for (long long e = 4 * n4 + t0; e < n; e += stride) store_any(out, ODT, e, x[e]);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
// `x` is fp32 with 16-byte alignment, `n` its element count.
extern "C" int convert_launch(const void* x, void* out, long long n, int odt,
                              int device, void* stream) {
  if (n < 1 || (reinterpret_cast<unsigned long long>(x) & 15) ||
      (reinterpret_cast<unsigned long long>(out) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long need = (n / 4 + 255) / 256 + 1;
  const int blocks = static_cast<int>(need < 8LL * sms ? need : 8LL * sms);
  const float* xf = static_cast<const float*>(x);
  switch (odt) {
    case DT_F32: convert_kernel<DT_F32><<<blocks, 256, 0, st>>>(xf, out, n); break;
    case DT_BF16: convert_kernel<DT_BF16><<<blocks, 256, 0, st>>>(xf, out, n); break;
    case DT_F16: convert_kernel<DT_F16><<<blocks, 256, 0, st>>>(xf, out, n); break;
    case DT_E4M3: convert_kernel<DT_E4M3><<<blocks, 256, 0, st>>>(xf, out, n); break;
    case DT_E5M2: convert_kernel<DT_E5M2><<<blocks, 256, 0, st>>>(xf, out, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
