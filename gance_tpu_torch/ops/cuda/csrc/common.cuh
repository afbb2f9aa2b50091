// Shared helpers for the synthesis kernels: fp32 / bf16 element access with
// fp32 arithmetic, 16-byte vectors of either dtype, and the dtype codes the
// Python wrappers pass.
//
// The kernels are built with --fmad=false (build.py) and write each sum in the
// order of their plain PyTorch twins (fused_ops.py), so every operation rounds
// as the twin's does and kernel and twin agree bit for bit.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gance {

// dtype codes (gance_tpu_torch/ops/cuda/fused_ops.py _DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// 16 bytes of T: kVec<T> elements, held as Vec16<T> (float4 or 8 packed bf16);
// 8 bytes as Vec8<T> (float2 or 4 packed bf16).
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));
template <typename T>
struct VecOf;
template <>
struct VecOf<float> {
  using v16 = float4;
  using v8 = float2;
};
template <>
struct VecOf<__nv_bfloat16> {
  using v16 = uint4;
  using v8 = uint2;
};
template <typename T>
using Vec16 = typename VecOf<T>::v16;
template <typename T>
using Vec8 = typename VecOf<T>::v8;

inline bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// Streaming (evict-first) 16-byte load and store: data read or written once,
// kept from displacing what is read again from L2.
__device__ __forceinline__ float4 load_stream(const float4* p) { return __ldcs(p); }
__device__ __forceinline__ uint4 load_stream(const uint4* p) { return __ldcs(p); }
__device__ __forceinline__ void store_stream(float4* p, float4 v) { __stcs(p, v); }
__device__ __forceinline__ void store_stream(uint4* p, uint4 v) { __stcs(p, v); }

// A 16-byte vector to fp32 values and back (one rounding per element).
__device__ __forceinline__ void unpack(float4 v, float (&f)[4]) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ float4 pack(const float (&f)[4]) {
  return make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void unpack(float2 v, float (&f)[2]) {
  f[0] = v.x;
  f[1] = v.y;
}
__device__ __forceinline__ float bf16_low(unsigned int word) {
  return __uint_as_float(word << 16);
}
__device__ __forceinline__ float bf16_high(unsigned int word) {
  return __uint_as_float(word & 0xffff0000u);
}
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8]) {
  const unsigned int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bf16_low(words[i]);
    f[2 * i + 1] = bf16_high(words[i]);
  }
}
__device__ __forceinline__ void unpack(uint2 v, float (&f)[4]) {
  f[0] = bf16_low(v.x);
  f[1] = bf16_high(v.x);
  f[2] = bf16_low(v.y);
  f[3] = bf16_high(v.y);
}
__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const unsigned int*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                    pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

}  // namespace gance
