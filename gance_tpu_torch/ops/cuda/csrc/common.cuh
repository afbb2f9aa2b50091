// Shared helpers for the synthesis kernels: fp32 / bf16 element access with
// fp32 arithmetic, and the dtype codes the Python wrappers pass.
//
// The kernels are built with --fmad=false (build.py) and write each sum in the
// order of their plain PyTorch twins (fused_ops.py), so every operation rounds
// as the twin's does and kernel and twin agree bit for bit.
#pragma once

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

// Store two neighbouring elements of one row (p must be 2-element aligned).
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace gance
