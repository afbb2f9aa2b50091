// Kernel B: 2x upsample with a separable 4-tap FIR (gain 4), NCHW
// (B, C, H, W) -> (B, C, 2H, 2W), in its polyphase form with zeros outside the
// image. With the four taps k0..k3 of the 1-D root:
//     even phase 2i:   k0 * x[i-1] + k2 * x[i]
//     odd phase 2i+1:  k1 * x[i]   + k3 * x[i+1]
// first along W, then along H, in the order of
// gance_tpu/ops/upfirdn2d.py::upsample2x_polyphase_nchw. For config-f's
// [1,3,3,1] binomial the taps are (.25, .75, .75, .25); a FIR that is not
// symmetric keeps its taps in this order, as the JAX polyphase form does.
//
// Replaces gance_tpu/ops/pallas/fused_ops.py::upsample2x_blur.
// Bound on the H100: memory, |x| + 4|x| bytes at 3.35 TB/s (16 flops per
// input pixel).
// Design: one thread per input pixel writes its whole 2x2 output quad from the
// 3x3 input neighbourhood. Neighbouring threads take neighbouring columns, so
// the loads coalesce and the eight neighbours come from L1; each output row
// pair is stored as one 2-element vector. The TPU kernel's lane folding of
// (W, C) has no counterpart here: NCHW already puts W on the fast axis.

#include "common.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <typename T>
__device__ __forceinline__ float at(const T* plane, int i, int j, int h, int w) {
  return (i >= 0 && i < h && j >= 0 && j < w) ? gance::to_float(plane[static_cast<long>(i) * w + j])
                                              : 0.f;
}

template <typename T>
__global__ void upsample2x_blur_kernel(const T* __restrict__ x, T* __restrict__ out, int h,
                                       int w, float k0, float k1, float k2, float k3,
                                       int tiles_x) {
  const long plane = blockIdx.x / tiles_x;
  const int j = (blockIdx.x % tiles_x) * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= h || j >= w) return;
  const T* xp = x + plane * h * static_cast<long>(w);

  float he[3], ho[3];  // horizontal phases of rows i-1, i, i+1
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float left = at(xp, i + r - 1, j - 1, h, w);
    const float mid = at(xp, i + r - 1, j, h, w);
    const float right = at(xp, i + r - 1, j + 1, h, w);
    he[r] = k0 * left + k2 * mid;
    ho[r] = k1 * mid + k3 * right;
  }
  const long w2 = 2L * w;
  T* op = out + plane * (2L * h) * w2 + (2L * i) * w2 + 2L * j;
  gance::store_pair(op, k0 * he[0] + k2 * he[1], k0 * ho[0] + k2 * ho[1]);
  gance::store_pair(op + w2, k1 * he[1] + k3 * he[2], k1 * ho[1] + k3 * ho[2]);
}

template <typename T>
void launch(const void* x, void* out, long planes, int h, int w, float k0, float k1, float k2,
            float k3, cudaStream_t stream) {
  const int tiles_x = (w + kBlockX - 1) / kBlockX;
  dim3 block(kBlockX, kBlockY);
  dim3 grid(static_cast<unsigned>(planes * tiles_x), (h + kBlockY - 1) / kBlockY);
  upsample2x_blur_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(x),
                                                       static_cast<T*>(out), h, w, k0, k1, k2,
                                                       k3, tiles_x);
}

}  // namespace

extern "C" int gance_upsample2x_blur(const void* x, void* out, long planes, int h, int w,
                                     float k0, float k1, float k2, float k3, int dtype,
                                     void* stream) {
  const long tiles_x = (w + kBlockX - 1) / kBlockX;
  if (planes <= 0 || h <= 0 || w <= 0 || planes * tiles_x > 2147483647L ||
      (h + kBlockY - 1) / kBlockY > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gance::kFloat32) {
    launch<float>(x, out, planes, h, w, k0, k1, k2, k3, s);
  } else if (dtype == gance::kBFloat16) {
    launch<__nv_bfloat16>(x, out, planes, h, w, k0, k1, k2, k3, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
