// Kernel B: 2x upsample with the [1,3,3,1] binomial FIR (gain 4), NCHW
// (B, C, H, W) -> (B, C, 2H, 2W), in its polyphase form with zeros outside the
// image:
//     even phase 2i:   .25 * x[i-1] + .75 * x[i]
//     odd phase 2i+1:  .75 * x[i]   + .25 * x[i+1]
// first along W, then along H, in the order of
// gance_tpu/ops/upfirdn2d.py::upsample2x_polyphase_nchw.
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
                                       int w, int tiles_x) {
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
    he[r] = 0.25f * left + 0.75f * mid;
    ho[r] = 0.75f * mid + 0.25f * right;
  }
  const long w2 = 2L * w;
  T* op = out + plane * (2L * h) * w2 + (2L * i) * w2 + 2L * j;
  gance::store_pair(op, 0.25f * he[0] + 0.75f * he[1], 0.25f * ho[0] + 0.75f * ho[1]);
  gance::store_pair(op + w2, 0.75f * he[1] + 0.25f * he[2], 0.75f * ho[1] + 0.25f * ho[2]);
}

template <typename T>
void launch(const void* x, void* out, long planes, int h, int w, cudaStream_t stream) {
  const int tiles_x = (w + kBlockX - 1) / kBlockX;
  dim3 block(kBlockX, kBlockY);
  dim3 grid(static_cast<unsigned>(planes * tiles_x), (h + kBlockY - 1) / kBlockY);
  upsample2x_blur_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(x),
                                                       static_cast<T*>(out), h, w, tiles_x);
}

}  // namespace

extern "C" int gance_upsample2x_blur(const void* x, void* out, long planes, int h, int w,
                                     int dtype, void* stream) {
  const long tiles_x = (w + kBlockX - 1) / kBlockX;
  if (planes <= 0 || h <= 0 || w <= 0 || planes * tiles_x > 2147483647L ||
      (h + kBlockY - 1) / kBlockY > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gance::kFloat32) {
    launch<float>(x, out, planes, h, w, s);
  } else if (dtype == gance::kBFloat16) {
    launch<__nv_bfloat16>(x, out, planes, h, w, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
