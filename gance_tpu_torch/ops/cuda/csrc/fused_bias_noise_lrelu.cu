// Kernel A: the synthesis layer epilogue
//     out = lrelu(x + noise * strength + bias[c], 0.2) * sqrt(2)
// over NCHW x (fp32 or bf16), noise (1 or B, 1, H, W) fp32, bias (C,) fp32 and
// strength, a 0-d fp32 tensor read through a device pointer (so the host never
// syncs to read it).
//
// Replaces gance_tpu/ops/pallas/fused_ops.py::fused_bias_noise_lrelu.
// Bound on the H100: memory. It reads x and noise once and writes out once,
// (2|x| + |noise|) bytes at 3.35 TB/s; the 5 flops per element are far below
// the fp32 rate.
// Design: one block row per (b, c) plane, so the channel's bias and the noise
// row offset are per-block constants and no thread divides a 64-bit index.
// Neighbouring threads take neighbouring pixels: x, noise and out accesses are
// coalesced. blockIdx.y splits a large plane into chunks; each thread walks its
// chunk with a stride of the whole y-grid. fp32 arithmetic for both dtypes.

#include "common.cuh"

namespace {

constexpr float kSqrt2 = 1.41421356237309504880f;

template <typename T>
__global__ void bias_noise_lrelu_kernel(const T* __restrict__ x,
                                        const float* __restrict__ noise,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ strength,
                                        T* __restrict__ out, int channels, long hw,
                                        int noise_per_sample) {
  const long plane = blockIdx.x;
  const int c = static_cast<int>(plane % channels);
  const long b = plane / channels;
  const float s = __ldg(strength);
  const float bc = __ldg(bias + c);
  const T* xp = x + plane * hw;
  T* op = out + plane * hw;
  const float* np = noise + (noise_per_sample ? b * hw : 0);
  const long step = static_cast<long>(gridDim.y) * blockDim.x;
  for (long p = static_cast<long>(blockIdx.y) * blockDim.x + threadIdx.x; p < hw; p += step) {
    float v = gance::to_float(xp[p]) + __ldg(np + p) * s + bc;
    v = (v >= 0.f ? v : v * 0.2f) * kSqrt2;
    op[p] = gance::from_float<T>(v);
  }
}

template <typename T>
void launch(const void* x, const void* noise, const void* bias, const void* strength,
            void* out, long planes, int channels, long hw, int noise_per_sample,
            cudaStream_t stream) {
  const int threads = hw >= 256 ? 256 : static_cast<int>((hw + 31) / 32 * 32);
  // about 8 elements per thread, at most 65535 chunks per plane
  long chunks = (hw + threads * 8L - 1) / (threads * 8L);
  if (chunks > 65535) chunks = 65535;
  dim3 grid(static_cast<unsigned>(planes), static_cast<unsigned>(chunks));
  bias_noise_lrelu_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(noise),
      static_cast<const float*>(bias), static_cast<const float*>(strength),
      static_cast<T*>(out), channels, hw, noise_per_sample);
}

}  // namespace

extern "C" int gance_fused_bias_noise_lrelu(const void* x, const void* noise,
                                            const void* bias, const void* strength,
                                            void* out, long planes, int channels, long hw,
                                            int noise_per_sample, int dtype, void* stream) {
  if (planes <= 0 || hw <= 0 || planes > 2147483647L) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gance::kFloat32) {
    launch<float>(x, noise, bias, strength, out, planes, channels, hw, noise_per_sample, s);
  } else if (dtype == gance::kBFloat16) {
    launch<__nv_bfloat16>(x, noise, bias, strength, out, planes, channels, hw,
                          noise_per_sample, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
