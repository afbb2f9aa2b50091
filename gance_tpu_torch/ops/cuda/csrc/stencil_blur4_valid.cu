// Kernel D: a general (not separable) 4x4 FIR applied as a correlation over
// an implicitly zero-padded NCHW input,
//     out[i][j] = sum_a sum_b k[a][b] * xp[i+a][j+b],
// x (B, C, H, W) -> (B, C, H+p0+p1-3, W+p0+p1-3), where xp is x padded by p0
// zeros before and p1 after on both axes (0 <= p0, p1 <= 3). Reads outside x
// give zero, so the padded copy never exists; pads (0, 0) are the Pallas
// kernel's VALID contract.
//
// Replaces gance_tpu/ops/pallas/fused_ops.py::stencil_blur4_valid. In the port
// it serves the discriminator's downsampling blur (conv_downsample_2d: pad
// (2, 2) before the 3x3 Conv1_down, (1, 1) before the 1x1 Skip) and the input
// gradients of kernels C and D (ops/cuda/autograd.py): the input gradient of a
// 4x4 correlation with pads (p0, p1) is the same correlation with the taps
// flipped and pads (3-p0, 3-p1).
// Bound on the H100: memory. It reads each input element once and writes each
// output once (about 2|x| bytes at 3.35 TB/s); its 31 fp32 operations per
// output (16 products, 15 sums: no fused multiply-add, see below) are below
// the fp32 rate, though in bf16 they come within reach of it.
// Design: the row-streaming engine of stencil4.cuh. Each thread owns 16 bytes
// of output columns (4 fp32, 8 bf16) and keeps the partial sums of the four
// output rows in flight in registers: input row k, read once from shared
// memory, adds its tap row 0 to output row k, tap row 1 to output row k-1,
// tap row 2 to k-2 and tap row 3 to k-3, which is then complete and stored.
// So each output's 16 products are summed in row-major tap order starting
// from k[0]*x, the order of the plain twin (fused_ops.py), and the two agree
// bit for bit (--fmad=false). The 16 taps arrive by value as a kernel
// parameter.

#include "stencil4.cuh"

namespace {

using gance::stencil4::Launch;

struct Taps {
  float k[16];  // k[a * 4 + b], row-major
};

template <int V>
struct Stencil16 {
  float acc[4][V];  // acc[s]: the output row started by an input row k with k % 4 == s

  // Input row k (k % 4 == R): tap row a of output row k - a, a = 0..3.
  template <int R>
  __device__ __forceinline__ void row(const float (&v)[V + 3], const Taps& t, float (&o)[V]) {
#pragma unroll
    for (int m = 0; m < V; ++m) {
      float s0 = t.k[0] * v[m];
      s0 = s0 + t.k[1] * v[m + 1];
      s0 = s0 + t.k[2] * v[m + 2];
      s0 = s0 + t.k[3] * v[m + 3];
      float s1 = acc[(R + 3) & 3][m];
      s1 = s1 + t.k[4] * v[m];
      s1 = s1 + t.k[5] * v[m + 1];
      s1 = s1 + t.k[6] * v[m + 2];
      s1 = s1 + t.k[7] * v[m + 3];
      float s2 = acc[(R + 2) & 3][m];
      s2 = s2 + t.k[8] * v[m];
      s2 = s2 + t.k[9] * v[m + 1];
      s2 = s2 + t.k[10] * v[m + 2];
      s2 = s2 + t.k[11] * v[m + 3];
      float s3 = acc[(R + 1) & 3][m];
      s3 = s3 + t.k[12] * v[m];
      s3 = s3 + t.k[13] * v[m + 1];
      s3 = s3 + t.k[14] * v[m + 2];
      s3 = s3 + t.k[15] * v[m + 3];
      acc[R][m] = s0;
      acc[(R + 3) & 3][m] = s1;
      acc[(R + 2) & 3][m] = s2;
      o[m] = s3;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(gance::stencil4::kMaxUnitThreads,
                                  gance::stencil4::min_blocks<T>(2))
    stencil_kernel(const T* __restrict__ x, T* __restrict__ out, Launch l, Taps taps) {
  constexpr int V = gance::stencil4::vec_of(sizeof(T));
  Stencil16<V> op;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int m = 0; m < V; ++m) op.acc[s][m] = 0.f;
  }
  if (blockIdx.x < l.blocks0) {
    gance::stencil4::stream_strip<T>(x, out, l.part[0], blockIdx.x, taps, op);
  } else {
    gance::stencil4::stream_strip<T>(x, out, l.part[1], blockIdx.x - l.blocks0, taps, op);
  }
}

template <typename T>
int launch(const void* x, void* out, long planes, int h, int w, int pad0, int h_out, int w_out,
           const Taps& taps, cudaStream_t stream) {
  return gance::stencil4::launch_columns(
      sizeof(T), planes, planes * h * static_cast<long>(w), h, w, w, pad0, h_out, w_out,
      [&](const Launch& l, unsigned blocks, int threads, size_t smem) {
        stencil_kernel<T><<<blocks, threads, smem, stream>>>(static_cast<const T*>(x),
                                                              static_cast<T*>(out), l, taps);
      });
}

}  // namespace

extern "C" int gance_stencil_blur4_valid(const void* x, void* out, long planes, int h, int w,
                                         int pad0, int pad1, const float* taps, int dtype,
                                         void* stream) {
  const int h_out = h + pad0 + pad1 - 3;
  const int w_out = w + pad0 + pad1 - 3;
  if (planes <= 0 || pad0 < 0 || pad0 > 3 || pad1 < 0 || pad1 > 3 || h < 1 || w < 1 ||
      h_out < 1 || w_out < 1) {
    return cudaErrorInvalidValue;
  }
  Taps k;
  for (int t = 0; t < 16; ++t) k.k[t] = taps[t];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gance::kFloat32) {
    return launch<float>(x, out, planes, h, w, pad0, h_out, w_out, k, s);
  }
  if (dtype == gance::kBFloat16) {
    return launch<__nv_bfloat16>(x, out, planes, h, w, pad0, h_out, w_out, k, s);
  }
  return cudaErrorInvalidValue;
}
