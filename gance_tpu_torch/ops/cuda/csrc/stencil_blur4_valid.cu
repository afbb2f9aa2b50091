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
// output once (about 2|x| bytes at 3.35 TB/s); its 16 products per output are
// far below the fp32 rate.
// Design: one block takes a TH x TW output tile of one (b, c) plane. It stages
// the (TH+3) x (TW+3) input halo in shared memory as fp32 (zeros outside the
// image stand in for the pad) and each thread sums its 16 products from there,
// in row-major tap order, the order of the plain twin (fused_ops.py). Each
// input element is read from device memory about (1 + 3/TH)(1 + 3/TW) times;
// threads of a warp take neighbouring columns, so loads and stores coalesce.
// The 16 taps arrive by value as a kernel parameter.

#include "common.cuh"

namespace {

constexpr int kTW = 64;  // tile width = blockDim.x
constexpr int kTH = 32;  // tile height
constexpr int kRows = 8;  // blockDim.y

struct Taps {
  float k[16];  // k[a * 4 + b], row-major
};

template <typename T>
__global__ void stencil_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w,
                               int pad0, int h_out, int w_out, Taps taps, int tiles_x) {
  __shared__ float halo[kTH + 3][kTW + 3];

  const long plane = blockIdx.x / tiles_x;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const int y0 = blockIdx.y * kTH;
  const T* xp = x + plane * h * static_cast<long>(w);

  // halo[r][c] = x[y0 + r - pad0][x0 + c - pad0], zero outside [0, h) x [0, w)
  for (int r = threadIdx.y; r < kTH + 3; r += kRows) {
    const int gy = y0 + r - pad0;
    for (int c = threadIdx.x; c < kTW + 3; c += kTW) {
      const int gx = x0 + c - pad0;
      halo[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                       ? gance::to_float(xp[static_cast<long>(gy) * w + gx])
                       : 0.f;
    }
  }
  __syncthreads();

  const int c = threadIdx.x;
  const int gx = x0 + c;
  if (gx >= w_out) return;
  T* op = out + plane * h_out * static_cast<long>(w_out);
  for (int r = threadIdx.y; r < kTH; r += kRows) {
    const int gy = y0 + r;
    if (gy >= h_out) break;
    float acc = taps.k[0] * halo[r][c];
#pragma unroll
    for (int t = 1; t < 16; ++t) {
      acc = acc + taps.k[t] * halo[r + t / 4][c + t % 4];
    }
    op[static_cast<long>(gy) * w_out + gx] = gance::from_float<T>(acc);
  }
}

template <typename T>
void launch(const void* x, void* out, long planes, int h, int w, int pad0, int h_out, int w_out,
            const Taps& taps, cudaStream_t stream) {
  const int tiles_x = (w_out + kTW - 1) / kTW;
  dim3 block(kTW, kRows);
  dim3 grid(static_cast<unsigned>(planes * tiles_x), (h_out + kTH - 1) / kTH);
  stencil_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                                h, w, pad0, h_out, w_out, taps, tiles_x);
}

}  // namespace

extern "C" int gance_stencil_blur4_valid(const void* x, void* out, long planes, int h, int w,
                                         int pad0, int pad1, const float* taps, int dtype,
                                         void* stream) {
  const int h_out = h + pad0 + pad1 - 3;
  const int w_out = w + pad0 + pad1 - 3;
  const long tiles_x = (w_out + kTW - 1) / kTW;
  if (planes <= 0 || pad0 < 0 || pad0 > 3 || pad1 < 0 || pad1 > 3 || h < 1 || w < 1 ||
      h_out < 1 || w_out < 1 || planes * tiles_x > 2147483647L ||
      (h_out + kTH - 1) / kTH > 65535) {
    return cudaErrorInvalidValue;
  }
  Taps k;
  for (int t = 0; t < 16; ++t) k.k[t] = taps[t];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gance::kFloat32) {
    launch<float>(x, out, planes, h, w, pad0, h_out, w_out, k, s);
  } else if (dtype == gance::kBFloat16) {
    launch<__nv_bfloat16>(x, out, planes, h, w, pad0, h_out, w_out, k, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
