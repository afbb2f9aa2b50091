// Kernel C: the smoothing FIR after the transpose conv of an up-sampling
// modulated conv,
//     upfirdn2d(x[..., :w_logical], outer(taps, taps), pad0=1, pad1=1)
// on NCHW x (B, C, H, Wp) -> (B, C, H-1, w_logical-1), as two separable 4-tap
// passes: out[i][j] = sum_a sum_b taps[a] * taps[b] * xp[i+a][j+b], where xp is
// x cut to w_logical columns and padded by one zero on each side. Columns at
// or past w_logical are never read.
//
// Replaces gance_tpu/ops/pallas/fused_ops.py::blur4_separable_pad11 (both its
// general kernel and its C=64 lane-folded kernel; the fold is a TPU layout
// trick with no counterpart in NCHW).
// Bound on the H100: memory. It reads H*w_logical and writes
// (H-1)*(w_logical-1) elements of each plane, about 2|x| bytes at 3.35 TB/s;
// its 16 flops per output are far below the fp32 rate.
// Design: one block takes a TH x TW output tile of one (b, c) plane. It stages
// the (TH+3) x (TW+3) input halo in shared memory as fp32 (zeros outside the
// image stand in for the pad), runs the vertical 4-tap into a second shared
// buffer and the horizontal 4-tap from there, and writes the tile. Each input
// element is read from device memory about (1 + 3/TH)(1 + 3/TW) times; threads
// of a warp take neighbouring columns, so loads and stores coalesce.

#include "common.cuh"

namespace {

constexpr int kTW = 64;  // tile width = blockDim.x
constexpr int kTH = 32;  // tile height
constexpr int kRows = 8;  // blockDim.y

template <typename T>
__global__ void blur4_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int wp,
                             int w_logical, float t0, float t1, float t2, float t3,
                             int tiles_x) {
  __shared__ float halo[kTH + 3][kTW + 3];
  __shared__ float vert[kTH][kTW + 3];

  const long plane = blockIdx.x / tiles_x;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const int y0 = blockIdx.y * kTH;
  const int h_out = h - 1;
  const int w_out = w_logical - 1;
  const T* xp = x + plane * h * static_cast<long>(wp);

  // halo[r][c] = xp[y0 + r - 1][x0 + c - 1], zero outside [0, h) x [0, w_logical)
  for (int r = threadIdx.y; r < kTH + 3; r += kRows) {
    const int gy = y0 + r - 1;
    for (int c = threadIdx.x; c < kTW + 3; c += kTW) {
      const int gx = x0 + c - 1;
      halo[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w_logical)
                       ? gance::to_float(xp[static_cast<long>(gy) * wp + gx])
                       : 0.f;
    }
  }
  __syncthreads();

  for (int r = threadIdx.y; r < kTH; r += kRows) {
    for (int c = threadIdx.x; c < kTW + 3; c += kTW) {
      vert[r][c] = t0 * halo[r][c] + t1 * halo[r + 1][c] + t2 * halo[r + 2][c] +
                   t3 * halo[r + 3][c];
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
    const float v = t0 * vert[r][c] + t1 * vert[r][c + 1] + t2 * vert[r][c + 2] +
                    t3 * vert[r][c + 3];
    op[static_cast<long>(gy) * w_out + gx] = gance::from_float<T>(v);
  }
}

template <typename T>
void launch(const void* x, void* out, long planes, int h, int wp, int w_logical, float t0,
            float t1, float t2, float t3, cudaStream_t stream) {
  const int tiles_x = (w_logical - 1 + kTW - 1) / kTW;
  dim3 block(kTW, kRows);
  dim3 grid(static_cast<unsigned>(planes * tiles_x), (h - 1 + kTH - 1) / kTH);
  blur4_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                              h, wp, w_logical, t0, t1, t2, t3, tiles_x);
}

}  // namespace

extern "C" int gance_blur4_separable_pad11(const void* x, void* out, long planes, int h, int wp,
                                           int w_logical, float t0, float t1, float t2,
                                           float t3, int dtype, void* stream) {
  const long tiles_x = (w_logical - 1 + kTW - 1) / kTW;
  if (planes <= 0 || h < 2 || w_logical < 2 || w_logical > wp ||
      planes * tiles_x > 2147483647L || (h - 1 + kTH - 1) / kTH > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gance::kFloat32) {
    launch<float>(x, out, planes, h, wp, w_logical, t0, t1, t2, t3, s);
  } else if (dtype == gance::kBFloat16) {
    launch<__nv_bfloat16>(x, out, planes, h, wp, w_logical, t0, t1, t2, t3, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
