// Kernel C: the smoothing FIR after the transpose conv of an up-sampling
// modulated conv,
//     upfirdn2d(x[..., :w_logical], outer(taps, taps), pad0=1, pad1=1)
// on NCHW x (B, C, H, Wp) -> (B, C, H-1, w_logical-1), as two separable 4-tap
// passes: out[i][j] = sum_a sum_b taps[a] * taps[b] * xp[i+a][j+b], where xp is
// x cut to w_logical columns and padded by one zero on each side. Columns at
// or past w_logical never enter a sum.
//
// Replaces gance_tpu/ops/pallas/fused_ops.py::blur4_separable_pad11 (both its
// general kernel and its C=64 lane-folded kernel; the fold is a TPU layout
// trick with no counterpart in NCHW).
// Bound on the H100: memory. It reads H*w_logical and writes
// (H-1)*(w_logical-1) elements of each plane, about 2|x| bytes at 3.35 TB/s;
// its 14 flops per output are far below the fp32 rate.
// Design: the row-streaming engine of stencil4.cuh with pad 1, the row
// stride Wp and w_logical columns. Each thread owns 16 bytes of output
// columns (4 fp32, 8 bf16) and keeps, for its V+3 input columns (the 3 halo
// columns recomputed beside its neighbour), the vertical partial sums of the
// four output rows in flight: input row k adds taps[a] * x to output row k-a.
// When output row k-3's vertical sums are complete, the horizontal 4-tap
// runs on them and the row is stored. Both passes sum left to right, as the
// plain twin (fused_ops.py) does, so the two agree bit for bit (--fmad=false).

#include "stencil4.cuh"

namespace {

using gance::stencil4::Launch;

struct Taps {
  float t0, t1, t2, t3;
};

template <int V>
struct Separable4 {
  float vert[4][V + 3];  // vert[s]: the vertical sums of the output row started when k % 4 == s

  // Input row k (k % 4 == R): taps[a] * x into output row k - a, a = 0..3.
  template <int R>
  __device__ __forceinline__ void row(const float (&v)[V + 3], const Taps& t, float (&o)[V]) {
#pragma unroll
    for (int m = 0; m < V + 3; ++m) {
      vert[(R + 1) & 3][m] = vert[(R + 1) & 3][m] + t.t3 * v[m];
      vert[(R + 2) & 3][m] = vert[(R + 2) & 3][m] + t.t2 * v[m];
      vert[(R + 3) & 3][m] = vert[(R + 3) & 3][m] + t.t1 * v[m];
    }
#pragma unroll
    for (int m = 0; m < V; ++m) {
      o[m] = t.t0 * vert[(R + 1) & 3][m] + t.t1 * vert[(R + 1) & 3][m + 1] +
             t.t2 * vert[(R + 1) & 3][m + 2] + t.t3 * vert[(R + 1) & 3][m + 3];
    }
#pragma unroll
    for (int m = 0; m < V + 3; ++m) vert[R][m] = t.t0 * v[m];
  }
};

template <typename T>
__global__ void __launch_bounds__(gance::stencil4::kMaxUnitThreads,
                                  gance::stencil4::min_blocks<T>(1))
    blur4_kernel(const T* __restrict__ x, T* __restrict__ out, Launch l, Taps taps) {
  constexpr int V = gance::stencil4::vec_of(sizeof(T));
  Separable4<V> op;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int m = 0; m < V + 3; ++m) op.vert[s][m] = 0.f;
  }
  if (blockIdx.x < l.blocks0) {
    gance::stencil4::stream_strip<T>(x, out, l.part[0], blockIdx.x, taps, op);
  } else {
    gance::stencil4::stream_strip<T>(x, out, l.part[1], blockIdx.x - l.blocks0, taps, op);
  }
}

template <typename T>
int launch(const void* x, void* out, long planes, int h, int wp, int w_logical, const Taps& taps,
           cudaStream_t stream) {
  return gance::stencil4::launch_columns(
      sizeof(T), planes, planes * h * static_cast<long>(wp), h, wp, w_logical, 1, h - 1,
      w_logical - 1, [&](const Launch& l, unsigned blocks, int threads, size_t smem) {
        blur4_kernel<T><<<blocks, threads, smem, stream>>>(static_cast<const T*>(x),
                                                            static_cast<T*>(out), l, taps);
      });
}

}  // namespace

extern "C" int gance_blur4_separable_pad11(const void* x, void* out, long planes, int h, int wp,
                                           int w_logical, float t0, float t1, float t2,
                                           float t3, int dtype, void* stream) {
  if (planes <= 0 || h < 2 || w_logical < 2 || w_logical > wp) {
    return cudaErrorInvalidValue;
  }
  const Taps taps{t0, t1, t2, t3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gance::kFloat32) {
    return launch<float>(x, out, planes, h, wp, w_logical, taps, s);
  }
  if (dtype == gance::kBFloat16) {
    return launch<__nv_bfloat16>(x, out, planes, h, wp, w_logical, taps, s);
  }
  return cudaErrorInvalidValue;
}
