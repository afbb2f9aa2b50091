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
// trick with no counterpart in NCHW). A second entry point, at the end of this
// file, reads x as the four output phases of the transposed conv before it.
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

// Kernel C over the phase planes of a transposed conv (fp32): the blur above,
//     out[r][c] = sum_b taps[b] * sum_a taps[a] * yp[r+a][c+b],
// with yp the pre-blur tensor y (2h+1, 2w+1) padded by one zero on each side,
// read from the four output phases of the stride-2 3x3 transposed conv that
// made y, y[2m+i][2n+j] = p_ij[m][n], p_ij of (h+1-i) x (w+1-j), instead of
// from y itself. The phases are what `upsample_conv_2d` computes (one stride-1
// conv each), so no pass interleaves them into y: that pass read and wrote the
// pre-blur tensors once more, 8.5 ms of a 1024px fp32 batch of 8 on an H100.
//
// Bound on the H100: memory. It reads the phases once (|y| elements) and
// writes 4hw outputs a plane, about 2|y| fp32 bytes at 3.35 TB/s; its 14
// flops per output are far below the fp32 rate.
// Design: a thread owns output columns 2n and 2n+1 of one (b, c) plane and
// walks a strip of kRows output row pairs. Output rows 2m and 2m+1 read y
// rows 2m-1 .. 2m+3, y columns 2n-1 .. 2n+3 (odd n-1, even n, odd n, even
// n+1, odd n+1): five windows of five values, of which the thread keeps three
// from the row pair before and loads two (one from p_00 and p_01, one from
// p_10 and p_11). A warp's loads of one phase row are contiguous, the
// neighbours' columns come from L1, and each row pair is stored as two 8-byte
// pieces a thread. Every sum runs in the order of the twin (vertical, then
// horizontal, taps left to right; --fmad=false) with zeros for the samples
// outside y, so the kernel equals the form above on the interleaved y bit for
// bit. fp32 only: bf16 `Conv0_up` keeps the transposed conv.

namespace {

constexpr int kPhaseThreads = 256;
constexpr int kRows = 16;  // output row pairs a thread walks

struct Planes {
  const float* p00;  // (h+1, w+1) a plane: even rows, even columns of y
  const float* p01;  // (h+1, w): even rows, odd columns
  const float* p10;  // (h, w+1): odd rows, even columns
  const float* p11;  // (h, w): odd rows, odd columns
};

__device__ __forceinline__ float sum4(const Taps& t, float a, float b, float c, float d) {
  return t.t0 * a + t.t1 * b + t.t2 * c + t.t3 * d;
}

// One y row, from row m of its even-column and odd-column phases, at y columns
// 2n-1 .. 2n+3: zeros outside y (`rows` is the phases' row count).
__device__ __forceinline__ void window(const float* __restrict__ even,
                                       const float* __restrict__ oddc, int m, int rows, int n,
                                       int w, float (&v)[5]) {
  const bool in = m >= 0 && m < rows;
  const float* e = even + static_cast<long>(m) * (w + 1);
  const float* o = oddc + static_cast<long>(m) * w;
  v[0] = in && n >= 1 ? __ldg(o + n - 1) : 0.f;
  v[1] = in ? __ldg(e + n) : 0.f;
  v[2] = in ? __ldg(o + n) : 0.f;
  v[3] = in ? __ldg(e + n + 1) : 0.f;
  v[4] = in && n + 1 < w ? __ldg(o + n + 1) : 0.f;
}

__global__ void __launch_bounds__(kPhaseThreads)
    blur4_phases_kernel(Planes p, float* __restrict__ out, long planes, int h, int w, Taps t) {
  const long idx = static_cast<long>(blockIdx.x) * kPhaseThreads + threadIdx.x;
  if (idx >= planes * w) return;
  const long plane = idx / w;
  const int n = static_cast<int>(idx - plane * w);
  const int m0 = static_cast<int>(blockIdx.y) * kRows;
  const int m1 = min(m0 + kRows, h);
  const float* p00 = p.p00 + plane * (h + 1) * static_cast<long>(w + 1);
  const float* p01 = p.p01 + plane * (h + 1) * static_cast<long>(w);
  const float* p10 = p.p10 + plane * h * static_cast<long>(w + 1);
  const float* p11 = p.p11 + plane * h * static_cast<long>(w);
  float* o = out + plane * (2L * h) * (2L * w) + 2 * n;

  // y rows 2m-1, 2m, 2m+1 (odd m-1, even m, odd m) of the first row pair
  float y0[5], y1[5], y2[5], y3[5], y4[5];
  window(p10, p11, m0 - 1, h, n, w, y0);
  window(p00, p01, m0, h + 1, n, w, y1);
  window(p10, p11, m0, h, n, w, y2);
  for (int m = m0; m < m1; ++m) {
    window(p00, p01, m + 1, h + 1, n, w, y3);  // y row 2m+2
    window(p10, p11, m + 1, h, n, w, y4);      // y row 2m+3
    float ve[5], vo[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      ve[k] = sum4(t, y0[k], y1[k], y2[k], y3[k]);  // output row 2m
      vo[k] = sum4(t, y1[k], y2[k], y3[k], y4[k]);  // output row 2m+1
    }
    float* row = o + static_cast<long>(2 * m) * (2 * w);
    *reinterpret_cast<float2*>(row) =
        make_float2(sum4(t, ve[0], ve[1], ve[2], ve[3]), sum4(t, ve[1], ve[2], ve[3], ve[4]));
    *reinterpret_cast<float2*>(row + 2 * w) =
        make_float2(sum4(t, vo[0], vo[1], vo[2], vo[3]), sum4(t, vo[1], vo[2], vo[3], vo[4]));
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      y0[k] = y2[k];
      y1[k] = y3[k];
      y2[k] = y4[k];
    }
  }
}

}  // namespace

extern "C" int gance_blur4_separable_pad11_phases(const void* p00, const void* p01,
                                                  const void* p10, const void* p11, void* out,
                                                  long planes, int h, int w, float t0, float t1,
                                                  float t2, float t3, void* stream) {
  if (planes <= 0 || h < 1 || w < 1) return cudaErrorInvalidValue;
  if (!gance::aligned(p00, 4) || !gance::aligned(p01, 4) || !gance::aligned(p10, 4) ||
      !gance::aligned(p11, 4) || !gance::aligned(out, 8)) {
    return cudaErrorInvalidValue;
  }
  const long blocks_x = (planes * w + kPhaseThreads - 1) / kPhaseThreads;
  if (blocks_x > 2147483647L) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>((h + kRows - 1) / kRows));
  const Planes p{static_cast<const float*>(p00), static_cast<const float*>(p01),
                 static_cast<const float*>(p10), static_cast<const float*>(p11)};
  blur4_phases_kernel<<<grid, kPhaseThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<float*>(out), planes, h, w, Taps{t0, t1, t2, t3});
  return static_cast<int>(cudaGetLastError());
}
