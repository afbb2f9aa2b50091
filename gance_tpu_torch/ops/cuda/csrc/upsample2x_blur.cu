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
// input pixel). The output is 80% of the bytes.
// Design: each thread owns V consecutive input columns of one plane (V = 8
// bytes: 2 fp32 or 4 bf16) and walks down kRows input rows, keeping the
// horizontal phases of three rows (above, this, below) in registers, so each
// input row is read once per thread. A row is one 8-byte load of its V
// columns plus the two neighbour columns (L1 hits: the neighbouring threads
// load them). Each input row gives two output rows of 2V elements, each one
// 16-byte store with the streaming hint, so a warp's store covers 512
// contiguous bytes. Units of 16 input bytes, whose two 16-byte stores a row
// each cover half of every 32-byte sector they touch, ran at 47% of the
// bound in fp32 at the largest launch, against 76% for this design and
// 69-72% for the 8-byte stores of the kernel it replaced (on an H100). A plane
// narrower than a block's threads shares the block with other row strips
// (threadIdx.y). The vector path needs W a multiple of V, x aligned to a
// unit and out to 16 bytes; anything else (ragged or odd widths, a view with
// a storage offset) takes the scalar path of the same kernel: the same map
// with element loads and stores, guarded at the right edge. The TPU kernel's
// lane folding of (W, C) has no counterpart here: NCHW already puts W on the
// fast axis.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;        // input rows a thread walks down
constexpr int kUnitBytes = 8;   // input bytes of a thread's columns

// V = kCols<T> input columns a thread owns, loaded as one InVec<T>.
template <typename T>
constexpr int kCols = kUnitBytes / static_cast<int>(sizeof(T));
template <typename T>
using InVec = gance::Vec8<T>;

struct Taps {
  float k0, k1, k2, k3;
};

// Row `i` of the plane at columns j0-1 .. j0+V into v, zeros outside the image.
template <typename T, int V, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ plane, int i, int h, int w, int j0,
                                         float (&v)[V + 2]) {
  if (i < 0 || i >= h) {
#pragma unroll
    for (int m = 0; m < V + 2; ++m) v[m] = 0.f;
    return;
  }
  const T* row = plane + static_cast<long>(i) * w;
  if (VEC) {
    float f[V];
    gance::unpack(__ldg(reinterpret_cast<const InVec<T>*>(row + j0)), f);
#pragma unroll
    for (int m = 0; m < V; ++m) v[m + 1] = f[m];
    v[0] = j0 > 0 ? gance::to_float(row[j0 - 1]) : 0.f;
    v[V + 1] = j0 + V < w ? gance::to_float(row[j0 + V]) : 0.f;
  } else {
#pragma unroll
    for (int m = 0; m < V + 2; ++m) {
      const int j = j0 - 1 + m;
      v[m] = (j >= 0 && j < w) ? gance::to_float(row[j]) : 0.f;
    }
  }
}

// The horizontal phases of one row: even k0*left + k2*mid, odd k1*mid + k3*right.
template <typename T, int V, bool VEC>
__device__ __forceinline__ void horizontal(const T* __restrict__ plane, int i, int h, int w,
                                           int j0, const Taps& k, float (&he)[V],
                                           float (&ho)[V]) {
  float v[V + 2];
  load_row<T, V, VEC>(plane, i, h, w, j0, v);
#pragma unroll
  for (int m = 0; m < V; ++m) {
    he[m] = k.k0 * v[m] + k.k2 * v[m + 1];
    ho[m] = k.k1 * v[m + 1] + k.k3 * v[m + 2];
  }
}

// One output row of 2V elements from the horizontal phases of two input rows:
// a * (row above) + b * (row below), even and odd columns interleaved.
template <typename T, int V, bool VEC>
__device__ __forceinline__ void store_row(T* __restrict__ orow, int j0, int w, float a, float b,
                                          const float (&he0)[V], const float (&ho0)[V],
                                          const float (&he1)[V], const float (&ho1)[V]) {
  float o[2 * V];
#pragma unroll
  for (int m = 0; m < V; ++m) {
    o[2 * m] = a * he0[m] + b * he1[m];
    o[2 * m + 1] = a * ho0[m] + b * ho1[m];
  }
  if (VEC) {
    constexpr int kOut = gance::kVec<T>;  // elements of one 16-byte store
    auto* p = reinterpret_cast<gance::Vec16<T>*>(orow + 2 * j0);
#pragma unroll
    for (int q = 0; q < 2 * V / kOut; ++q) {
      float part[kOut];
#pragma unroll
      for (int m = 0; m < kOut; ++m) part[m] = o[q * kOut + m];
      gance::store_stream(p + q, gance::pack(part));
    }
  } else {
#pragma unroll
    for (int m = 0; m < V; ++m) {
      if (j0 + m < w) {
        orow[2 * (j0 + m)] = gance::from_float<T>(o[2 * m]);
        orow[2 * (j0 + m) + 1] = gance::from_float<T>(o[2 * m + 1]);
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
upsample2x_blur_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w, Taps k,
                       int col_tiles) {
  constexpr int V = kCols<T>;
  const long plane = blockIdx.x / col_tiles;
  const int j0 = ((blockIdx.x % col_tiles) * blockDim.x + threadIdx.x) * V;
  const int r0 = (blockIdx.y * blockDim.y + threadIdx.y) * kRows;
  if (j0 >= w || r0 >= h) return;
  const T* xp = x + plane * h * static_cast<long>(w);
  const long w2 = 2L * w;
  T* op = out + plane * (2L * h) * w2;

  float he_up[V], ho_up[V], he[V], ho[V], he_dn[V], ho_dn[V];
  horizontal<T, V, VEC>(xp, r0 - 1, h, w, j0, k, he_up, ho_up);
  horizontal<T, V, VEC>(xp, r0, h, w, j0, k, he, ho);
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int i = r0 + t;
    if (i >= h) break;
    horizontal<T, V, VEC>(xp, i + 1, h, w, j0, k, he_dn, ho_dn);
    T* orow = op + 2L * i * w2;
    store_row<T, V, VEC>(orow, j0, w, k.k0, k.k2, he_up, ho_up, he, ho);
    store_row<T, V, VEC>(orow + w2, j0, w, k.k1, k.k3, he, ho, he_dn, ho_dn);
#pragma unroll
    for (int m = 0; m < V; ++m) {
      he_up[m] = he[m];
      ho_up[m] = ho[m];
      he[m] = he_dn[m];
      ho[m] = ho_dn[m];
    }
  }
}

long ceil_div(long a, long b) { return (a + b - 1) / b; }

// The launch geometry, mirrored in numpy by tests/test_torch_kernels.py::b_plan.
struct Plan {
  int col_threads;  // blockDim.x: V-column units of one row side by side
  int strips;       // blockDim.y: row strips side by side
  long col_tiles, row_tiles;
};

Plan plan(int h, int w, int v) {
  Plan p;
  const long units = ceil_div(w, v);
  long t = 1;
  while (t < units && t < kThreads) t *= 2;
  p.col_threads = static_cast<int>(t);
  p.strips = kThreads / p.col_threads;
  p.col_tiles = ceil_div(units, p.col_threads);
  p.row_tiles = ceil_div(h, static_cast<long>(p.strips) * kRows);
  return p;
}

template <typename T, bool VEC>
int launch(const void* x, void* out, long planes, int h, int w, Taps k, cudaStream_t stream) {
  const Plan p = plan(h, w, kCols<T>);
  if (planes * p.col_tiles > 2147483647L || p.row_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(planes * p.col_tiles), static_cast<unsigned>(p.row_tiles));
  const dim3 block(p.col_threads, p.strips);
  upsample2x_blur_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), h, w, k, static_cast<int>(p.col_tiles));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, void* out, long planes, int h, int w, Taps k, cudaStream_t stream) {
  const bool vector = w % kCols<T> == 0 && gance::aligned(x, kUnitBytes) &&
                      gance::aligned(out, 16);
  return vector ? launch<T, true>(x, out, planes, h, w, k, stream)
                : launch<T, false>(x, out, planes, h, w, k, stream);
}

}  // namespace

extern "C" int gance_upsample2x_blur(const void* x, void* out, long planes, int h, int w,
                                     float k0, float k1, float k2, float k3, int dtype,
                                     void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return cudaErrorInvalidValue;
  const Taps k{k0, k1, k2, k3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gance::kFloat32) return dispatch<float>(x, out, planes, h, w, k, s);
  if (dtype == gance::kBFloat16) return dispatch<__nv_bfloat16>(x, out, planes, h, w, k, s);
  return cudaErrorInvalidValue;
}
