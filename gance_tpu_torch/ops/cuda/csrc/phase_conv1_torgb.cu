// Kernel E: the top synthesis block's Conv1 + demod/noise/bias/lrelu + ToRGB
// in phase space, in one pass (ops/phase_block.py):
//     rgb[b] = lrelu(conv2d(x[b], w4, pad 1) * demod[b] + noise_bias, 0.2) @ wrgb[b]
// on NCHW x (B, C4, H, W), OIHW w4 (C4, C4, 2, 2) (passed transposed as
// wt (C4, 2, 2, C4) = [in][kh][kw][out]), demod (B, C4) fp32, noise_bias
// (1 or B, C4, H+1, W+1), wrgb (B, C4, 16) with sqrt(2) * s_rgb folded in;
// output (B, 16, H+1, W+1). The conv is a cross-correlation, as in
// lax.conv_general_dilated. In bf16 the activation z is rounded to bf16 before
// the ToRGB product, as the TPU kernel does; every sum is taken in fp32.
//
// Replaces gance_tpu/ops/pallas/phase_fused.py::phase_conv1_torgb_fused.
// Bound on the H100: operations. At 1024px (C4 = 256, H = W = 512, batch 8)
// the dense folded contraction is 2 * 8 * 513^2 * 256 * 1024 = 1.10e12 flops
// (16.5 ms at 67 TFLOP/s fp32 outside the tensor cores, 1.1 ms at 989 TFLOP/s
// bf16), of which 36 of the 64 (tap, in-phase, out-phase) blocks are non-zero;
// it moves about 2.6 GB (fp32), 0.8 ms at 3.35 TB/s.
// Design: one block takes a tile of 64 output pixels of one image and all C4
// output channels (in slabs of 256), so the ToRGB contraction over C4 can run
// inside the block and the activated (B, C4, H+1, W+1) tensor never reaches
// device memory (the point of the TPU kernel). The main loop walks the
// K = 4 * C4 reduction in chunks: the chunk's weights (out contiguous) and
// its inputs with their one-pixel halo are staged in shared memory, zeros
// standing in for the padding.
//   * fp32: SIMT FMA, no TF32 (the port's exact tier). An 8 x 8 pixel tile;
//     256 threads, each holds 8 pixels x 8 channels of the 64 x 256
//     accumulator tile in registers; a thread's 8 pixels are one tile row,
//     so the two column taps share 7 of their 9 staged inputs.
//   * bf16: WMMA 16x16x16 bf16 products (mma.sync) with fp32 accumulators on
//     a 4 x 16 pixel tile. The halo is staged pixel-major with its 16 chunk
//     channels contiguous, so the A operand of tap (kh, kw) for one tile row
//     is a plain 16 x 16 window of it (row stride 16) and no im2col copy is
//     made; the weights are staged tap-major. Each of the 8 warps owns 2 tile
//     rows x 64 channels (2 x 4 fragments). The weights reach shared memory
//     by cp.async (no registers, all of a thread's copies in flight at once);
//     the halo's loads are issued before the block waits for the previous
//     chunk's products.
// Both then write the fp32 sums to a channel-major [C4][64] tile in shared
// memory, apply demod, noise_bias and lrelu there (rounding z to the working
// type), and each thread takes one pixel's sum over C4 for 4 of the 16 RGB
// columns. The wrapper sets the grid so that neighbouring blocks are the same
// tile of successive images: a batch-invariant noise_bias tile is then read
// from device memory once and from L2 after. Skipping the zero blocks, wgmma
// and TMA are left for later.

#include "common.cuh"  // cuda_bf16.h before mma.h, for the bf16 fragments

#include <mma.h>

namespace {

constexpr int kP = 64;                // output pixels per block
constexpr int kSlab = 256;            // output channels per pass of the main loop
constexpr int kThreads = 256;
constexpr int kRgb = 16;              // RGB phase columns (4 phases x up to 4 channels)
constexpr int kMaxC4 = 512;

// fp32 path
constexpr int kTH = 8;                // output tile rows
constexpr int kTW = 8;                // output tile columns
constexpr int kHalo = (kTH + 1) * (kTW + 1);
constexpr int kKC32 = 8;              // input channels per chunk (x 4 taps = 32 rows of k)
constexpr int kZld32 = kP + 1;        // z tile stride: odd, so column reads spread over banks

// bf16 path
constexpr int kTH16 = 4;              // output tile rows
constexpr int kTW16 = 16;             // output tile columns: one WMMA row block
constexpr int kHalo16 = (kTH16 + 1) * (kTW16 + 1);  // halo positions
constexpr int kKC16 = 16;             // input channels per chunk (x 4 taps = 64 rows of k)
constexpr int kK16 = kKC16 * 4;
constexpr int kHaloLd16 = 1408;       // halo tile size (bf16), kHalo16 * 16 rounded to 128 B
constexpr int kBLd = kSlab + 8;       // weight tile stride (bf16 elements, multiple of 8)
constexpr int kZld16 = kP + 4;        // z tile stride (floats, multiple of 4 for WMMA stores)
constexpr int kHaloIters16 = (kHalo16 * kKC16 + kThreads - 1) / kThreads;
constexpr int kWIters16 = kK16 * (kSlab / 4) / kThreads;  // 8-byte weight copies per thread

struct Args {
  const void* x;
  const void* wt;
  const float* demod;
  const void* nb;
  const void* wrgb;
  void* out;
  int c4, h, w, batch, nb_batched, tiles_x;
};

struct Tile {
  int b, m0, n0;  // image and the output tile's first row and column
};

// An 8-byte copy from device to shared memory that bypasses the registers;
// zeros when !valid (then nothing is read from `src`).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int TH, int TW>
__device__ __forceinline__ Tile tile_of_block(const Args& a) {
  const int image = blockIdx.x % a.batch;
  const int tile = blockIdx.x / a.batch;
  return {image, (tile / a.tiles_x) * TH, (tile % a.tiles_x) * TW};
}

// z[c][p] = lrelu(acc[c][p] * demod[c] + noise_bias[c][p]), rounded to T; then
// wr[c][k] = wrgb[b][c][k] as fp32 (staged in `wr`, which may alias the main
// loop's buffers). Pixel p of the tile is row p / TW, column p % TW.
template <typename T, int ZLD, int TW>
__device__ void epilogue_and_torgb(const Args& a, const Tile& t, float* zs, float* wr) {
  const int ho = a.h + 1, wo = a.w + 1;
  const long plane = static_cast<long>(ho) * wo;
  const T* nb = static_cast<const T*>(a.nb) +
                (a.nb_batched ? static_cast<long>(t.b) * a.c4 * plane : 0L);
  const float* demod = a.demod + static_cast<long>(t.b) * a.c4;
  const T* wrgb = static_cast<const T*>(a.wrgb) + static_cast<long>(t.b) * a.c4 * kRgb;

  for (int idx = threadIdx.x; idx < a.c4 * kP; idx += kThreads) {
    const int c = idx / kP, p = idx % kP;
    const int m = t.m0 + p / TW, n = t.n0 + p % TW;
    float z = 0.f;
    if (m < ho && n < wo) {
      const long at = c * plane + static_cast<long>(m) * wo + n;
      z = zs[c * ZLD + p] * demod[c] + gance::to_float(nb[at]);
      z = fmaxf(z, z * 0.2f);
      z = gance::to_float(gance::from_float<T>(z));
    }
    zs[c * ZLD + p] = z;
  }
  for (int idx = threadIdx.x; idx < a.c4 * kRgb; idx += kThreads) {
    wr[idx] = gance::to_float(wrgb[idx]);
  }
  __syncthreads();

  // thread -> (pixel p, RGB columns 4*kg .. 4*kg+3); a warp shares kg
  const int p = threadIdx.x % kP;
  const int kg = threadIdx.x / kP;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int c = 0; c < a.c4; ++c) {
    const float z = zs[c * ZLD + p];
    const float4 wv = reinterpret_cast<const float4*>(wr)[c * (kRgb / 4) + kg];
    s0 = __fmaf_rn(z, wv.x, s0);
    s1 = __fmaf_rn(z, wv.y, s1);
    s2 = __fmaf_rn(z, wv.z, s2);
    s3 = __fmaf_rn(z, wv.w, s3);
  }
  const int m = t.m0 + p / TW, n = t.n0 + p % TW;
  if (m < ho && n < wo) {
    T* out = static_cast<T*>(a.out) + (static_cast<long>(t.b) * kRgb + 4 * kg) * plane +
             static_cast<long>(m) * wo + n;
    out[0] = gance::from_float<T>(s0);
    out[plane] = gance::from_float<T>(s1);
    out[2 * plane] = gance::from_float<T>(s2);
    out[3 * plane] = gance::from_float<T>(s3);
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2) phase_f32_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                                   // [c4][kZld32]
  float* ws = zs + a.c4 * kZld32;                     // [kKC32 * 4][kSlab]
  float* xs = ws + kKC32 * 4 * kSlab;                 // [kKC32][kTH + 1][kTW + 1]

  const Tile t = tile_of_block<kTH, kTW>(a);
  const float* x = static_cast<const float*>(a.x) + static_cast<long>(t.b) * a.c4 * a.h * a.w;
  const float* wt = static_cast<const float*>(a.wt);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tp = (warp / 4) * 4 + lane / 8;  // tile row: pixels tp*8 .. tp*8+7
  const int tc = (warp % 4) * 8 + lane % 8;  // channels 4tc..4tc+3 and 128+4tc..128+4tc+3

  for (int s0 = 0; s0 < a.c4; s0 += kSlab) {
    float acc[kTW][8];
#pragma unroll
    for (int j = 0; j < kTW; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[j][q] = 0.f;

    for (int i0 = 0; i0 < a.c4; i0 += kKC32) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < kKC32 * kHalo; idx += kThreads) {
        const int i = idx / kHalo, r = (idx % kHalo) / (kTW + 1), cc = idx % (kTW + 1);
        const int gi = i0 + i, gy = t.m0 + r - 1, gx = t.n0 + cc - 1;
        xs[idx] = (gi < a.c4 && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w)
                      ? x[(static_cast<long>(gi) * a.h + gy) * a.w + gx]
                      : 0.f;
      }
      for (int idx = threadIdx.x; idx < kKC32 * 4 * (kSlab / 4); idx += kThreads) {
        const int k = idx / (kSlab / 4), o = (idx % (kSlab / 4)) * 4;
        const int gk = i0 * 4 + k;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gk < a.c4 * 4 && s0 + o < a.c4) {
          v = *reinterpret_cast<const float4*>(wt + static_cast<long>(gk) * a.c4 + s0 + o);
        }
        *reinterpret_cast<float4*>(ws + k * kSlab + o) = v;
      }
      __syncthreads();

#pragma unroll 2
      for (int i = 0; i < kKC32; ++i) {
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          float xv[kTW + 1];
          const float* row = xs + (i * (kTH + 1) + tp + kh) * (kTW + 1);
#pragma unroll
          for (int j = 0; j <= kTW; ++j) xv[j] = row[j];
#pragma unroll
          for (int kw = 0; kw < 2; ++kw) {
            const float* wrow = ws + (i * 4 + kh * 2 + kw) * kSlab;
            const float4 lo = *reinterpret_cast<const float4*>(wrow + 4 * tc);
            const float4 hi = *reinterpret_cast<const float4*>(wrow + 128 + 4 * tc);
            const float wv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
            for (int j = 0; j < kTW; ++j)
#pragma unroll
              for (int q = 0; q < 8; ++q) acc[j][q] = __fmaf_rn(xv[j + kw], wv[q], acc[j][q]);
          }
        }
      }
    }

#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = s0 + (q < 4 ? 4 * tc + q : 128 + 4 * tc + q - 4);
      if (c < a.c4) {
#pragma unroll
        for (int j = 0; j < kTW; ++j) zs[c * kZld32 + tp * kTW + j] = acc[j][q];
      }
    }
  }
  __syncthreads();
  epilogue_and_torgb<float, kZld32, kTW>(a, t, zs, ws);
}

// ---------------------------------------------------------------------------
// bf16: WMMA on the tensor cores, fp32 accumulation
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2) phase_bf16_kernel(Args a, int c4_16) {
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* zs = reinterpret_cast<float*>(smem_raw);                        // [c4_16][kZld16]
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(zs + c4_16 * kZld16);  // [5][17][16]
  __nv_bfloat16* bs = hs + kHaloLd16;                                     // [4][16][kBLd]

  const Tile t = tile_of_block<kTH16, kTW16>(a);
  const __nv_bfloat16* x =
      static_cast<const __nv_bfloat16*>(a.x) + static_cast<long>(t.b) * a.c4 * a.h * a.w;
  const __nv_bfloat16* wt = static_cast<const __nv_bfloat16*>(a.wt);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int warp = threadIdx.x / 32;
  const int rows = (warp / 4) * 2;   // tile rows rows, rows + 1
  const int cg = (warp % 4) * 64;    // slab channels cg .. cg + 63

  for (int s0 = 0; s0 < a.c4; s0 += kSlab) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[q][j], 0.f);

    for (int i0 = 0; i0 < a.c4; i0 += kKC16) {
      // halo, pixel-major: hs[pos * 16 + i] = x[i0 + i][m0 + r - 1][n0 + cc - 1]
      // with pos = r * 17 + cc; loaded into registers first, then stored
      __nv_bfloat16 hv[kHaloIters16];
#pragma unroll
      for (int it = 0; it < kHaloIters16; ++it) {
        const int idx = it * kThreads + threadIdx.x;
        const int i = idx / kHalo16, pos = idx % kHalo16;
        const int gi = i0 + i, gy = t.m0 + pos / (kTW16 + 1) - 1, gx = t.n0 + pos % (kTW16 + 1) - 1;
        hv[it] = (idx < kHalo16 * kKC16 && gi < a.c4 && gy >= 0 && gy < a.h && gx >= 0 &&
                  gx < a.w)
                     ? x[(static_cast<long>(gi) * a.h + gy) * a.w + gx]
                     : zero;
      }
      __syncthreads();  // the previous chunk's products are done with hs and bs
      // weights, tap-major: bs[(tap * 16 + i) * kBLd + o] = wt[(i0 + i) * 4 + tap][s0 + o],
      // four at a time (c4 % 4 == 0)
#pragma unroll
      for (int it = 0; it < kWIters16; ++it) {
        const int idx = it * kThreads + threadIdx.x;
        const int k = idx / (kSlab / 4), o = (idx % (kSlab / 4)) * 4;
        const int gk = i0 * 4 + k;
        const bool valid = gk < a.c4 * 4 && s0 + o < a.c4;
        cp_async8(bs + ((k % 4) * kKC16 + k / 4) * kBLd + o,
                  valid ? wt + static_cast<long>(gk) * a.c4 + s0 + o : wt, valid);
      }
#pragma unroll
      for (int it = 0; it < kHaloIters16; ++it) {
        const int idx = it * kThreads + threadIdx.x;
        if (idx < kHalo16 * kKC16) hs[(idx % kHalo16) * kKC16 + idx / kHalo16] = hv[it];
      }
      cp_async_wait_all();
      __syncthreads();

#pragma unroll 1
      for (int tap = 0; tap < 4; ++tap) {  // not unrolled: keeps the fragments in registers
        const int kh = tap / 2, kw = tap % 2;
        // A: pixel j of tile row r reads halo position (r + kh) * 17 + j + kw
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          wmma::load_matrix_sync(fa[q], hs + ((rows + q + kh) * (kTW16 + 1) + kw) * kKC16,
                                 kKC16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, bs + tap * kKC16 * kBLd + cg + j * 16, kBLd);
#pragma unroll
          for (int q = 0; q < 2; ++q) wmma::mma_sync(acc[q][j], fa[q], fb, acc[q][j]);
        }
      }
    }

    // zs is channel-major: element (pixel p, channel c) at zs[c * kZld16 + p]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = s0 + cg + j * 16;
      if (c < c4_16) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          wmma::store_matrix_sync(zs + c * kZld16 + (rows + q) * kTW16, acc[q][j], kZld16,
                                  wmma::mem_col_major);
        }
      }
    }
  }
  __syncthreads();
  // the weight tile holds 4 * 16 * kBLd bf16 = 33 KB >= c4 * 16 floats for c4 <= 512
  epilogue_and_torgb<__nv_bfloat16, kZld16, kTW16>(a, t, zs, reinterpret_cast<float*>(bs));
}

}  // namespace

extern "C" int gance_phase_conv1_torgb(const void* x, const void* wt, const void* demod,
                                       const void* nb, const void* wrgb, void* out, int batch,
                                       int c4, int h, int w, int nb_batched, int dtype,
                                       void* stream) {
  if (batch <= 0 || c4 <= 0 || c4 % 4 != 0 || c4 > kMaxC4 || h <= 0 || w <= 0 ||
      (dtype != gance::kFloat32 && dtype != gance::kBFloat16)) {
    return cudaErrorInvalidValue;
  }
  const bool f32 = dtype == gance::kFloat32;
  const int th = f32 ? kTH : kTH16, tw = f32 ? kTW : kTW16;
  const int tiles_x = (w + 1 + tw - 1) / tw;
  const long blocks = static_cast<long>(batch) * ((h + 1 + th - 1) / th) * tiles_x;
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  Args a{x, wt, static_cast<const float*>(demod), nb, wrgb, out, c4, h, w, batch, nb_batched,
         tiles_x};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (f32) {
    const size_t bytes =
        sizeof(float) * (static_cast<size_t>(c4) * kZld32 + kKC32 * 4 * kSlab + kKC32 * kHalo);
    err = cudaFuncSetAttribute(phase_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    phase_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(a);
  } else {
    const int c4_16 = (c4 + 15) / 16 * 16;
    const size_t bytes = sizeof(float) * static_cast<size_t>(c4_16) * kZld16 +
                         sizeof(__nv_bfloat16) * (kHaloLd16 + kK16 * kBLd);
    err = cudaFuncSetAttribute(phase_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    phase_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(a, c4_16);
  }
  return static_cast<int>(cudaGetLastError());
}
