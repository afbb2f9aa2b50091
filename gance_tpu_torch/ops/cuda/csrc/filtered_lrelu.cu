// Kernel F: StyleGAN3's filtered leaky ReLU, forward, fp32, NCHW:
//     t = x * scale[b, c] + bias[c]                 (scale optional: a conv's demodulation)
//     u = upfirdn2d(t, fu (x) fu, up, pads (pad, .), gain up^2)   separable, true convolution
//     v = clamp(max(u, u * slope) * gain, -clamp, clamp)
//     y = upfirdn2d(v, fd (x) fd, down)
// for StyleGAN3-T's layers: (up, down) = (2, 2) or (4, 2), 6 * up and 6 * down
// taps. The wrapper (ops/filtered_lrelu.py) hands the filters as correlation
// taps, reversed, the up filter times up (its per-axis gain), and the output
// side; the high pad follows from it.
//
// Replaces no TPU kernel: the JAX package runs no StyleGAN3 network. The
// design follows the public idea of NVlabs' torch_utils/ops/filtered_lrelu.cu
// (the upsampled grid lives in shared memory only), written anew for Hopper.
//
// Bound on the H100: operations and bytes about equally, counting each
// input byte read once, each output byte written once and the separable
// polyphase filtering's multiply-adds (port_bench/reference/bounds_sg3.py).
// Layers that upsample by 4 are bound by their operations: the 1024px
// network's L10 (81 channels, 534^2 in, 1044^2 out) is 11.7 GFLOP a frame
// against 0.45 GB, 0.175 ms at 67 TFLOP/s and 0.133 ms at 3.35 TB/s; those
// that upsample by 2 by their bytes, within 10% (L11: 0.120 and 0.133 ms).
// A frame's 14 launches: 0.67 ms of operations, 0.62 ms of bytes.
// Materialising the upsampled grid instead (2098^2 x 81 fp32 at L10, 1.4 GB
// a frame, written and read by each of four passes) would make it
// memory-bound many times over.
// Design: one block of 256 threads per 32 x 32 output tile of one (sample,
// channel) plane. It
//   1. reads the tile's input with its halo once (x * scale + bias, zero
//      outside the plane: upfirdn2d pads with zeros after the bias),
//   2. upsamples along x, polyphase: each group of `up` consecutive samples
//      of u reads the same 6 + 1 inputs, so a thread keeps 8 / up groups'
//      inputs in registers and makes 8 samples,
//   3. upsamples along y the same way and applies the leaky ReLU, gain and
//      clamp as it writes the tile's upsampled grid (about 80 x 80 floats),
//   4. downsamples along x (4 outputs a thread from 18 registers),
//   5. downsamples along y and writes the 32 x 32 outputs once, coalesced.
// Every stage reads and writes shared memory only (rows padded to odd
// pitches: no bank conflicts); the products are explicit fmaf (FFMA
// despite build.py's --fmad=false), each sum in tap order. The grid of u
// samples a tile computes is aligned to the polyphase groups, so every
// block has the same shape: the tiles' halos are recomputed (about 1.3x the
// ideal work at up 2, 1.2x at up 4). The taps sit in registers (loop
// indices are compile-time); the scale and the bias are read once a block.
// Offsets into a plane are 32-bit (a plane is at most 2^31 elements), the
// plane's base 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // outputs per block along each axis
constexpr int kRun = 4;    // outputs per thread item in the down passes

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return ceil_div(a, b) * b; }
__device__ __forceinline__ int floor_mod(int a, int b) { return ((a % b) + b) % b; }

template <int UP, int DOWN>
struct Shape {
  static constexpr int TU = 6 * UP;    // up taps
  static constexpr int TD = 6 * DOWN;  // down taps
  static constexpr int MU = TU / UP;   // up taps per phase
  static constexpr int G = 8 / UP;     // polyphase groups per thread item in the up passes
  // u samples the down passes read on each axis: (kTile - 1) * DOWN + TD
  static constexpr int VN = (kTile - 1) * DOWN + TD;
  // groups of UP u samples computed on each axis, from an aligned start that
  // lies up to UP - 1 samples before the first one read
  static constexpr int NG = round_up(ceil_div(UP - 1 + VN, UP), G);
  static constexpr int VS = UP * NG;  // u samples computed on each axis
  static constexpr int IS = NG + MU;  // input samples on each axis
  static constexpr int IP = IS | 1;   // odd pitches
  static constexpr int VP = VS | 1;
  static constexpr int DP = kTile | 1;
  static constexpr int RIN = (kRun - 1) * DOWN + TD;  // inputs of a down item
  // shared memory: t [IS][IP] and ux [IS][VP], then v [VS][VP]; dx [VN][DP]
  // lies over t and ux once v is made
  static constexpr int kFront = IS * IP + IS * VP;
  static constexpr int kFloats = (kFront > VN * DP ? kFront : VN * DP) + VS * VP;
  static_assert(TU % UP == 0 && NG % G == 0 && kTile % kRun == 0, "tile shape");
};

template <int UP, int DOWN>
__global__ void __launch_bounds__(kThreads)
filtered_lrelu_kernel(const float* __restrict__ x, const float* __restrict__ bias,
                      const float* __restrict__ scale, const float* __restrict__ fu,
                      const float* __restrict__ fd, float* __restrict__ out, int channels,
                      int in_h, int in_w, int out_h, int out_w, int pad, int tiles_x,
                      float gain, float slope, float clamp) {
  using S = Shape<UP, DOWN>;
  extern __shared__ float smem[];
  float* t = smem;
  float* ux = t + S::IS * S::IP;
  float* v = smem + (S::kFloats - S::VS * S::VP);
  float* dx = smem;

  const int c = blockIdx.y;
  const long plane = static_cast<long>(blockIdx.z) * channels + c;
  const int oy0 = (blockIdx.x / tiles_x) * kTile;
  const int ox0 = (blockIdx.x % tiles_x) * kTile;
  // the tile's first u sample on each axis: the last one at or before
  // DOWN * o0 that lies on an input sample (j - pad a multiple of UP)
  const int offy = floor_mod(DOWN * oy0 - pad, UP);
  const int offx = floor_mod(DOWN * ox0 - pad, UP);
  const int ay = (DOWN * oy0 - offy - pad) / UP;  // input row of t's row 0
  const int ax = (DOWN * ox0 - offx - pad) / UP;

  // 1. the input tile
  {
    const float* xp = x + plane * in_h * in_w;
    const float b = __ldg(bias + c);
    const float s = scale != nullptr ? __ldg(scale + plane) : 1.0f;
    for (int i = threadIdx.x; i < S::IS * S::IS; i += kThreads) {
      const int r = i / S::IS, q = i - r * S::IS;
      const int gy = ay + r, gx = ax + q;
      float val = 0.0f;
      if (gy >= 0 && gy < in_h && gx >= 0 && gx < in_w) {
        float xv = __ldg(xp + gy * in_w + gx);
        if (scale != nullptr) xv = __fmul_rn(xv, s);
        val = __fadd_rn(xv, b);
      }
      t[r * S::IP + q] = val;
    }
  }
  __syncthreads();

  // 2. up along x: ux[r][UP * g + rho] for every input row r
  {
    float k[S::TU];
#pragma unroll
    for (int i = 0; i < S::TU; ++i) k[i] = __ldg(fu + i);
    for (int i = threadIdx.x; i < S::IS * (S::NG / S::G); i += kThreads) {
      const int r = i % S::IS, q = i / S::IS;
      const float* src = t + r * S::IP + q * S::G;
      float in[S::G + S::MU];
#pragma unroll
      for (int j = 0; j < S::G + S::MU; ++j) in[j] = src[j];
      float* dst = ux + r * S::VP + q * S::G * UP;
#pragma unroll
      for (int g = 0; g < S::G; ++g) {
#pragma unroll
        for (int rho = 0; rho < UP; ++rho) {
          const int first = g + (rho > 0 ? 1 : 0), k0 = rho > 0 ? UP - rho : 0;
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < S::MU; ++m) acc = fmaf(in[first + m], k[k0 + UP * m], acc);
          dst[g * UP + rho] = acc;
        }
      }
    }
  }
  __syncthreads();

  // 3. up along y, then the leaky ReLU, gain and clamp: v[UP * g + rho][col]
  {
    float k[S::TU];
#pragma unroll
    for (int i = 0; i < S::TU; ++i) k[i] = __ldg(fu + i);
    for (int i = threadIdx.x; i < S::VS * (S::NG / S::G); i += kThreads) {
      const int col = i % S::VS, q = i / S::VS;
      const float* src = ux + q * S::G * S::VP + col;
      float in[S::G + S::MU];
#pragma unroll
      for (int j = 0; j < S::G + S::MU; ++j) in[j] = src[j * S::VP];
      float* dst = v + q * S::G * UP * S::VP + col;
#pragma unroll
      for (int g = 0; g < S::G; ++g) {
#pragma unroll
        for (int rho = 0; rho < UP; ++rho) {
          const int first = g + (rho > 0 ? 1 : 0), k0 = rho > 0 ? UP - rho : 0;
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < S::MU; ++m) acc = fmaf(in[first + m], k[k0 + UP * m], acc);
          float y = fmaxf(acc, __fmul_rn(acc, slope));
          y = __fmul_rn(y, gain);
          dst[(g * UP + rho) * S::VP] = fminf(fmaxf(y, -clamp), clamp);
        }
      }
    }
  }
  __syncthreads();

  // 4. down along x: dx[r][o] for the VN rows the outputs read
  {
    float k[S::TD];
#pragma unroll
    for (int i = 0; i < S::TD; ++i) k[i] = __ldg(fd + i);
    for (int i = threadIdx.x; i < S::VN * (kTile / kRun); i += kThreads) {
      const int r = i % S::VN, q = i / S::VN;
      const float* src = v + (offy + r) * S::VP + offx + q * kRun * DOWN;
      float in[S::RIN];
#pragma unroll
      for (int j = 0; j < S::RIN; ++j) in[j] = src[j];
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < S::TD; ++m) acc = fmaf(in[o * DOWN + m], k[m], acc);
        dx[r * S::DP + q * kRun + o] = acc;
      }
    }
  }
  __syncthreads();

  // 5. down along y, and the tile's outputs
  {
    float k[S::TD];
#pragma unroll
    for (int i = 0; i < S::TD; ++i) k[i] = __ldg(fd + i);
    float* op = out + plane * out_h * out_w;
    for (int i = threadIdx.x; i < kTile * (kTile / kRun); i += kThreads) {
      const int col = i % kTile, q = i / kTile;
      const float* src = dx + q * kRun * DOWN * S::DP + col;
      float in[S::RIN];
#pragma unroll
      for (int j = 0; j < S::RIN; ++j) in[j] = src[j * S::DP];
      const int ox = ox0 + col;
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < S::TD; ++m) acc = fmaf(in[o * DOWN + m], k[m], acc);
        const int oy = oy0 + q * kRun + o;
        if (oy < out_h && ox < out_w) op[oy * out_w + ox] = acc;
      }
    }
  }
}

template <int UP, int DOWN>
int launch(const float* x, const float* bias, const float* scale, const float* fu,
           const float* fd, float* out, int batch, int channels, int in_h, int in_w, int out_h,
           int out_w, int pad, float gain, float slope, float clamp, cudaStream_t stream) {
  using S = Shape<UP, DOWN>;
  constexpr int bytes = S::kFloats * static_cast<int>(sizeof(float));
  // above 48 KB only with the attribute set (on the current device)
  const cudaError_t err = cudaFuncSetAttribute(
      filtered_lrelu_kernel<UP, DOWN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = ceil_div(out_w, kTile), tiles_y = ceil_div(out_h, kTile);
  const dim3 grid(tiles_x * tiles_y, channels, batch);
  filtered_lrelu_kernel<UP, DOWN><<<grid, kThreads, bytes, stream>>>(
      x, bias, scale, fu, fd, out, channels, in_h, in_w, out_h, out_w, pad, tiles_x, gain,
      slope, clamp);
  return cudaGetLastError();
}

}  // namespace

// scale: (B, C) fp32, or null for none. fu: 6 * up taps, fd: 6 * down taps,
// both reversed (correlation), fu times up.
extern "C" int gance_filtered_lrelu(const void* x, const void* bias, const void* scale,
                                    const void* fu, const void* fd, void* out, int batch,
                                    int channels, int in_h, int in_w, int out_h, int out_w,
                                    int up, int down, int pad, float gain, float slope,
                                    float clamp, void* stream) {
  if (batch <= 0 || channels <= 0 || in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 ||
      batch > 65535 || channels > 65535 || static_cast<long>(in_h) * in_w > (1L << 31) - 1 ||
      static_cast<long>(out_h) * out_w > (1L << 31) - 1) {
    return cudaErrorInvalidValue;
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(bias);
  const auto* sf = static_cast<const float*>(scale);
  const auto* uf = static_cast<const float*>(fu);
  const auto* df = static_cast<const float*>(fd);
  auto* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (up == 2 && down == 2) {
    return launch<2, 2>(xf, bf, sf, uf, df, of, batch, channels, in_h, in_w, out_h, out_w, pad,
                        gain, slope, clamp, s);
  }
  if (up == 4 && down == 2) {
    return launch<4, 2>(xf, bf, sf, uf, df, of, batch, channels, in_h, in_w, out_h, out_w, pad,
                        gain, slope, clamp, s);
  }
  return cudaErrorInvalidValue;
}
