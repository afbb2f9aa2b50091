// Kernel A: the synthesis layer epilogue
//     out = lrelu(x + noise * strength + bias[c], 0.2) * sqrt(2)
// over NCHW x (fp32 or bf16), noise (1 or B, 1, H, W) fp32, bias (C,) fp32 and
// strength, a 0-d fp32 tensor read through a device pointer (so the host never
// syncs to read it). The sum is (x + noise * strength) + bias in fp32, as the
// twin (fused_ops.py::fused_bias_noise_lrelu_plain) takes it, then one rounding
// to x's dtype.
//
// Replaces gance_tpu/ops/pallas/fused_ops.py::fused_bias_noise_lrelu.
// Bound on the H100: memory. It reads x and noise once and writes out once,
// (2|x| + |noise|) bytes at 3.35 TB/s; the 5 flops per element are far below
// the fp32 rate.
// Design: a streaming epilogue. A block takes a run of pixels of one sample
// across a group of channels: blockIdx.x a tile of pixels, blockIdx.y a group
// of channels, blockIdx.z the sample. Each thread owns one 16-byte unit of
// pixels (4 fp32 or 8 bf16) and a few channels of the group: it reads the
// noise of its unit once (the noise plane broadcasts over C), scales it by
// strength, keeps it in registers and applies it in each of its channels, so
// noise is read once per group and not once per plane. x is loaded as 16-byte
// vectors, kInFlight channels before the first use, and out stored as 16-byte
// vectors, both with the streaming hint so that noise stays in L2. A plane
// with fewer units than a block's threads shares the block with other
// channels (threadIdx.y), so the 4x4 to 64x64 layers launch one wave or less.
// The vector path needs 16-byte aligned x, noise and out and H*W a multiple of
// the unit; anything else (a view with a storage offset, odd H*W) takes the
// scalar path of the same kernel: units of one element, the same map.
// Offsets are 64-bit.

#include <algorithm>

#include "common.cuh"

// Measurement variants (tools/time_torch_ab_kernels.py --ablate); 0 is the kernel.
// 1: no noise read; 2: no arithmetic (out = x); 3: the scalar path everywhere.
#ifndef GANCE_A_ABLATE
#define GANCE_A_ABLATE 0
#endif
#ifndef GANCE_A_CHANNELS_PER_THREAD
#define GANCE_A_CHANNELS_PER_THREAD 16
#endif
#ifndef GANCE_A_IN_FLIGHT
#define GANCE_A_IN_FLIGHT 4
#endif

namespace {

constexpr float kSqrt2 = 1.41421356237309504880f;
constexpr int kThreads = 256;
constexpr int kMaxChannelsPerThread = GANCE_A_CHANNELS_PER_THREAD;
constexpr int kInFlight = GANCE_A_IN_FLIGHT;  // x loads issued before the first use
constexpr long kMinBlocks = 2 * 132;          // two blocks per SM before channels per thread grow

// V elements of T per unit: Raw holds them as loaded.
template <typename T, int V>
struct Unit {
  using Raw = gance::Vec16<T>;
  static __device__ __forceinline__ Raw load(const T* p) {
    return gance::load_stream(reinterpret_cast<const Raw*>(p));
  }
  static __device__ __forceinline__ void store(T* p, const float (&f)[V]) {
    gance::store_stream(reinterpret_cast<Raw*>(p), gance::pack(f));
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&f)[V]) { gance::unpack(r, f); }
  static __device__ __forceinline__ void noise(const float* p, float (&n)[V]) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      n[i] = q.x;
      n[i + 1] = q.y;
      n[i + 2] = q.z;
      n[i + 3] = q.w;
    }
  }
};

template <typename T>
struct Unit<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void store(T* p, const float (&f)[1]) {
    *p = gance::from_float<T>(f[0]);
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&f)[1]) { f[0] = gance::to_float(r); }
  static __device__ __forceinline__ void noise(const float* p, float (&n)[1]) { n[0] = __ldg(p); }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 4)  // at most 64 registers a thread
bias_noise_lrelu_kernel(const T* __restrict__ x, const float* __restrict__ noise,
                        const float* __restrict__ bias, const float* __restrict__ strength,
                        T* __restrict__ out, int channels, long hw, int noise_per_sample,
                        int channels_per_thread) {
  using U = Unit<T, V>;
  const long unit = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (unit * V >= hw) return;
  const long b = blockIdx.z;
  const int lanes = blockDim.y;  // channels side by side in a block
  const int c_first = blockIdx.y * lanes * channels_per_thread + threadIdx.y;
  const long pixel = unit * V;

  float ns[V];  // noise * strength of this unit, for every channel of the group
#if GANCE_A_ABLATE == 1
#pragma unroll
  for (int i = 0; i < V; ++i) ns[i] = 0.f;
#else
  U::noise(noise + (noise_per_sample ? b * hw : 0) + pixel, ns);
  const float s = __ldg(strength);
#pragma unroll
  for (int i = 0; i < V; ++i) ns[i] = ns[i] * s;
#endif

  for (int k0 = 0; k0 < channels_per_thread; k0 += kInFlight) {
    typename U::Raw raw[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int c = c_first + (k0 + j) * lanes;
      if (k0 + j < channels_per_thread && c < channels) {
        raw[j] = U::load(x + (b * channels + c) * hw + pixel);
      }
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int c = c_first + (k0 + j) * lanes;
      if (k0 + j < channels_per_thread && c < channels) {
        float f[V];
        U::unpack(raw[j], f);
#if GANCE_A_ABLATE != 2
        const float bc = __ldg(bias + c);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float v = (f[i] + ns[i]) + bc;
          f[i] = (v >= 0.f ? v : v * 0.2f) * kSqrt2;
        }
#endif
        U::store(out + (b * channels + c) * hw + pixel, f);
      }
    }
  }
}

long ceil_div(long a, long b) { return (a + b - 1) / b; }

long pow2_ceil(long n) {
  long p = 1;
  while (p < n) p *= 2;
  return p;
}

// The launch geometry, mirrored in numpy by tests/test_torch_kernels.py::a_plan.
struct Plan {
  int unit_threads;   // blockDim.x: units of one plane side by side
  int lanes;          // blockDim.y: channels side by side
  int channels_per_thread;
  long tiles, groups; // gridDim.x, gridDim.y
};

Plan plan(long batch, int channels, long units) {
  Plan p;
  p.unit_threads = static_cast<int>(units >= kThreads ? kThreads : pow2_ceil(units));
  p.lanes = static_cast<int>(std::min<long>(kThreads / p.unit_threads, pow2_ceil(channels)));
  p.tiles = ceil_div(units, p.unit_threads);
  p.channels_per_thread =
      static_cast<int>(std::min<long>(kMaxChannelsPerThread, ceil_div(channels, p.lanes)));
  while (p.channels_per_thread > 1 &&
         p.tiles * ceil_div(channels, static_cast<long>(p.lanes) * p.channels_per_thread) *
                 batch < kMinBlocks) {
    p.channels_per_thread /= 2;
  }
  p.groups = ceil_div(channels, static_cast<long>(p.lanes) * p.channels_per_thread);
  return p;
}

template <typename T, int V>
int launch(const void* x, const void* noise, const void* bias, const void* strength, void* out,
           long batch, int channels, long hw, int noise_per_sample, cudaStream_t stream) {
  const Plan p = plan(batch, channels, hw / V);
  if (p.tiles > 2147483647L || p.groups > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(p.tiles), static_cast<unsigned>(p.groups),
                  static_cast<unsigned>(batch));
  const dim3 block(p.unit_threads, p.lanes);
  bias_noise_lrelu_kernel<T, V><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(noise),
      static_cast<const float*>(bias), static_cast<const float*>(strength),
      static_cast<T*>(out), channels, hw, noise_per_sample, p.channels_per_thread);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* noise, const void* bias, const void* strength, void* out,
             long batch, int channels, long hw, int noise_per_sample, cudaStream_t stream) {
  constexpr int V = gance::kVec<T>;
  const bool vector = GANCE_A_ABLATE != 3 && hw % V == 0 && gance::aligned(x, 16) &&
                      gance::aligned(out, 16) && gance::aligned(noise, 16);
  if (vector) {
    return launch<T, V>(x, noise, bias, strength, out, batch, channels, hw, noise_per_sample,
                        stream);
  }
  return launch<T, 1>(x, noise, bias, strength, out, batch, channels, hw, noise_per_sample,
                      stream);
}

}  // namespace

extern "C" int gance_fused_bias_noise_lrelu(const void* x, const void* noise,
                                            const void* bias, const void* strength,
                                            void* out, long planes, int channels, long hw,
                                            int noise_per_sample, int dtype, void* stream) {
  if (planes <= 0 || channels <= 0 || hw <= 0 || planes % channels != 0 ||
      planes / channels > 65535) {
    return cudaErrorInvalidValue;
  }
  const long batch = planes / channels;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gance::kFloat32) {
    return dispatch<float>(x, noise, bias, strength, out, batch, channels, hw, noise_per_sample, s);
  }
  if (dtype == gance::kBFloat16) {
    return dispatch<__nv_bfloat16>(x, noise, bias, strength, out, batch, channels, hw,
                                   noise_per_sample, s);
  }
  return cudaErrorInvalidValue;
}
