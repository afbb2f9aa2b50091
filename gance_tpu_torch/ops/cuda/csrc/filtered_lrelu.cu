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
// design keeps the upsampled grid out of device memory, as NVlabs'
// torch_utils/ops/filtered_lrelu.cu does, and is written anew for Hopper.
//
// Bound on the H100: operations and bytes about equally, counting each
// input byte read once, each output byte written once and the separable
// polyphase filtering's multiply-adds (port_bench/reference/bounds_sg3.py).
// Layers that upsample by 4 are bound by their operations: the 1024px
// network's L10 (81 channels, 534^2 in, 1044^2 out) is 11.7 GFLOP a frame
// against 0.45 GB, 0.175 ms at 67 TFLOP/s and 0.133 ms at 3.35 TB/s; those
// that upsample by 2 by their bytes, within 10% (L11: 0.120 and 0.133 ms).
// A frame's 14 launches: 0.67 ms of operations, 0.62 ms of bytes. So F has
// to issue fp32 FMAs nearly back to back, and every other instruction (a
// shared-memory access, the activation, an address) and every stall costs.
//
// Design: a streaming schedule. A block is one warp. LS of its lanes (32, or
// 16 with two planes a warp) own a strip of up to 120 (56) output columns
// of one (sample, channel) plane and walk down it from the top of their
// segment of rows to the bottom, one input row a step:
//   1. the input row (x * scale + bias, zero outside the plane: upfirdn2d
//      pads with zeros after the bias) goes to shared memory; each lane
//      loaded its part two steps earlier into registers, so the load's
//      latency hides behind two steps of arithmetic;
//   2. up along x, polyphase: lane i makes 8 u columns (8 / up groups of up
//      that read the same 6 inputs) from 8 / up + 5 inputs;
//   3. up along y from a sliding window of the last 6 x-upsampled rows of
//      its 8 columns, kept in registers: each value is made once and read
//      from registers only; the leaky ReLU, gain and clamp follow, and the
//      step's `up` rows of v go to shared memory;
//   4. down along x: lane i makes 4 outputs' columns from 18 v values of
//      each of those rows, read as 16-byte chunks of a row whose chunks are
//      XOR-swizzled, so that neither these reads nor step 3's writes
//      conflict on a bank;
//   5. down along y by accumulation: each x-downsampled value is added, in
//      tap order, to the 6 outputs in flight that read it, kept in
//      registers; every second v row completes one, written at once with
//      one 16-byte store a lane.
// So the y halo is never recomputed and nothing is held back for the next
// step but registers; only the x halo is: 8 LS u columns for a strip's
// 2 * width + 10 (4% at 32 lanes). The strip's u columns start on a
// polyphase group (phase 1 of up), so the up passes' tap pattern is the same
// for every lane, step and layer; the offset E of the strip's first output
// inside the grid, (-pad - 1) mod up, is a template parameter of the down
// passes, as are the layer's (up, down) and LS. The window and the outputs
// in flight rotate with a period of 6 input rows: the loop body is those 6
// steps, unrolled, so every register is named statically. Between the
// passes the warp syncs (__syncwarp): no block-wide barrier, and no lane
// waits on another warp. The taps sit in uniform registers, read by the
// FFMAs directly; 128 registers a thread keep 16 warps an SM resident.
// The arithmetic of every output follows NVlabs' order: the same taps, each
// sum a chain of explicit fmaf (FFMA despite build.py's --fmad=false) in tap
// order from 0, the activation rounded after each operation; so F equals its
// twin bit for bit, whatever strip, segment or lane makes an output.
// The host picks LS (16 where fewer lanes idle over the plane's width: the
// 36-276px layers), the strip width (a multiple of 4, the widest the lanes
// feed, evened out over the plane's strips) and the segment's rows (even)
// from a wave model over the warps resident on the card: more segments
// where few planes leave SMs idle, fewer where each segment's start (5 rows
// of x-up and the y halo) would cost more.
// Offsets into a plane are 32-bit (a plane is at most 2^31 elements), the
// plane's base 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;                       // a block is one warp
constexpr int kUCols = 8;                        // u columns a lane makes in the up passes
constexpr int kDCols = 4;                        // outputs a lane makes in the down passes
constexpr int kWindow = 6;                       // input rows a v row reads: the body's steps
constexpr int kVPitch = kLanes * kUCols + 32;    // a v row's floats (the tail feeds idle lanes)
constexpr int kAhead = 2;                        // steps between an input row's load and its use
constexpr int kWarpsPerSM = 16;                  // resident: at most 128 registers a thread

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int floor_mod(int a, int b) { return ((a % b) + b) % b; }

template <int UP, int DOWN, int LS>
struct Shape {
  static constexpr int TU = 6 * UP;    // up taps
  static constexpr int TD = 6 * DOWN;  // down taps
  static constexpr int MU = TU / UP;   // up taps a phase
  static constexpr int G = kUCols / UP;          // polyphase groups a lane makes
  static constexpr int VEC = UP == 2 ? 4 : 2;    // floats a lane's input load moves
  static constexpr int READ = ceil_div(G + MU - 1, VEC) * VEC;  // input floats a lane reads
  static constexpr int PLANES = kLanes / LS;       // planes a warp walks side by side
  static constexpr int NT = G * (LS - 1) + READ;  // input floats the strip's lanes read
  static constexpr int NE = ceil_div(NT, LS);      // of them a lane loads
  static constexpr int FLIGHT = TD / DOWN;         // outputs in flight in a column
  static_assert(MU == kWindow && DOWN == 2 && kWindow % kAhead == 0, "schedule shape");
  static_assert((kWindow * UP) % (DOWN * FLIGHT) == 0, "the body holds whole periods");
  static_assert(kDCols * DOWN <= kUCols && kLanes % LS == 0, "a strip's outputs fit its lanes");
};

// where a v row keeps its 16-byte chunk `chunk`: bit 0 flipped where bit 3
// is set, so that lane i's chunks 2i + j fall on 8 distinct bank groups in
// every quarter warp
__device__ __forceinline__ int swizzled_chunk(int chunk) { return chunk ^ ((chunk >> 3) & 1); }

template <int UP, int DOWN, int E, int LS>
__global__ void __launch_bounds__(kLanes, kWarpsPerSM)
filtered_lrelu_kernel(const float* __restrict__ x, const float* __restrict__ bias,
                      const float* __restrict__ scale, const float* __restrict__ fu,
                      const float* __restrict__ fd, float* __restrict__ out, int channels,
                      int in_h, int in_w, int out_h, int out_w, int pad, int strips, int width,
                      int rows, float gain, float slope, float clamp) {
  using S = Shape<UP, DOWN, LS>;
  __shared__ __align__(16) float t_rows[S::PLANES][S::NE * LS];
  __shared__ __align__(16) float v_rows[UP][kVPitch];

  // lane = LS * half + sub: sub is the lane's place in its strip, half its
  // plane among the warp's; v rows are laid out by lane, so the planes' u
  // columns lie side by side in them
  const int lane = threadIdx.x, sub = lane % LS, half = lane / LS;
  const int c = blockIdx.y * S::PLANES + half;
  const bool plane_in = c < channels;
  const long plane = static_cast<long>(blockIdx.z) * channels + (plane_in ? c : 0);
  float* const t_row = t_rows[half];
  const int ox0 = (blockIdx.x % strips) * width;
  const int oy0 = (blockIdx.x / strips) * rows;
  const int nr = min(rows, out_h - oy0);
  // input column and row of t_row[0] and of the first step's window: the
  // strip's u columns start at DOWN * ox0 - E, on phase 1 (exact divisions)
  const int tx0 = (DOWN * ox0 - E - pad - 1) / UP + 1;
  const int ty0 = (DOWN * oy0 - E - pad - 1) / UP + 1;

  float ku[S::TU], kd[S::TD];
#pragma unroll
  for (int i = 0; i < S::TU; ++i) ku[i] = __ldg(fu + i);
#pragma unroll
  for (int i = 0; i < S::TD; ++i) kd[i] = __ldg(fd + i);
  const float b = __ldg(bias + (plane_in ? c : 0));
  const float s = scale != nullptr ? __ldg(scale + plane) : 1.0f;  // x * 1 is x
  const float* xp = x + plane * in_h * in_w;
  float* op = out + plane * out_h * out_w;

  // The input row: lane sub holds t_row[sub + LS e]. Floats outside the
  // plane's columns (or of no plane) are zero from the start and never
  // stored again; a row outside the plane is stored as zeros.
  unsigned col_ok = 0;
#pragma unroll
  for (int e = 0; e < S::NE; ++e) {
    const int q = sub + LS * e, gx = tx0 + q;
    if (q < S::NT && plane_in && gx >= 0 && gx < in_w) {
      col_ok |= 1u << e;
    } else {
      t_row[q] = 0.0f;
    }
  }
  auto load_row = [&](int r, float (&raw)[S::NE]) {
    if (r >= 0 && r < in_h) {
      const float* src = xp + static_cast<long>(r) * in_w + (tx0 + sub);
#pragma unroll
      for (int e = 0; e < S::NE; ++e) {
        if ((col_ok >> e) & 1) raw[e] = __ldg(src + LS * e);
      }
    }
  };
  auto store_row = [&](int r, const float (&raw)[S::NE]) {
    const bool row_ok = r >= 0 && r < in_h;
#pragma unroll
    for (int e = 0; e < S::NE; ++e) {
      if ((col_ok >> e) & 1) {
        t_row[sub + LS * e] = row_ok ? __fadd_rn(__fmul_rn(raw[e], s), b) : 0.0f;
      }
    }
  };
  // 2. up along x: the lane's 8 u columns of the row in t_row
  auto x_up = [&](float (&ux)[kUCols]) {
    float in[S::READ];
    const float* src = t_row + S::G * sub;
#pragma unroll
    for (int i = 0; i < S::READ; i += S::VEC) {
      if constexpr (S::VEC == 4) {
        const float4 q = *reinterpret_cast<const float4*>(src + i);
        in[i] = q.x, in[i + 1] = q.y, in[i + 2] = q.z, in[i + 3] = q.w;
      } else {
        const float2 q = *reinterpret_cast<const float2*>(src + i);
        in[i] = q.x, in[i + 1] = q.y;
      }
    }
#pragma unroll
    for (int g = 0; g < S::G; ++g) {
#pragma unroll
      for (int j = 0; j < UP; ++j) {
        const int k0 = j < UP - 1 ? UP - 1 - j : 0;  // phase j + 1 of up
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < S::MU; ++m) acc = fmaf(in[g + m], ku[k0 + UP * m], acc);
        ux[UP * g + j] = acc;
      }
    }
  };

  float w[kWindow][kUCols];          // x-upsampled rows, slot = row mod 6
  float flight[S::FLIGHT][kDCols];   // outputs in flight, slot = output row mod 6
#pragma unroll
  for (int i = 0; i < S::FLIGHT; ++i) {
#pragma unroll
    for (int j = 0; j < kDCols; ++j) flight[i][j] = 0.0f;
  }
  float raw[kAhead][S::NE] = {};
  // the window's first 5 rows
#pragma unroll
  for (int k = 0; k < kWindow - 1; ++k) {
    load_row(ty0 + k, raw[0]);
    store_row(ty0 + k, raw[0]);
    __syncwarp();
    x_up(w[k]);
    __syncwarp();
  }
#pragma unroll
  for (int a = 0; a < kAhead; ++a) load_row(ty0 + kWindow - 1 + a, raw[a]);

  const bool vec_out = out_w % 4 == 0;  // then a lane's 4 outputs are one aligned float4
  const int col0 = kDCols * sub;        // the lane's first output in the strip
  const bool col_in = plane_in && col0 < width && ox0 + col0 < out_w;
  float* const out_lane = op + (static_cast<long>(oy0) * out_w + ox0 + col0);
  const float lo_clamp = -clamp;
  const int bodies = ceil_div(ceil_div(E + DOWN * (nr - 1) + S::TD, UP), kWindow);
#pragma unroll 1
  for (int body = 0; body < bodies; ++body) {
#pragma unroll
    for (int st = 0; st < kWindow; ++st) {
      const int step = body * kWindow + st;
      const int r = ty0 + kWindow - 1 + step;  // the input row this step reads
      // 1. the input row, staged kAhead steps ago; the next load in its place
      store_row(r, raw[st % kAhead]);
      load_row(r + kAhead, raw[st % kAhead]);
      __syncwarp();
      x_up(w[(kWindow - 1 + st) % kWindow]);
      // 3. up along y over the window's rows r - 5 .. r, the activation, v rows
#pragma unroll
      for (int j = 0; j < UP; ++j) {
        const int k0 = j < UP - 1 ? UP - 1 - j : 0;
        float vv[kUCols];
#pragma unroll
        for (int col = 0; col < kUCols; ++col) {
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < S::MU; ++m) {
            acc = fmaf(w[(st + m) % kWindow][col], ku[k0 + UP * m], acc);
          }
          float y = fmaxf(acc, __fmul_rn(acc, slope));
          y = __fmul_rn(y, gain);
          vv[col] = fminf(fmaxf(y, lo_clamp), clamp);
        }
#pragma unroll
        for (int h = 0; h < kUCols / 4; ++h) {
          *reinterpret_cast<float4*>(&v_rows[j][4 * swizzled_chunk(2 * lane + h)]) =
              make_float4(vv[4 * h], vv[4 * h + 1], vv[4 * h + 2], vv[4 * h + 3]);
        }
      }
      __syncwarp();
      // 4-5. down along x, then into the outputs in flight; v row L of the
      // segment feeds output rows lo with L = E + DOWN * lo + m, m < TD
#pragma unroll
      for (int j = 0; j < UP; ++j) {
        constexpr int kChunks = ceil_div(E + DOWN * (kDCols - 1) + S::TD, 4);
        float in[4 * kChunks];
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          const float4 q =
              *reinterpret_cast<const float4*>(&v_rows[j][4 * swizzled_chunk(2 * lane + ch)]);
          in[4 * ch] = q.x, in[4 * ch + 1] = q.y, in[4 * ch + 2] = q.z, in[4 * ch + 3] = q.w;
        }
        float dx[kDCols];
#pragma unroll
        for (int o = 0; o < kDCols; ++o) {
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < S::TD; ++m) acc = fmaf(in[E + DOWN * o + m], kd[m], acc);
          dx[o] = acc;
        }
        // (L - E) mod (DOWN * FLIGHT), static: a body is whole periods
        const int lm = floor_mod(UP * st + j - E, DOWN * S::FLIGHT);
#pragma unroll
        for (int i = 0; i < S::FLIGHT; ++i) {
          const int m = lm % DOWN + DOWN * i;  // the tap this row is to an output in flight
          const int slot = floor_mod((lm - m) / DOWN, S::FLIGHT);
#pragma unroll
          for (int o = 0; o < kDCols; ++o) {
            flight[slot][o] = fmaf(dx[o], kd[m], m == 0 ? 0.0f : flight[slot][o]);
          }
          if (m == S::TD - 1) {
            const int lo = (UP * step + j - E - m) / DOWN;  // exact: L - E - m is even
            if (lo >= 0 && lo < nr && col_in) {
              float* dst = out_lane + static_cast<long>(lo) * out_w;
              if (vec_out) {
                *reinterpret_cast<float4*>(dst) =
                    make_float4(flight[slot][0], flight[slot][1], flight[slot][2],
                                flight[slot][3]);
              } else {
#pragma unroll
                for (int o = 0; o < kDCols; ++o) {
                  if (col0 + o < width && ox0 + col0 + o < out_w) dst[o] = flight[slot][o];
                }
              }
            }
          }
        }
      }
    }
  }
}

// the widest strip whose u columns LS lanes make: a multiple of 4 outputs
constexpr int strip_width_max(int lanes, int down_taps, int e) {
  return ((lanes * kUCols - down_taps - e) / 2 + 1) / 4 * 4;
}

// the segment's output rows: the fewest waves of resident warps times the
// work of a segment (its bodies, plus about a fifth of one for its start)
int segment_rows(int out_h, long long warps_per_segment_row, long long slots, int up, int down,
                 int down_taps, int e) {
  long long best_cost = -1;
  int best_rows = out_h;
  const int most = out_h / 2 < 64 ? (out_h / 2 > 1 ? out_h / 2 : 1) : 64;
  for (int segs = 1; segs <= most; ++segs) {
    const int rows = ceil_div(ceil_div(out_h, segs), 2) * 2;
    const long long warps = warps_per_segment_row * ceil_div(out_h, rows);
    const long long waves = (warps + slots - 1) / slots;
    const int bodies = ceil_div(ceil_div(e + down * (rows - 1) + down_taps, up), kWindow);
    const long long cost = waves * (5LL * bodies + 1);
    if (best_cost < 0 || cost < best_cost) best_cost = cost, best_rows = rows;
  }
  return best_rows;
}

template <int UP, int DOWN, int E, int LS>
int launch_lanes(const float* x, const float* bias, const float* scale, const float* fu,
                 const float* fd, float* out, int batch, int channels, int in_h, int in_w,
                 int out_h, int out_w, int pad, float gain, float slope, float clamp,
                 cudaStream_t stream) {
  using S = Shape<UP, DOWN, LS>;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(sms) * kWarpsPerSM;  // resident warps
  const int strips = ceil_div(out_w, strip_width_max(LS, S::TD, E));
  const int width = ceil_div(ceil_div(out_w, strips), 4) * 4;
  const int groups = ceil_div(channels, S::PLANES);  // of planes a warp walks
  const int rows = segment_rows(out_h, static_cast<long long>(batch) * groups * strips, slots, UP,
                                DOWN, S::TD, E);
  const dim3 grid(strips * ceil_div(out_h, rows), groups, batch);
  filtered_lrelu_kernel<UP, DOWN, E, LS><<<grid, kLanes, 0, stream>>>(
      x, bias, scale, fu, fd, out, channels, in_h, in_w, out_h, out_w, pad, strips, width, rows,
      gain, slope, clamp);
  return cudaGetLastError();
}

// lanes a strip: 16 (two planes a warp) where that leaves fewer lanes idle
// than 32 over the plane's width
template <int UP, int DOWN, int E>
int launch(const float* x, const float* bias, const float* scale, const float* fu,
           const float* fd, float* out, int batch, int channels, int in_h, int in_w, int out_h,
           int out_w, int pad, float gain, float slope, float clamp, cudaStream_t stream) {
  const int td = Shape<UP, DOWN, kLanes>::TD;
  const int lanes_32 = ceil_div(out_w, strip_width_max(kLanes, td, E)) * kLanes;
  const int lanes_16 = ceil_div(out_w, strip_width_max(kLanes / 2, td, E)) * (kLanes / 2);
  auto run = lanes_16 < lanes_32 ? launch_lanes<UP, DOWN, E, kLanes / 2>
                                  : launch_lanes<UP, DOWN, E, kLanes>;
  return run(x, bias, scale, fu, fd, out, batch, channels, in_h, in_w, out_h, out_w, pad, gain,
             slope, clamp, stream);
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
#define GANCE_F_LAUNCH(U, D, E)                                                                  \
  launch<U, D, E>(xf, bf, sf, uf, df, of, batch, channels, in_h, in_w, out_h, out_w, pad, gain, \
                  slope, clamp, s)
  if (down == 2 && (up == 2 || up == 4)) {
    // the strip's first output lies E u columns past a group's phase 1
    switch (floor_mod(-pad - 1, up)) {
      case 0: return up == 2 ? GANCE_F_LAUNCH(2, 2, 0) : GANCE_F_LAUNCH(4, 2, 0);
      case 1: return up == 2 ? GANCE_F_LAUNCH(2, 2, 1) : GANCE_F_LAUNCH(4, 2, 1);
      case 2: return GANCE_F_LAUNCH(4, 2, 2);
      case 3: return GANCE_F_LAUNCH(4, 2, 3);
    }
  }
#undef GANCE_F_LAUNCH
  return cudaErrorInvalidValue;
}
