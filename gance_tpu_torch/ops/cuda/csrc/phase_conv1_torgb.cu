// Kernel E: the top synthesis block's Conv1 + demod/noise/bias/lrelu + ToRGB
// in phase space, in one pass (ops/phase_block.py):
//     rgb[b] = lrelu(conv2d(x[b], w4, pad 1) * demod[b] + noise_bias, 0.2) @ wrgb[b]
// with x (B, 4C, H, W) phase planes (channel ph * C + c, ph = dh * 2 + dw),
// w4 (4C, 4C, 2, 2) = fold_conv1_weights(v) of a 3x3 Conv1 weight v
// (C, C, 3, 3), demod (B, 4C) fp32, noise_bias (1 or B, 4C, H+1, W+1), wrgb
// (B, 4C, 16) with sqrt(2) * s_rgb folded in; output (B, 16, H+1, W+1). In
// bf16 the activation z is rounded to bf16 before the ToRGB product, as the
// TPU kernel does; every sum is taken in fp32.
//
// Replaces gance_tpu/ops/pallas/phase_fused.py::phase_conv1_torgb_fused.
//
// Contract: w4 is a Conv1 fold. Each of its 64 (out-phase, in-phase) blocks
// of C x C x 2 x 2 is one tap v[:, :, dh, dw] or zero (28 of them), and the
// four output phases share the same nine taps: it is the 3x3 SAME conv on
// the fine 2H x 2W grid the phases were split from. So the wrapper hands the
// kernel the nine taps, wv (cin_pad, 9, cout_pad) = v[o][c][dh][dw] at
// [c][dh * 3 + dw][o], zero-padded to whole chunks and slabs, and the kernel
// computes that fine-grid conv: the zero blocks are never read or
// multiplied, and K per output is 9C, not 16C.
//
// Index map. Fine pixel 2p + d of the input is x[d-phase][p] (per axis);
// output phase sigma at position m is fine pixel 2m - sigma. A block takes
// an 8 x 8 tile of output positions (m0.., n0..) of one image in all four
// phases, i.e. the 16 x 16 fine pixels a = 2 (m - m0) + 1 - sigma_h (and b
// likewise) from fine row 2 m0 - 1 on. They read the 18 x 18 fine halo
// halo[i][j] = x[(i & 1) * 2 + (j & 1)][m0 - 1 + i / 2][n0 - 1 + j / 2] (zero
// outside), and fine pixel (a, b) is sum_{dh, dw, c} halo[c][a + dh][b + dw] *
// v[o][c][dh][dw]: a plain 3x3 stencil over the halo. The halo holds the
// (T+1)^2 x 4C input positions that the folded 2x2 conv reads.
//
// Bound on the H100: operations. At 1024px (C = 64, H = W = 512, batch 8)
// the nine taps need 2 * 8 * 4 * 513^2 * 64 * 576 = 6.2e11 flops, plus the
// ToRGB product (9.5 ms at 67 TFLOP/s fp32 outside the tensor cores, 0.64 ms
// at 989 TFLOP/s bf16); the bytes (x, noise_bias, the output) take 0.4-0.8 ms
// at 3.35 TB/s.
//
// Design: one block per (image, 8 x 8 output tile), all four phases and all
// C output channels in slabs of 64, so the ToRGB sum over 4C runs inside
// the block and the activated (B, 4C, H+1, W+1) tensor never reaches device
// memory. The K loop walks the input channels in chunks (8 fp32, 16 bf16);
// each chunk's nine weight slabs (chunk x 64 outputs) reach shared memory
// through a 3-stage cp.async pipeline: chunk k + 2's copies are in flight
// while chunk k is multiplied, one __syncthreads per chunk. The fp32 halo
// rides in the same stages.
//   * fp32: SIMT FMA, no TF32 (the port's exact tier). 256 threads, each 8
//     fine pixels of one fine row x 8 channels (64 accumulators). The halo
//     is staged channel-major [c][18][18] straight from NCHW x by 4-byte
//     cp.async, so the wrapper makes no transposed copy of x; a thread's
//     10 halo values of a row serve the three column taps.
//   * bf16: tensor cores, mma.sync m16n8k16 with fp32 accumulators. The
//     halo is staged pixel-major, the chunk's 16 channels contiguous, so a
//     tap's A operand for one fine row is a 16 x 16 window of it (a column
//     tap shifts it by one whole pixel) and loads by ldmatrix; the weights
//     load by ldmatrix.trans. 8 warps, each 4 fine rows x 32 channels (4 x 4
//     tiles of 16 x 8). The halo is transposed from NCHW x on the way in:
//     16-byte loads of 8 columns into registers, one chunk ahead, stored
//     as 2-byte words after the chunk's products, into two halo buffers.
//     A channels-last copy of x by PyTorch would cost more than the whole
//     kernel at 1024px (tools/time_torch_phase_kernel.py times both).
// Both then write the slab's fp32 sums to shared memory (phase-major
// positions). In the epilogue each thread owns one (phase, position) and
// applies demod, noise_bias and lrelu to its 64 channels (rounding z to the
// working type). fp32 sums their ToRGB products into 16 partial columns in
// registers, and the four phases' partials meet in shared memory; bf16
// writes z to a bf16 tile and runs the ToRGB product, 64 positions x 256
// rows x 16 columns, on the tensor cores (exact products, fp32 sums). The
// RGB sums stay in registers across slabs. The grid puts neighbouring
// blocks on the same tile of successive images: a batch-invariant
// noise_bias tile is read from device memory once and from L2 after. wgmma
// and TMA are left for later.

#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRgb = 16;         // RGB phase columns (4 phases x up to 4 channels)
constexpr int kMaxC4 = 512;
constexpr int kT = 8;            // output positions per tile side, per phase
constexpr int kP = kT * kT;      // output positions per tile
constexpr int kF = 2 * kT;       // fine pixels per tile side
constexpr int kHF = kF + 2;      // fine halo side
constexpr int kSlab = 64;        // output channels per pass of the main loop
constexpr int kStages = 3;       // cp.async pipeline depth
constexpr int kZld = 4 * kP + 4; // z tile stride (floats) of one channel's 256 fine pixels

// fp32: shared memory per stage, in floats
constexpr int kKc32 = 8;                       // input channels per chunk
constexpr int kHalo32 = kKc32 * kHF * kHF;     // [c][18][18]
constexpr int kW32 = kKc32 * 9 * kSlab;        // [c][tap][64]
constexpr int kStage32 = kHalo32 + kW32;

// bf16: a weight stage and a halo buffer, in bf16 elements
constexpr int kKc16 = 16;                      // input channels per chunk (one k16 step per tap)
constexpr int kHld16 = kKc16 + 8;              // halo pixel stride: 48 B, ldmatrix rows on distinct banks
constexpr int kWld16 = kSlab + 8;              // weight row stride: 144 B, likewise
constexpr int kHalo16 = kHF * kHF * kHld16;    // [18 * 18 pixels][24]
constexpr int kW16 = 9 * kKc16 * kWld16;       // [tap][k][72]
constexpr int kRows16 = kKc16 * 4 * (kT + 1);  // halo rows (c, phase, p) of 9 columns per chunk
constexpr int kRowIters16 = (kRows16 + kThreads - 1) / kThreads;

// Shared memory: the main loop's buffers (fp32: three stages; bf16: three
// weight stages and two halo buffers), then the slab's wrgb rows
// [4][64][16]. The epilogue's sums tile zs [64][kZld] reuses the front, and
// in bf16 its activation tile za [4 * 64][kZa] follows zs.
constexpr size_t kMain32 = sizeof(float) * kStages * kStage32;
constexpr size_t kMain16 = sizeof(__nv_bfloat16) * (kStages * kW16 + 2 * kHalo16);
constexpr int kWr = 4 * kSlab * kRgb;
constexpr int kZa = kP + 8;  // za row stride (bf16): 144 B, ldmatrix rows on distinct banks
constexpr size_t kZs = sizeof(float) * kSlab * kZld;
constexpr size_t kEpi16 = kZs + sizeof(__nv_bfloat16) * 4 * kSlab * kZa;
constexpr size_t kFront16 = kMain16 > kEpi16 ? kMain16 : kEpi16;
constexpr size_t kSmem32 = kMain32 + sizeof(float) * kWr;
constexpr size_t kSmem16 = kFront16 + sizeof(__nv_bfloat16) * kWr;
static_assert(kZs <= kMain32 && kZs % 16 == 0 && kFront16 % 16 == 0, "epilogue layout");
static_assert((kW16 * 2) % 16 == 0 && (kHalo16 * 2) % 16 == 0, "16-byte alignment");

struct Args {
  const void* x;    // NCHW (B, 4C, H, W)
  const void* wv;   // (cin_pad, 9, cout_pad), zero-padded
  const float* demod;
  const void* nb;
  const void* wrgb;
  void* out;
  int c, cin_pad, cout_pad, h, w, batch, nb_batched, tiles_x;
};

struct Tile {
  int b, m0, n0;  // image and the tile's first output row and column
};

__device__ __forceinline__ Tile tile_of_block(const Args& a) {
  const int image = blockIdx.x % a.batch;
  const int tile = blockIdx.x / a.batch;
  return {image, (tile / a.tiles_x) * kT, (tile % a.tiles_x) * kT};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies from device to shared memory that bypass the registers; zeros when
// !valid (then nothing is read from `src`).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fine pixel (fa, fb) of the tile -> its slot in the z tile: phase-major,
// then output row and column (phase sigma_h = 1 - fa % 2, row fa / 2).
__device__ __forceinline__ int z_slot(int fa, int fb) {
  return ((1 - (fa & 1)) * 2 + (1 - (fb & 1))) * kP + (fa >> 1) * kT + (fb >> 1);
}

// The slab's rows of wrgb, wr[ph][ch][k] = wrgb[b][ph * C + s0 + ch][k] in
// T (zero past C), by 16-byte cp.async into their own shared memory; issued
// with the slab's first weight stage, so they have landed by its epilogue.
template <typename T>
__device__ __forceinline__ void load_wrgb(const Args& a, const Tile& t, int s0, T* wr) {
  constexpr int kPer16 = 16 / sizeof(T);
  const T* wrgb = static_cast<const T*>(a.wrgb) + static_cast<long>(t.b) * 4 * a.c * kRgb;
  for (int idx = threadIdx.x; idx < 4 * kSlab * kRgb / kPer16; idx += kThreads) {
    const int e = idx * kPer16;  // element of wr
    const int k = e % kRgb, ch = (e / kRgb) % kSlab, ph = e / (kRgb * kSlab);
    const bool valid = s0 + ch < a.c;
    cp_async16(wr + e, valid ? wrgb + (ph * a.c + s0 + ch) * kRgb + k : wrgb, valid);
  }
}

// z = lrelu(acc * demod + noise_bias), rounded to T.
template <typename T>
__device__ __forceinline__ float activation(float acc, float demod, T nb) {
  const float z = acc * demod + gance::to_float(nb);
  return gance::to_float(gance::from_float<T>(fmaxf(z, z * 0.2f)));
}

// fp32: part += activation * wr[ch], the ToRGB product of one channel.
__device__ __forceinline__ void torgb_channel(float acc, float demod, float nb, const float* wr,
                                              float part[kRgb]) {
  const float z = activation(acc, demod, nb);
#pragma unroll
  for (int kq = 0; kq < kRgb / 4; ++kq) {
    const float4 wv = *reinterpret_cast<const float4*>(wr + 4 * kq);
    part[4 * kq] = __fmaf_rn(z, wv.x, part[4 * kq]);
    part[4 * kq + 1] = __fmaf_rn(z, wv.y, part[4 * kq + 1]);
    part[4 * kq + 2] = __fmaf_rn(z, wv.z, part[4 * kq + 2]);
    part[4 * kq + 3] = __fmaf_rn(z, wv.w, part[4 * kq + 3]);
  }
}

// fp32's slab epilogue, once the slab's sums are in zs[ch][slot] (output
// channel s0 + ch), wr has landed, and every thread has passed a barrier.
// Thread = slot (phase ph, position p): z of each of the slab's channels
// stays in a register and feeds the thread's 16 partial RGB sums; a slot
// outside the image or a channel past C adds nothing. The four phases'
// partials then meet in shared memory (reusing zs), and rgb[r] += their sum
// for this thread's position p and columns 4 kg + r.
__device__ void epilogue_slab(const Args& a, const Tile& t, int s0, float* zs, const float* wr,
                              float rgb[4]) {
  const int ho = a.h + 1, wo = a.w + 1, c4 = 4 * a.c;
  const long plane = static_cast<long>(ho) * wo;
  const int slot = threadIdx.x, ph = slot / kP;  // kThreads == 4 * kP; a warp shares ph
  const int m = t.m0 + (slot / kT) % kT, n = t.n0 + slot % kT;
  const int channels = m < ho && n < wo ? min(kSlab, a.c - s0) : 0;
  const long first = static_cast<long>(ph * a.c + s0);  // channel ph * C + s0 of E's layout
  const float* nb = static_cast<const float*>(a.nb) +
                    (a.nb_batched ? static_cast<long>(t.b) * c4 * plane : 0L) + first * plane +
                    static_cast<long>(m) * wo + n;
  const float* demod = a.demod + static_cast<long>(t.b) * c4 + first;
  wr += ph * kSlab * kRgb;

  float part[kRgb];
#pragma unroll
  for (int k = 0; k < kRgb; ++k) part[k] = 0.f;
  if (channels == kSlab) {
#pragma unroll 16
    for (int ch = 0; ch < kSlab; ++ch) {
      torgb_channel(zs[ch * kZld + slot], demod[ch], nb[ch * plane], wr + ch * kRgb, part);
    }
  } else {
    for (int ch = 0; ch < channels; ++ch) {
      torgb_channel(zs[ch * kZld + slot], demod[ch], nb[ch * plane], wr + ch * kRgb, part);
    }
  }
  __syncthreads();  // every thread is done with zs
  float* red = zs;  // red[k][slot]
#pragma unroll
  for (int k = 0; k < kRgb; ++k) red[k * 4 * kP + slot] = part[k];
  __syncthreads();
  const int p = threadIdx.x % kP, kg = threadIdx.x / kP;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* col = red + (4 * kg + r) * 4 * kP + p;
    rgb[r] += ((col[0] + col[kP]) + col[2 * kP]) + col[3 * kP];
  }
}

template <typename T>
__device__ void store_rgb(const Args& a, const Tile& t, const float rgb[4]) {
  const int ho = a.h + 1, wo = a.w + 1;
  const long plane = static_cast<long>(ho) * wo;
  const int p = threadIdx.x % kP, kg = threadIdx.x / kP;
  const int m = t.m0 + p / kT, n = t.n0 + p % kT;
  if (m < ho && n < wo) {
    T* out = static_cast<T*>(a.out) + (static_cast<long>(t.b) * kRgb + 4 * kg) * plane +
             static_cast<long>(m) * wo + n;
#pragma unroll
    for (int r = 0; r < 4; ++r) out[r * plane] = gance::from_float<T>(rgb[r]);
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT
// ---------------------------------------------------------------------------

// Chunk `chunk`'s halo hs[c][i][j] (from NCHW x, 4 bytes at a time, the
// copies of one phase row adjacent) and weights ws[c][tap][o] for slab s0.
__device__ __forceinline__ void load_stage_f32(const Args& a, const Tile& t, const float* x,
                                               float* hs, int chunk, int s0) {
  const int c0 = chunk * kKc32;
  const long hw = static_cast<long>(a.h) * a.w;
  for (int idx = threadIdx.x; idx < kHalo32; idx += kThreads) {
    // idx -> (c, i, dw, q): fine column j = 2 q + dw
    const int q = idx % (kT + 1), dw = (idx / (kT + 1)) % 2;
    const int i = (idx / kHF) % kHF, cc = idx / (kHF * kHF);
    const int c = c0 + cc, p = t.m0 - 1 + (i >> 1), col = t.n0 - 1 + q;
    const bool valid = c < a.c && p >= 0 && p < a.h && col >= 0 && col < a.w;
    const float* src =
        valid ? x + (((i & 1) * 2 + dw) * a.c + c) * hw + static_cast<long>(p) * a.w + col : x;
    cp_async4(hs + (cc * kHF + i) * kHF + 2 * q + dw, src, valid);
  }
  float* ws = hs + kHalo32;
  const float* wv = static_cast<const float*>(a.wv);
  for (int idx = threadIdx.x; idx < kW32 / 4; idx += kThreads) {
    const int row = idx / (kSlab / 4), o = (idx % (kSlab / 4)) * 4;  // row = c * 9 + tap
    cp_async16(ws + row * kSlab + o,
               wv + (static_cast<long>(c0) * 9 + row) * a.cout_pad + s0 + o, true);
  }
}

__global__ void __launch_bounds__(kThreads, 2) phase_f32_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = tile_of_block(a);
  const float* x = static_cast<const float*>(a.x) +
                   static_cast<long>(t.b) * 4 * a.c * a.h * a.w;
  const int cg = threadIdx.x % 8;        // channels 4cg..4cg+3 and 32+4cg..32+4cg+3
  const int pg = threadIdx.x / 8;
  const int fa = pg / 2, fb = (pg % 2) * 8;  // fine row fa, fine columns fb..fb+7
  const int chunks = a.cin_pad / kKc32;
  float* wr = smem + kMain32 / sizeof(float);
  float rgb[4] = {0.f, 0.f, 0.f, 0.f};

  for (int s0 = 0; s0 < a.c; s0 += kSlab) {
    float acc[8][8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[j][q] = 0.f;

    load_wrgb(a, t, s0, wr);  // joins the first stage's group
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < chunks) load_stage_f32(a, t, x, smem + s * kStage32, s, s0);
      cp_async_commit();
    }
    for (int k = 0; k < chunks; ++k) {
      cp_async_wait<kStages - 2>();  // chunk k has landed (this thread's copies)
      __syncthreads();               // ... everyone's; and chunk k - 1's stage is free
      const int next = k + kStages - 1;
      if (next < chunks) load_stage_f32(a, t, x, smem + (next % kStages) * kStage32, next, s0);
      cp_async_commit();

      const float* hs = smem + (k % kStages) * kStage32;
      const float* ws = hs + kHalo32;
#pragma unroll 2
      for (int cc = 0; cc < kKc32; ++cc) {
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          float y[10];
          const float2* row =
              reinterpret_cast<const float2*>(hs + (cc * kHF + fa + dh) * kHF + fb);
#pragma unroll
          for (int j = 0; j < 5; ++j) {
            const float2 v = row[j];
            y[2 * j] = v.x;
            y[2 * j + 1] = v.y;
          }
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const float* wrow = ws + (cc * 9 + dh * 3 + dw) * kSlab;
            const float4 lo = *reinterpret_cast<const float4*>(wrow + 4 * cg);
            const float4 hi = *reinterpret_cast<const float4*>(wrow + 32 + 4 * cg);
            const float wq[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int q = 0; q < 8; ++q) acc[j][q] = __fmaf_rn(y[j + dw], wq[q], acc[j][q]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the stages are free: the z tile and wrgb slab reuse them

    float* zs = smem;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int slot = z_slot(fa, fb + j);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int ch = q < 4 ? 4 * cg + q : 32 + 4 * cg + q - 4;
        zs[ch * kZld + slot] = acc[j][q];
      }
    }
    __syncthreads();
    epilogue_slab(a, t, s0, zs, wr, rgb);
    __syncthreads();  // before the next slab's copies overwrite zs and wr
  }
  store_rgb<float>(a, t, rgb);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores, fp32 accumulation
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One chunk's halo rows in registers. Row (c, phase, p) holds x[phase * C +
// c][p][q] for q = n0 - 1 (s) and q = n0 .. n0 + 7 (v, eight bf16: one
// 16-byte load when W % 8 == 0, since n0 % 8 == 0). Zero outside the image.
struct HaloRows {
  uint4 v[kRowIters16];
  unsigned short s[kRowIters16];
};

__device__ __forceinline__ void load_halo_bf16(const Args& a, const Tile& t,
                                               const unsigned short* x, int chunk, HaloRows& r) {
  const bool whole = a.w % 8 == 0;
#pragma unroll
  for (int it = 0; it < kRowIters16; ++it) {
    const int row = it * kThreads + threadIdx.x;
    const int cc = row % kKc16, ph = (row / kKc16) % 4, pr = row / (4 * kKc16);
    const int c = chunk * kKc16 + cc, p = t.m0 - 1 + pr;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    unsigned short s = 0;
    if (row < kRows16 && c < a.c && p >= 0 && p < a.h) {
      const unsigned short* src = x + (static_cast<long>(ph * a.c + c) * a.h + p) * a.w + t.n0;
      if (t.n0 > 0) s = src[-1];
      if (whole) {
        if (t.n0 < a.w) v = *reinterpret_cast<const uint4*>(src);
      } else {
        unsigned e[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) e[k] = t.n0 + k < a.w ? src[k] : 0u;
        v = make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16, e[6] | e[7] << 16);
      }
    }
    r.v[it] = v;
    r.s[it] = s;
  }
}

// The rows into the pixel-major halo hs[pixel][c], pixel = i * 18 + j with
// fine row i = 2 (p - m0 + 1) + phase / 2 and column j = 2 (q - n0 + 1) +
// phase % 2. A warp writes 16 channels of two neighbouring pixels at a time.
__device__ __forceinline__ void store_halo_bf16(const HaloRows& r, unsigned short* hs) {
#pragma unroll
  for (int it = 0; it < kRowIters16; ++it) {
    const int row = it * kThreads + threadIdx.x;
    if (row < kRows16) {
      const int cc = row % kKc16, ph = (row / kKc16) % 4, pr = row / (4 * kKc16);
      unsigned short* dst = hs + ((2 * pr + (ph >> 1)) * kHF + (ph & 1)) * kHld16 + cc;
      dst[0] = r.s[it];
      const unsigned words[4] = {r.v[it].x, r.v[it].y, r.v[it].z, r.v[it].w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        dst[2 * (k + 1) * kHld16] = static_cast<unsigned short>(words[k / 2] >> (16 * (k % 2)));
      }
    }
  }
}

// Chunk `chunk`'s weights ws[tap][k][o] for slab s0, by 16-byte cp.async.
__device__ __forceinline__ void load_weights_bf16(const Args& a, __nv_bfloat16* ws, int chunk,
                                                  int s0) {
  const int c0 = chunk * kKc16;
  const __nv_bfloat16* wv = static_cast<const __nv_bfloat16*>(a.wv);
  for (int idx = threadIdx.x; idx < 9 * kKc16 * (kSlab / 8); idx += kThreads) {
    const int seg = idx % (kSlab / 8), row = idx / (kSlab / 8);  // row = tap * 16 + k
    const int tap = row / kKc16, k = row % kKc16;
    cp_async16(ws + row * kWld16 + 8 * seg,
               wv + (static_cast<long>(c0 + k) * 9 + tap) * a.cout_pad + s0 + 8 * seg, true);
  }
}

// bf16's slab epilogue: as epilogue_slab, but the ToRGB product runs on the
// tensor cores. Each thread writes its slot's 64 activations (bf16, exact
// as the product's operand) into za[k = ph * 64 + ch][p]; then warp w
// multiplies positions 16 (w % 4) .. + 15 by wr over half of k (w / 4),
// 8 k16 steps x 2 n8 tiles, and the two halves meet in shared memory
// (reusing zs). Products of bf16 are exact in fp32; the sums run in the
// tensor cores' fp32 accumulators.
__device__ void epilogue_slab_bf16(const Args& a, const Tile& t, int s0, float* zs,
                                   __nv_bfloat16* za, const __nv_bfloat16* wr, float rgb[4]) {
  const int ho = a.h + 1, wo = a.w + 1, c4 = 4 * a.c;
  const long plane = static_cast<long>(ho) * wo;
  const int slot = threadIdx.x, ph = slot / kP, p = slot % kP;
  const int m = t.m0 + p / kT, n = t.n0 + p % kT;
  const int channels = m < ho && n < wo ? min(kSlab, a.c - s0) : 0;
  const long first = static_cast<long>(ph * a.c + s0);
  const __nv_bfloat16* nb = static_cast<const __nv_bfloat16*>(a.nb) +
                            (a.nb_batched ? static_cast<long>(t.b) * c4 * plane : 0L) +
                            first * plane + static_cast<long>(m) * wo + n;
  const float* demod = a.demod + static_cast<long>(t.b) * c4 + first;
  __nv_bfloat16* zrow = za + ph * kSlab * kZa + p;
  if (channels == kSlab) {
#pragma unroll 16
    for (int ch = 0; ch < kSlab; ++ch) {
      zrow[ch * kZa] = __float2bfloat16(activation(zs[ch * kZld + slot], demod[ch], nb[ch * plane]));
    }
  } else {
    for (int ch = 0; ch < kSlab; ++ch) {
      const float z = ch < channels ? activation(zs[ch * kZld + slot], demod[ch], nb[ch * plane])
                                    : 0.f;
      zrow[ch * kZa] = __float2bfloat16(z);
    }
  }
  __syncthreads();  // za is complete; zs is free

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mt = warp % 4, half = warp / 4, g = lane >> 2, tig = lane & 3;
  float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int ks = 0; ks < kSlab * 4 / 16 / 2; ++ks) {
    const int k0 = (half * (kSlab * 4 / 16 / 2) + ks) * 16;
    uint32_t af[4], bf[4];
    // A = za^T: stored [k][p], so ldmatrix.trans; matrices (p 0-7 | 8-15) x (k 0-7 | 8-15)
    ldmatrix_x4_trans(af, za + (k0 + (lane >> 4) * 8 + (lane & 7)) * kZa + 16 * mt +
                              ((lane >> 3) & 1) * 8);
    ldmatrix_x4_trans(bf, wr + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kRgb + (lane >> 4) * 8);
    mma_bf16(c[0], af, bf[0], bf[1]);
    mma_bf16(c[1], af, bf[2], bf[3]);
  }
  float* red = zs;  // red[half][p][k]
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[(half * kP + 16 * mt + g + 8 * (e >> 1)) * kRgb + 8 * nt + 2 * tig + (e & 1)] = c[nt][e];
    }
  __syncthreads();
  const int kg = threadIdx.x / kP;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    rgb[r] += red[p * kRgb + 4 * kg + r] + red[(kP + p) * kRgb + 4 * kg + r];
  }
}

__global__ void __launch_bounds__(kThreads, 2) phase_bf16_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* wst = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kStages][kW16]
  unsigned short* hbuf = reinterpret_cast<unsigned short*>(wst + kStages * kW16);  // [2][kHalo16]
  const Tile t = tile_of_block(a);
  const unsigned short* x = static_cast<const unsigned short*>(a.x) +
                            static_cast<long>(t.b) * 4 * a.c * a.h * a.w;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp % 4, wn = warp / 4;  // fine rows 4wm..4wm+3, channels 32wn..32wn+31
  const int g = lane >> 2, tig = lane & 3;
  // ldmatrix: lane l gives row (l & 7) + 8 * ((l >> 3) & 1) of column block l >> 4
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
  const int chunks = a.cin_pad / kKc16;
  __nv_bfloat16* wr = reinterpret_cast<__nv_bfloat16*>(smem_raw + kFront16);
  __nv_bfloat16* za = reinterpret_cast<__nv_bfloat16*>(smem_raw + kZs);
  float rgb[4] = {0.f, 0.f, 0.f, 0.f};

  for (int s0 = 0; s0 < a.c; s0 += kSlab) {
    float acc[4][4][4];  // [fine row][n8 tile][fragment]
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][nt][e] = 0.f;

    load_wrgb(a, t, s0, wr);  // joins the first stage's group
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < chunks) load_weights_bf16(a, wst + s * kW16, s, s0);
      cp_async_commit();
    }
    // the halo goes through registers (a transpose), one chunk ahead
    HaloRows rows;
    load_halo_bf16(a, t, x, 0, rows);
    store_halo_bf16(rows, hbuf);
    if (chunks > 1) load_halo_bf16(a, t, x, 1, rows);
    for (int k = 0; k < chunks; ++k) {
      cp_async_wait<kStages - 2>();  // chunk k's weights have landed (this thread's copies)
      __syncthreads();               // ... everyone's, and its halo; chunk k - 1's buffers are free
      const int next = k + kStages - 1;
      if (next < chunks) load_weights_bf16(a, wst + (next % kStages) * kW16, next, s0);
      cp_async_commit();

      const __nv_bfloat16* hs = reinterpret_cast<const __nv_bfloat16*>(hbuf + (k % 2) * kHalo16);
      const __nv_bfloat16* ws = wst + (k % kStages) * kW16;
#pragma unroll 3
      for (int tap = 0; tap < 9; ++tap) {
        const int dh = tap / 3, dw = tap % 3;
        uint32_t bf[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, ws + (tap * kKc16 + lrow) * kWld16 + 32 * wn + 16 * np + lcol);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // A: the 16 pixels of fine row 4wm + r, shifted by the tap, x 16 channels
          uint32_t af[4];
          ldmatrix_x4(af, hs + ((4 * wm + r + dh) * kHF + dw + lrow) * kHld16 + lcol);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[r][nt], af, bf[nt][0], bf[nt][1]);
        }
      }
      if (k + 1 < chunks) {
        store_halo_bf16(rows, hbuf + ((k + 1) % 2) * kHalo16);
        if (k + 2 < chunks) load_halo_bf16(a, t, x, k + 2, rows);
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    float* zs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int ch = 32 * wn + 8 * nt + 2 * tig;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = z_slot(4 * wm + r, g + 8 * (e >> 1));
          zs[(ch + (e & 1)) * kZld + slot] = acc[r][nt][e];
        }
      }
    }
    __syncthreads();
    epilogue_slab_bf16(a, t, s0, zs, za, wr, rgb);
    __syncthreads();
  }
  store_rgb<__nv_bfloat16>(a, t, rgb);
}

}  // namespace

// x NCHW (B, 4C, H, W); wv (cin_pad, 9, cout_pad) in x's type, with cin_pad
// = C rounded up to 8 (fp32) or 16 (bf16) and cout_pad = C rounded up to 64,
// zero-padded.
extern "C" int gance_phase_conv1_torgb(const void* x, const void* wv, const void* demod,
                                       const void* nb, const void* wrgb, void* out, int batch,
                                       int c4, int h, int w, int nb_batched, int dtype,
                                       void* stream) {
  if (batch <= 0 || c4 <= 0 || c4 % 4 != 0 || c4 > kMaxC4 || h <= 0 || w <= 0 ||
      (dtype != gance::kFloat32 && dtype != gance::kBFloat16)) {
    return cudaErrorInvalidValue;
  }
  const bool f32 = dtype == gance::kFloat32;
  const int c = c4 / 4, chunk = f32 ? kKc32 : kKc16;
  const int tiles_x = (w + 1 + kT - 1) / kT;
  const long blocks = static_cast<long>(batch) * ((h + 1 + kT - 1) / kT) * tiles_x;
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  Args a{x, wv, static_cast<const float*>(demod), nb, wrgb, out,
         c, (c + chunk - 1) / chunk * chunk, (c + kSlab - 1) / kSlab * kSlab,
         h, w, batch, nb_batched, tiles_x};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = f32 ? kSmem32 : kSmem16;
  auto kernel = f32 ? phase_f32_kernel : phase_bf16_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
