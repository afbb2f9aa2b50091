// The row-streaming engine of kernels C (blur4_separable.cu) and D
// (stencil_blur4_valid.cu): a 4x4 stencil over NCHW planes with an implicit
// zero pad, out[i][j] = f(xp[i..i+3][j..j+3]) with xp[r][c] = x[r - pad0][c -
// pad0] inside [0, h) x [0, w_in) and 0 elsewhere. Both kernels are bound by
// memory on the H100 (each element read once, each output written once), so
// the engine is built to keep bytes in flight and to touch each byte once.
//
// Work split. A unit is `tpr` threads that take one column tile of one (b, c)
// plane over a strip of `rh` output rows; narrow planes put several units in
// one block, each on its own plane (`plan`). Thread `lane` owns the V output
// columns j0 + lane*V .. + V-1, V = 16 bytes of elements (4 fp32, 8 bf16).
// The unit walks down its strip one input row at a time, so each input row
// is read from device memory once per strip, plus 3 halo rows per strip. A
// width a few columns past a multiple of a warp's 32*V (1025, 513, ...) sends
// those columns to a second part of the launch, planned like a narrow plane
// (`split_column`), so no warp works for one lane.
//
// The ring. Input rows reach shared memory through a ring of kStages stages,
// filled by 16-byte cp.async: loads run kStages-1 rows ahead of the math, with
// one __syncthreads per row. A row's span starts at the 16-byte boundary at
// or below its first needed element, and that offset (`off`, in elements) is
// kept: with odd widths every row starts at another alignment. Chunks wholly
// outside [0, w_in) are not loaded; a chunk that crosses the first or last
// byte of the tensor is copied element by element with a bounds check.
// Columns outside [0, w_in) and rows outside [0, h) are never read: the
// threads substitute zeros for them. (A chunk may carry bytes of the columns
// past w_in that the row stride holds; they are never used.)
//
// Each thread reads the V+3 input values of a row from three 16-byte shared
// loads and keeps four rows of partial results in registers, one per output
// row in flight (`Op::row`); when input row k has arrived, output row k-3 is
// complete and is stored in aligned 16-byte pieces whatever the row's
// alignment: a lane takes its neighbour's last values by warp shuffle
// (`store_row`), and only lanes at a warp's edges store partial chunks, in
// up to three aligned pieces.
//
// Registers: D's fp32 form is held to 64 a thread (two blocks of 512 per
// SM), where it runs fastest; the bf16 forms and C take what they need (up
// to about 90), since their four rows of partial sums (4 x 11 values for C
// in bf16) spill at 64, which measured slower (PERF.md, PR 6).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace gance {
namespace stencil4 {

constexpr int kStages = 4;  // ring depth: loads run kStages-1 rows ahead
constexpr int kMaxUnitThreads = 512;  // wider planes take column tiles

// Blocks of kMaxUnitThreads an SM must hold, for a kernel whose fp32 form
// asks for `fp32_blocks` (2: at most 64 registers a thread); bf16 forms take
// 1, since at 64 registers their four rows of partial sums spill.
template <typename T>
constexpr int min_blocks(int fp32_blocks) {
  return sizeof(T) == 4 ? fp32_blocks : 1;
}

constexpr int kBlockThreads = 128;  // units narrower than this share a block
constexpr int kMaxSmem = 48 * 1024;  // shared memory a block may take without opting in

struct Geometry {
  long planes;      // B * C
  long x_elems;     // elements of x: guards the tensor's first and last 16 bytes
  int h, ld, w_in;  // input rows, row stride, columns read (>= w_in read as 0)
  int pad0;         // zero rows and columns before the input
  int h_out, w_out;
  int j_base, w_end;  // the part's output columns: [j_base, w_end)
  int tpr;          // threads per unit
  int units;        // units per block
  int col_tiles;    // column tiles per plane
  int tile_w;       // output columns per tile, tpr * V
  int rh;           // output rows per strip
  int blocks_x;     // blocks across the units; blocks_x * strips in all
};

// A row's one or two column parts (`split_column`), run by one launch:
// blocks [0, blocks0) take part 0 and the rest part 1, so that the
// few-column part runs beside the wide one instead of after it.
struct Launch {
  Geometry part[2];
  int parts;
  unsigned blocks0;
};

__host__ __device__ constexpr int vec_of(int elem_bytes) { return 16 / elem_bytes; }

template <int R>
struct Role {
  static constexpr int value = R;
};

// Where a row's columns split into two parts: a width just past a multiple
// of a warp's 32 * V columns (1025 = 256 * 4 + 1 in fp32) would give a unit
// a last warp with one lane at work, which still issues every instruction
// of the row. Such a row's last few columns form a second part, planned
// like a narrow plane (one lane per column group, many planes per block).
// Returns the first column of that part, or w_out.
inline int split_column(int elem_bytes, int w_out) {
  const int v = vec_of(elem_bytes);
  const int need = (w_out + v - 1) / v;
  if (need <= 16) return w_out;
  const int base = need >= 32 ? (need / 32) * 32 : 16;
  const int rem = need - base;
  return rem > 0 && rem <= (base / 8 > 1 ? base / 8 : 1) ? base * v : w_out;
}

// The plan for columns [j_base, w_end) in blocks of at least
// `block_threads`: threads per unit from the width (a power of two up to 16,
// else whole warps), so that narrow planes do not idle most of a block and a
// wide plane takes one unit instead of a second column of blocks; strips of
// 32 to 256 rows, as many as fill the card about four times.
inline Geometry plan(int elem_bytes, long planes, long x_elems, int h, int ld, int w_in, int pad0,
                     int h_out, int w_out, int j_base, int w_end, int block_threads) {
  const int v = vec_of(elem_bytes);
  Geometry g{};
  g.j_base = j_base;
  g.w_end = w_end;
  g.planes = planes;
  g.x_elems = x_elems;
  g.h = h;
  g.ld = ld;
  g.w_in = w_in;
  g.pad0 = pad0;
  g.h_out = h_out;
  g.w_out = w_out;
  const int need = (w_end - j_base + v - 1) / v;
  if (need <= 16) {
    g.tpr = 1;
    while (g.tpr < need) g.tpr *= 2;
  } else {
    g.tpr = ((need + 31) / 32) * 32;
    if (g.tpr > kMaxUnitThreads) g.tpr = kMaxUnitThreads;
  }
  g.col_tiles = (need + g.tpr - 1) / g.tpr;
  g.tile_w = g.tpr * v;
  g.units = g.tpr < block_threads ? block_threads / g.tpr : 1;
  const int fit = kMaxSmem / (kStages * (g.tpr + 2) * 16);  // units whose rings fit
  if (g.units > fit) g.units = fit;
  const long blocks_x = (planes * g.col_tiles + g.units - 1) / g.units;
  const long per_sm = 2048 / (g.tpr * g.units);
  const long want = 132L * per_sm * 4;
  long strips = (want + blocks_x - 1) / blocks_x;
  // a row's second column part is a few columns wide: short strips, so
  // that its walk down the rows runs in parallel with many others
  const int min_rows = j_base > 0 ? 8 : 32;
  const long most = (h_out + min_rows - 1) / min_rows, least = (h_out + 255) / 256;
  if (strips > most) strips = most;
  if (strips < least) strips = least;
  if (strips < 1) strips = 1;
  g.rh = static_cast<int>((h_out + strips - 1) / strips);
  g.blocks_x = blocks_x > 2147483647L ? 0 : static_cast<int>(blocks_x);
  return g;
}

inline long blocks_of(const Geometry& g) {
  return static_cast<long>(g.blocks_x) * ((g.h_out + g.rh - 1) / g.rh);
}

inline size_t smem_bytes(const Geometry& g) {
  return static_cast<size_t>(g.units) * kStages * (g.tpr + 2) * 16;
}

// Plan a row's one or two column parts (`split_column`) and start them with
// `launch(l, blocks, threads, smem_bytes)`, one launch. Returns its error,
// else 0.
template <typename Start>
inline int launch_columns(int elem_bytes, long planes, long x_elems, int h, int ld, int w_in,
                          int pad0, int h_out, int w_out, Start&& launch) {
  const int split = split_column(elem_bytes, w_out);
  Launch l{};
  l.part[0] = plan(elem_bytes, planes, x_elems, h, ld, w_in, pad0, h_out, w_out, 0, split,
                   kBlockThreads);
  const int threads = l.part[0].tpr * l.part[0].units;
  l.parts = split < w_out ? 2 : 1;
  if (l.parts == 2) {
    l.part[1] = plan(elem_bytes, planes, x_elems, h, ld, w_in, pad0, h_out, w_out, split, w_out,
                     threads);
  }
  size_t smem = 0;
  long blocks = 0;
  for (int i = 0; i < l.parts; ++i) {
    const Geometry& g = l.part[i];
    if (g.blocks_x == 0 || g.units < 1 || g.tpr * g.units > threads) return cudaErrorInvalidValue;
    smem = smem_bytes(g) > smem ? smem_bytes(g) : smem;
    blocks += blocks_of(g);
  }
  if (blocks > 2147483647L || smem > kMaxSmem) return cudaErrorInvalidValue;
  l.blocks0 = static_cast<unsigned>(blocks_of(l.part[0]));
  launch(l, static_cast<unsigned>(blocks), threads, smem);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Value e of twelve 32-bit words holding fp32 (one per word) or bf16 (two per
// word, element 2i in the low half) values, as fp32.
template <typename T, int E>
__device__ __forceinline__ float element(const uint32_t (&w)[12]) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[E]);
  } else {
    return (E & 1) ? __uint_as_float(w[E >> 1] & 0xffff0000u) : __uint_as_float(w[E >> 1] << 16);
  }
}

template <typename T, int OFF, int N, int K = 0>
__device__ __forceinline__ void pick(const uint32_t (&w)[12], float (&v)[N]) {
  if constexpr (K < N) {
    v[K] = element<T, OFF + K>(w);
    pick<T, OFF, N, K + 1>(w, v);
  }
}

// v[k] = value off + k of the words, for the row's alignment offset `off`
// (the same for every thread of the block, so the branches do not diverge).
template <typename T, int N, int OFF = 0>
__device__ __forceinline__ void extract(const uint32_t (&w)[12], int off, float (&v)[N]) {
  if constexpr (OFF + 1 < vec_of(sizeof(T))) {
    if (off != OFF) {
      extract<T, N, OFF + 1>(w, off, v);
      return;
    }
  }
  pick<T, OFF, N>(w, v);
}

// V values as one 16-byte store at p, which is 16-byte aligned.
template <typename T, int V>
__device__ __forceinline__ void store16(T* p, const float (&c)[V]) {
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int m = 0; m < 4; ++m) w[m] = __float_as_uint(c[m]);
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(c[2 * m], c[2 * m + 1]);
      w[m] = *reinterpret_cast<const uint32_t*>(&pair);
    }
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// o[I ..] to the positions [Q, END) of one 16-byte chunk, p pointing at
// position Q: in the widest aligned pieces the positions allow (16, 8, 4 or
// 2 bytes), so an edge lane's partial chunk takes at most three stores.
template <typename T, int V, int Q, int END, int I>
__device__ __forceinline__ void store_pieces(T* p, const float (&o)[V]) {
  if constexpr (Q < END) {
    constexpr int qb = Q * static_cast<int>(sizeof(T)), eb = END * static_cast<int>(sizeof(T));
    constexpr int s = (qb % 16 == 0 && qb + 16 <= eb) ? 16
                      : (qb % 8 == 0 && qb + 8 <= eb) ? 8
                      : (qb % 4 == 0 && qb + 4 <= eb) ? 4
                      : static_cast<int>(sizeof(T));
    constexpr int n = s / static_cast<int>(sizeof(T));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int m = 0; m < n; ++m) w[m] = __float_as_uint(o[I + m]);
    } else if constexpr (n >= 2) {
#pragma unroll
      for (int m = 0; m < n / 2; ++m) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(o[I + 2 * m], o[I + 2 * m + 1]);
        w[m] = *reinterpret_cast<const uint32_t*>(&pair);
      }
    }
    if constexpr (s == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (s == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (s == 4 && sizeof(T) == 2) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else {
      *p = from_float<T>(o[I]);
    }
    store_pieces<T, V, Q + n, END, I + n>(p + n, o);
  }
}

// One thread's V outputs o for columns jt .. jt+V-1 at p, n = w_end - jt of
// them in range. p lies `a` elements past a 16-byte boundary (the same for
// every thread of the unit). With a = 0 the thread stores its own 16 bytes.
// Otherwise it stores the aligned 16 bytes that start a elements before p:
// the previous lane's last a values (`prev`, by warp shuffle) and its own
// first V-a. A thread without a previous lane in its warp and unit
// (`has_prev` false) stores its first V-a values, and one whose next lane
// will not store for it (`tail_self`) its last a values, each in up to
// three aligned pieces (`store_pieces`). So only the lanes at a warp's or
// unit's edges store partial chunks, whatever the row's alignment.
template <typename T, int V, int A = 0>
__device__ __forceinline__ void store_row(T* p, int a, const float (&o)[V], const float (&prev)[V],
                                          bool has_prev, bool tail_self, int n) {
  if constexpr (A + 1 < V) {
    if (a != A) {
      store_row<T, V, A + 1>(p, a, o, prev, has_prev, tail_self, n);
      return;
    }
  }
  if constexpr (A == 0) {
    if (n >= V) {
      store16<T, V>(p, o);
    } else {
#pragma unroll
      for (int m = 0; m < V; ++m) {
        if (m < n) p[m] = from_float<T>(o[m]);
      }
    }
  } else if (n >= V) {
    if (has_prev) {
      float c[V];
#pragma unroll
      for (int m = 0; m < A; ++m) c[m] = prev[V - A + m];
#pragma unroll
      for (int m = A; m < V; ++m) c[m] = o[m - A];
      store16<T, V>(p - A, c);
    } else {
      store_pieces<T, V, A, V, 0>(p, o);  // its first V-A values, up to the boundary
    }
    if (tail_self) store_pieces<T, V, 0, A, V - A>(p + (V - A), o);  // its last A, from it
  } else {  // the row's last thread (so tail_self): one by one
    if (has_prev) {
#pragma unroll
      for (int m = 0; m < A; ++m) p[m - A] = from_float<T>(prev[V - A + m]);
    }
#pragma unroll
    for (int m = 0; m < V; ++m) {
      if (m < n) p[m] = from_float<T>(o[m]);
    }
  }
}

// Stream one unit's strip; `block` is the block's index within its part.
// Op::row<R>(v, params, o) takes input row k's V+3 values (k % 4 == R) and
// writes the finished output row k - 3 into o.
template <typename T, typename Op, typename Params>
__device__ __forceinline__ void stream_strip(const T* __restrict__ x, T* __restrict__ out,
                                             const Geometry& g, unsigned block,
                                             const Params& params, Op& op) {
  constexpr int V = vec_of(sizeof(T));
  constexpr int N = V + 3;
  extern __shared__ uint4 ring_all[];

  const int unit = threadIdx.x / g.tpr;
  const int lane = threadIdx.x - unit * g.tpr;
  const int chunks = g.tpr + 2;  // a span of tile_w + 3 elements at any alignment
  uint4* const ring = ring_all + unit * (kStages * chunks);
  const unsigned bx = block % g.blocks_x, by = block / g.blocks_x;
  const long unit_id = static_cast<long>(bx) * g.units + unit;
  const bool unit_ok = unit < g.units && unit_id < g.planes * g.col_tiles;
  const long plane = unit_ok ? unit_id / g.col_tiles : 0;
  const int j0 = g.j_base + static_cast<int>(unit_id - plane * g.col_tiles) * g.tile_w;
  const int cs = j0 - g.pad0;  // input column of the tile's first needed element
  const int i0 = static_cast<int>(by) * g.rh;
  const int nk = min(g.rh, g.h_out - i0) + 3;  // input rows of the strip
  const uintptr_t xplane = reinterpret_cast<uintptr_t>(x + plane * static_cast<long>(g.h) * g.ld);
  const uintptr_t xbegin = reinterpret_cast<uintptr_t>(x);
  const uintptr_t xend = reinterpret_cast<uintptr_t>(x + g.x_elems);
  const int jt = j0 + lane * V;        // this thread's first output column
  const bool active = unit_ok && jt < g.w_end;
  const int c_first = cs + lane * V;   // input column of its first value
  const bool interior = c_first >= 0 && c_first + N <= g.w_in;
  const bool has_prev = (threadIdx.x & 31) != 0 && lane != 0;
  const bool tail_self = (threadIdx.x & 31) == 31 || lane == g.tpr - 1 || jt + V >= g.w_end;
  T* const orow = out + plane * static_cast<long>(g.h_out) * g.w_out + jt;

  // address of input row k's first needed element (it may lie before the
  // row or the tensor: it is aligned down and guarded, never dereferenced)
  auto first_of = [&](int k) -> uintptr_t {
    const long r = i0 - g.pad0 + k;
    return xplane + static_cast<uintptr_t>((r * g.ld + cs) * static_cast<long>(sizeof(T)));
  };
  auto row_in = [&](int k) {
    const int r = i0 - g.pad0 + k;
    return unit_ok && k < nk && r >= 0 && r < g.h;
  };

  auto load_row = [&](int k) {
    if (row_in(k)) {
      const uintptr_t first = first_of(k);
      const uintptr_t base = first & ~static_cast<uintptr_t>(15);
      const int off = static_cast<int>(first - base) / static_cast<int>(sizeof(T));
      uint4* const stage = ring + (k % kStages) * chunks;
      for (int c = lane; c < chunks; c += g.tpr) {
        const int col = cs - off + c * V;  // input column of the chunk's first element
        if (col + V <= 0 || col >= g.w_in) continue;
        const uintptr_t src = base + 16 * static_cast<uintptr_t>(c);
        if (src >= xbegin && src + 16 <= xend) {
          cp_async16(stage + c, src);
        } else {
          T* dst = reinterpret_cast<T*>(stage + c);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const uintptr_t p = src + e * sizeof(T);
            dst[e] = (p >= xbegin && p < xend) ? *reinterpret_cast<const T*>(p) : from_float<T>(0.f);
          }
        }
      }
    }
    cp_async_commit();
  };

  auto step = [&](auto role, int k) {
    constexpr int R = decltype(role)::value;
    cp_async_wait<kStages - 2>();  // row k has landed (this thread's copies)
    __syncthreads();               // ... and every thread's; row k-1's stage is free
    load_row(k + kStages - 1);     // into row k-1's stage
    // every lane computes (idle ones on what they read), so that the whole
    // warp takes part in the shuffle of the stores
    float v[N];
    if (row_in(k)) {
      const uint4* st = ring + (k % kStages) * chunks + lane;
      const uint4 a = st[0], b = st[1], c = st[2];
      const uint32_t w[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
      const uintptr_t first = first_of(k);
      extract<T, N>(w, static_cast<int>(first & 15) / static_cast<int>(sizeof(T)), v);
      if (!interior) {
#pragma unroll
        for (int m = 0; m < N; ++m) {
          const int col = c_first + m;
          if (col < 0 || col >= g.w_in) v[m] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < N; ++m) v[m] = 0.f;
    }
    float o[V];
    op.template row<R>(v, params, o);
    if (k >= 3) {
      T* const p = orow + static_cast<long>(i0 + k - 3) * g.w_out;
      const int a = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15) /
                    static_cast<int>(sizeof(T));
      float prev[V];
      if (__any_sync(0xffffffffu, active && a != 0)) {  // warp-uniform
#pragma unroll
        for (int m = 0; m < V; ++m) prev[m] = __shfl_up_sync(0xffffffffu, o[m], 1);
      }
      if (active)
        store_row<T, V>(p, a, o, prev, has_prev, tail_self, g.w_end - jt);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_row(s);
  for (int k = 0; k < nk; k += 4) {
    step(Role<0>{}, k);
    if (k + 1 < nk) step(Role<1>{}, k + 1);
    if (k + 2 < nk) step(Role<2>{}, k + 2);
    if (k + 3 < nk) step(Role<3>{}, k + 3);
  }
  cp_async_wait<0>();
}

}  // namespace stencil4
}  // namespace gance
