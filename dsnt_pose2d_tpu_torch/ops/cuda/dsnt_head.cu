// Fused DSNT head for Hopper (sm_90a): the forward (flat softmax, plain or
// thresholded, + DSNT coordinate expectation + distribution regularizer) and
// its recompute-based backward, each in one pass over the raw heatmaps.
//
// Replaces the TPU kernels of dsnt_pose2d_tpu/ops/pallas/dsnt_head.py:
// _fwd_kernel (called through _fwd_call) and _bwd_kernel (through _bwd_call).
// Contract per row r (one joint heatmap, H*W values flattened row-major):
//
//   m = max(h);  e = exp(h - m);  s = sum(e);  z = e / s
//   x = <z, X>;  y = <z, Y>          X, Y: pixel-center grid (2i+1)/L - 1
//   G = exp(-((X-tx)^2/sx^2 + (Y-ty)^2/sy^2)/2) / max(sum, 1e-24)
//   reg = JS(z||G) | KL(z||G) | MSE(z,G) | variance penalty | none
//
// Backward, from the cotangents g_x, g_y (coords) and g_reg:
//
//   u  = g_x X + g_y Y + g_reg d(reg)/dz      (exact derivative of the
//                                              eps-guarded forward)
//   dh = z (u - <z, u>)                       (softmax VJP)
//
// z and G are recomputed from the raw row, so nothing heatmap-sized is kept
// between the forward and the backward.  Thresholded softmax drops logits
// below the threshold (weight 0, hence gradient 0); a row with every logit
// below it falls back to the plain softmax.  Logs stay in subtraction form
// log(p + eps) - log(q + eps), eps = 1e-24, as in the JAX package's
// ops/losses.py.  No fast-math: full-precision expf/logf and IEEE division,
// denormals kept.
//
// What bounds it: bytes, if the instructions an element are few enough.
// Each raw value is read once from device memory (4 bytes; the backward also
// writes 4).  At the H100's ~1e12 warp instructions a second against 3.35
// TB/s, a kernel stays under its byte bound only below ~40 instructions an
// element; a full-precision expf or logf is ~10-20 of them.
//
// The forward (redesigned for Hopper; see dsnt_head_fwd_kernel): the row
// in registers, one expf an element for the softmax, a separable Gaussian
// (W + H expf a row), logs of z and of the Gaussian taken from the logits
// (JS and KL one logf an element), and two row combines (one for none/var).
// The TPU kernels padded rows to 128 lanes with -1e30 logits and 1e4 grid
// coordinates; here loops are bounded by H*W, so any map size up to kMaxHw
// works.
//
// The backward (redesigned for Hopper on the forward's pieces; see
// bwd_row_regs): the same row in registers, the same combine 1 (softmax and
// the Gaussian's sums, or var's moments), u held in the logits' registers
// with at most one logf an element (none where the Gaussian has
// underflowed), one more combine for <z, u>, and dh written once,
// coalesced: dynamic shared memory for the Gaussian's factors and their
// logs only, and no integer division an element.  The bytes it must move
// are the forward's twice (dh is written).
//
// Which layout takes which map (the same for both kernels; see the layout
// structs below):
//   Map64      64x64 rows at a 16-byte aligned base (the backward: raw and
//              dh both aligned): 256 threads a row, 16 values a thread as
//              four float4;
//   WarpRow    rows of at most 256 values (7x7 to 16x16): one warp a row,
//              up to 8 values a lane, four rows a block; warp shuffles only,
//              no barrier;
//   Slots<4>   257 to 1,024 values (28x28, 32x32): 256 threads a row, 4
//              values a thread;
//   Slots<16>  1,025 to 4,096 values (56x56, a 64x64 row off the 16-byte
//              grid): 256 threads a row, 16 values a thread;
//   AnyMap (forward) and StagedRow (backward) for rows of 4,097 to kMaxHw
//              values, which no configuration of the repo runs: AnyMap holds
//              64 values a thread, StagedRow the row in 2 * H * W floats of
//              shared memory, read in three passes.
//
// Block and warp sums use shuffles and a fixed order, so results are
// deterministic run to run.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kEps = 1e-24f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHw = 16384;  // MAX_HW in dsnt_head.py checks it first

enum RegKind { kNone = 0, kJs = 1, kKl = 2, kMse = 3, kVar = 4 };

template <int REG>
__host__ __device__ constexpr bool uses_gauss() {
  return REG == kJs || REG == kKl || REG == kMse;
}

// Sums N per-thread values over the block; every thread gets the totals.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    }
    if (lane == 0) red[warp * N + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float t = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) t += red[wi * N + k];
    v[k] = t;
  }
  __syncthreads();
}

template <int N>
__device__ __forceinline__ void block_max(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] = fmaxf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
    }
    if (lane == 0) red[warp * N + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float t = -INFINITY;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) t = fmaxf(t, red[wi * N + k]);
    v[k] = t;
  }
  __syncthreads();
}

// Pass 0 of both kernels: stages the row x in e[] and returns the softmax's
// shift, the row max (the max over kept logits when a thresholded row keeps
// any).  *filter says whether logits below the threshold are dropped.
template <bool THRESH>
__device__ __forceinline__ float stage_row(const float* __restrict__ x,
                                           float* e, int hw, float threshold,
                                           float* red, bool* filter) {
  float mx[3] = {-INFINITY, -INFINITY, 0.f};  // all, kept, any kept
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    const float v = x[i];
    e[i] = v;
    mx[0] = fmaxf(mx[0], v);
    if (THRESH && v >= threshold) {
      mx[1] = fmaxf(mx[1], v);
      mx[2] = 1.f;
    }
  }
  block_max<3>(mx, red);   // its barrier also publishes e[] to the block
  *filter = THRESH && mx[2] > 0.f;
  return *filter ? mx[1] : mx[0];
}

__device__ __forceinline__ float softmax_weight(float v, float m, bool filter,
                                                float threshold) {
  return (filter && !(v >= threshold)) ? 0.f : expf(v - m);
}

__device__ __forceinline__ void grid_xy(int i, int h, int w, float* gx,
                                        float* gy) {
  const int r = i / w;
  const int c = i - r * w;
  *gx = (2.f * c + 1.f) / w - 1.f;
  *gy = (2.f * r + 1.f) / h - 1.f;
}

// ---------------------------------------------------------------------------
// The forward.  Its helpers take the row layout as a template parameter, so
// that a backward can be built on the same layouts.
//
// Where a thread's values sit in its row (kRowThreads threads hold a row,
// kRows rows a block, kVals value slots a thread):
//   Map64      the flagship's 64x64 map: 16 values a thread as 4 float4;
//              float4 number t + 256 k holds x = 4 (t % 16) + q, q = 0..3, of
//              map row y = t / 16 + 16 k.  w and h are compile-time constants,
//              so the grid coordinates come from the thread index by shifts.
//   Slots<S>   up to 256 S values, S a thread: value k of thread t is element
//              t + 256 k (coalesced scalar loads and stores); its (x, y) steps
//              on from value k - 1's (Walk), and its grid coordinates come
//              from the row's table of W + H of them in shared memory (built
//              once a row, one barrier): no division an element.
//   WarpRow    up to 256 values, one warp a row and four rows a block (a call
//              of 512 rows spreads as 128 blocks over the 132 SMs): value k
//              of lane l is element l + 32 k, stepped as in Slots.  Its sums
//              are warp shuffles, and each warp keeps its own share of the
//              Gaussian's factors in shared memory.
//   AnyMap     any map of up to kMaxHw values, 64 a thread, as in Slots but
//              with (x, y) from a division.  It spills registers; only rows
//              of more than 4,096 values take it.
struct Map64 {
  static constexpr int kVals = 16;
  static constexpr bool kFixed = true;
  static constexpr bool kStep = false;
  static constexpr int kRowThreads = kThreads;
  static constexpr int kRows = 1;
};

template <int S>
struct Slots {
  static constexpr int kVals = S;
  static constexpr bool kFixed = false;
  static constexpr bool kStep = true;
  static constexpr int kRowThreads = kThreads;
  static constexpr int kRows = 1;
};

struct WarpRow {
  static constexpr int kVals = 8;
  static constexpr bool kFixed = false;
  static constexpr bool kStep = true;
  static constexpr int kRowThreads = 32;
  static constexpr int kRows = 4;
};

struct AnyMap {
  static constexpr int kVals = kMaxHw / kThreads;
  static constexpr bool kFixed = false;
  static constexpr bool kStep = false;
  static constexpr int kRowThreads = kThreads;
  static constexpr int kRows = 1;
};

// The most values a row of layout L can hold.
template <class L>
constexpr int row_capacity() {
  return L::kRowThreads * L::kVals;
}

// This thread's index among its row's threads, and its row.
template <class L>
__device__ __forceinline__ int row_thread() {
  if constexpr (L::kRows == 1) {
    return threadIdx.x;
  } else {
    return threadIdx.x & 31;
  }
}

template <class L>
__device__ __forceinline__ size_t row_index() {
  if constexpr (L::kRows == 1) {
    return blockIdx.x;
  } else {
    return static_cast<size_t>(blockIdx.x) * L::kRows + (threadIdx.x >> 5);
  }
}

// Dynamic shared memory a row, in floats: the grid coordinates' table
// (stepped layouts: X[w], then Y[h]), then the Gaussian's factors and their
// logs (js/kl/mse: gx[w], log gx[w], gy[h], log gy[h]).
template <int REG, class L>
__host__ __device__ constexpr int row_smem_floats(int h, int w) {
  return (L::kStep ? w + h : 0) + (uses_gauss<REG>() ? 2 * (w + h) : 0);
}

// This row's share of the dynamic shared memory (row_smem_floats).
template <int REG, class L>
__device__ __forceinline__ float* row_smem(float* smem, int h, int w) {
  if constexpr (L::kRows == 1) {
    return smem;
  } else {
    return smem + (threadIdx.x >> 5) * row_smem_floats<REG, L>(h, w);
  }
}

// Keeps -d^2/2 finite for a target at any distance: 0 * (-inf) would be NaN.
constexpr float kLogFloor = -1e30f;
constexpr float kLn2 = 0.693147180559945309f;

template <class L>
__device__ __forceinline__ bool value_in_row(int k, int hw) {
  if constexpr (L::kFixed) {
    return true;
  } else {
    return row_thread<L>() + L::kRowThreads * k < hw;
  }
}

// (x, y) of value k of this thread, for Map64 and AnyMap.
template <class L>
__device__ __forceinline__ void value_xy(int k, int w, int* x, int* y) {
  const int t = threadIdx.x;
  if constexpr (L::kFixed) {
    *x = 4 * (t & 15) + (k & 3);
    *y = (t >> 4) + 16 * (k >> 2);
  } else {
    const int i = t + kThreads * k;
    *y = i / w;
    *x = i - *y * w;
  }
}

// Walks this thread's values in order, k = 0, 1, 2, ... (next() between
// them), giving each one's (x, y).  In a stepped layout value k + 1 lies
// kRowThreads = dy w + dx elements after value k: x += dx, y += dy, with
// at most one carry, so the two divisions are taken once a thread.
template <class L>
struct Walk {
  int x = 0, y = 0, dx = 0, dy = 0;

  __device__ __forceinline__ explicit Walk(int w) {
    if constexpr (L::kStep) {
      const int t = row_thread<L>();
      y = t / w;
      x = t - y * w;
      dy = L::kRowThreads / w;
      dx = L::kRowThreads - dy * w;
    }
  }

  __device__ __forceinline__ void at(int k, int w, int* px, int* py) const {
    if constexpr (L::kStep) {
      *px = x;
      *py = y;
    } else {
      value_xy<L>(k, w, px, py);
    }
  }

  __device__ __forceinline__ void next(int w) {
    if constexpr (L::kStep) {
      x += dx;
      y += dy;
      if (x >= w) {
        x -= w;
        ++y;
      }
    }
  }
};

// log z taken from the logit v, as (v - m) - log S.  Every use multiplies
// it by z, so a z of 0 takes 0: a -inf logit would give 0 * (-inf) = NaN,
// where the contract's log(z + eps) is finite.
__device__ __forceinline__ float log_z(float v, float m, float ls, float z) {
  return z == 0.f ? 0.f : (v - m) - ls;
}

// The pixel-center coordinate (2 i + 1) / n - 1 of normalized_linspace.
__device__ __forceinline__ float grid_coord(int i, int n) {
  return (2.f * i + 1.f) / n - 1.f;
}

// A stepped layout's table of the row's grid coordinates, X[w] then Y[h]
// (the values grid_coord gives), published to the row's threads: one
// barrier, a __syncwarp in WarpRow.  Other layouts need none.
template <class L>
__device__ __forceinline__ void coord_table(float* ctab, int h, int w) {
  if constexpr (L::kStep) {
    for (int c = row_thread<L>(); c < w + h; c += L::kRowThreads) {
      ctab[c] = c < w ? grid_coord(c, w) : grid_coord(c - w, h);
    }
    if constexpr (L::kRows == 1) {
      __syncthreads();
    } else {
      __syncwarp();
    }
  }
}

// The grid coordinates (X, Y) at (x, y): from the table in a stepped
// layout, from grid_coord otherwise (by shifts for Map64's constant w, h).
template <class L>
__device__ __forceinline__ void grid_at(const float* ctab, int x, int y,
                                        int h, int w, float* gx, float* gy) {
  if constexpr (L::kStep) {
    *gx = ctab[x];
    *gy = ctab[w + y];
  } else {
    *gx = grid_coord(x, w);
    *gy = grid_coord(y, h);
  }
}

template <class L>
__device__ __forceinline__ void load_row(const float* __restrict__ x, int hw,
                                         float (&v)[L::kVals]) {
  if constexpr (L::kFixed) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4 q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = __ldg(x4 + threadIdx.x + kThreads * k);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[4 * k] = q[k].x;
      v[4 * k + 1] = q[k].y;
      v[4 * k + 2] = q[k].z;
      v[4 * k + 3] = q[k].w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < L::kVals; ++k) {
      v[k] = value_in_row<L>(k, hw)
                 ? __ldg(x + row_thread<L>() + L::kRowThreads * k)
                 : 0.f;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// One barrier: each thread's NS partial sums acc and its warp's max mw ->
// the row's.  The first NR sums are relative to mw (sums of exp(v - m_w)),
// the rest plain.  Each warp's sums go to part[w] with its max; every thread
// gets the row max M (returned), the totals (the first NR relative to M) and,
// in *own, its own warp's factor exp(m_w - M).  Lanes l and l + 8k each take
// warp l % 8's partial and reduce over xor 1, 2, 4: every lane sums in the
// same order up to commutation, so all threads get bitwise the same totals.
// In WarpRow the warp is the row: its sums are the totals, M = m_w, and a
// __syncwarp takes the barrier's place (it publishes the lanes' shares of
// the Gaussian's factors to the warp).
template <class L, int NS, int NR>
__device__ __forceinline__ float combine_warps(float (*part)[NS + 1],
                                               const float (&acc)[NS],
                                               float mw, float (&tot)[NS],
                                               float* own) {
  if constexpr (L::kRowThreads == 32) {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < NS; ++k) tot[k] = warp_sum(acc[k]);
    *own = (mw == -INFINITY) ? 0.f : 1.f;
    return mw;
  }
  const int lane = threadIdx.x & 31;
  float s[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) s[k] = warp_sum(acc[k]);
  if (lane == 0) {
    float* p = part[threadIdx.x >> 5];
    p[0] = mw;
#pragma unroll
    for (int k = 0; k < NS; ++k) p[k + 1] = s[k];
  }
  __syncthreads();
  const float* p = part[lane & (kWarps - 1)];
  const float m = p[0];
  float mm = m;
#pragma unroll
  for (int off = 1; off < kWarps; off <<= 1) {
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
  }
  const float scale = (m == -INFINITY) ? 0.f : expf(m - mm);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    float t = (k < NR) ? p[k + 1] * scale : p[k + 1];
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      t += __shfl_xor_sync(0xffffffffu, t, off);
    }
    tot[k] = t;
  }
  *own = __shfl_sync(0xffffffffu, scale, threadIdx.x >> 5);
  return mm;
}

// One barrier: the sum of v over the row, the same in every thread (in
// WarpRow the warp's sum, no barrier).
template <class L>
__device__ __forceinline__ float combine_sum(float v, float* red) {
  if constexpr (L::kRowThreads == 32) return warp_sum(v);
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[lane & (kWarps - 1)];
#pragma unroll
  for (int off = 1; off < kWarps; off <<= 1) {
    t += __shfl_xor_sync(0xffffffffu, t, off);
  }
  return t;
}

// exp(v - m_w) of the kept values (v >= threshold under `filter`; 0 for the
// others), m_w the warp's max over them (-inf if the warp keeps none), and
// their sums: [0] sum e, [1] sum e X, [2] sum e Y, and for var [3] sum e X^2,
// [4] sum e Y^2.  Without XY (a backward that needs no moments) only sum e.
// Returns m_w.
template <class L, bool VAR, bool XY, int NS>
__device__ __forceinline__ float softmax_partials(const float (&v)[L::kVals],
                                                  float (&e)[L::kVals],
                                                  float (&acc)[NS],
                                                  const float* ctab, int h,
                                                  int w, bool filter,
                                                  float threshold) {
  static_assert(XY || !VAR, "var needs the moments");
  float mt = -INFINITY;
#pragma unroll
  for (int k = 0; k < L::kVals; ++k) {
    if (value_in_row<L>(k, h * w) && !(filter && !(v[k] >= threshold))) {
      mt = fmaxf(mt, v[k]);
    }
  }
  const float mw = warp_max(mt);
  Walk<L> pos(w);
#pragma unroll
  for (int k = 0; k < L::kVals; ++k, pos.next(w)) {
    if constexpr (L::kStep) {
      if (!value_in_row<L>(k, h * w)) {
        e[k] = 0.f;
        continue;
      }
    }
    const bool kept = value_in_row<L>(k, h * w) &&
                      !(filter && !(v[k] >= threshold));
    e[k] = kept ? expf(v[k] - mw) : 0.f;
    if constexpr (XY) {
      int x, y;
      pos.at(k, w, &x, &y);
      float gx, gy;
      grid_at<L>(ctab, x, y, h, w, &gx, &gy);
      acc[0] += e[k];
      acc[1] += e[k] * gx;
      acc[2] += e[k] * gy;
      if constexpr (VAR) {
        acc[3] += e[k] * gx * gx;
        acc[4] += e[k] * gy * gy;
      }
    } else {
      acc[0] += e[k];
    }
  }
  return mw;
}

// The separable Gaussian's factors, each thread a few of the W + H, into
// f: gx[w], log gx[w], gy[h], log gy[h] (the logs -d^2/2, floored at
// kLogFloor).  acc[3] and acc[4] gain this thread's share of sum gx and
// sum gy; t is the row's target (x, y).
template <class L, int NS>
__device__ __forceinline__ void gauss_factors(float* f,
                                              const float* __restrict__ t,
                                              int h, int w, float inv_sx,
                                              float inv_sy, float (&acc)[NS]) {
  static_assert(NS == 5, "acc[3] and acc[4] hold the Gaussian's sums");
  const float tx = t[0];
  const float ty = t[1];
  for (int c = row_thread<L>(); c < w + h; c += L::kRowThreads) {
    const bool is_x = c < w;
    const float d = is_x ? (grid_coord(c, w) - tx) * inv_sx
                         : (grid_coord(c - w, h) - ty) * inv_sy;
    const float l = -0.5f * d * d;
    const float g = expf(l);
    float* fc = is_x ? f + c : f + 2 * w + (c - w);
    fc[0] = g;
    fc[is_x ? w : h] = fmaxf(l, kLogFloor);
    if (is_x) {
      acc[3] += g;
    } else {
      acc[4] += g;
    }
  }
}

// Combine 1 of the row-in-registers kernels: e = exp(v - m_w) and the
// row's max (returned) and sums, as combine_warps gives them (acc holds
// this thread's Gaussian sums on entry, if any).  A thresholded row that
// keeps no logit takes the plain softmax: one more combine, on part[1].
template <class L, bool THRESH, bool VAR, bool XY, int NS>
__device__ __forceinline__ float softmax_row(const float (&v)[L::kVals],
                                             float (&e)[L::kVals],
                                             float (&acc)[NS],
                                             float (*part)[kWarps][NS + 1],
                                             const float* ctab, int h, int w,
                                             float threshold,
                                             float (&tot)[NS], float* own) {
  constexpr int kNr = (NS == 5 && !VAR) ? 3 : NS;  // sums relative to a max
  float mw = softmax_partials<L, VAR, XY>(v, e, acc, ctab, h, w, THRESH,
                                          threshold);
  float m = combine_warps<L, NS, kNr>(part[0], acc, mw, tot, own);
  if (THRESH && m == -INFINITY) {
    // No logit reaches the threshold: the plain softmax (the Gaussian's
    // partial sums are kept).
#pragma unroll
    for (int k = 0; k < kNr; ++k) acc[k] = 0.f;
    mw = softmax_partials<L, VAR, XY>(v, e, acc, ctab, h, w, false,
                                      threshold);
    m = combine_warps<L, NS, kNr>(part[1], acc, mw, tot, own);
  }
  return m;
}

// Forward, the row held in registers in layout L (a 256-thread block a row,
// or a warp a row in WarpRow).
//   combine 1: row max and the sums of e, e X, e Y (and e X^2, e Y^2 for
//              var, or the Gaussian's two factor sums), merged across warps
//              by rescaling each warp's partial with exp(m_w - M);
//   combine 2: js/kl/mse only, the regularizer's sum.
// Each combine is one barrier in a block row and warp shuffles alone in
// WarpRow.  A thresholded row that keeps no logit takes one more combine
// (the plain softmax's partials again).
//
// The target Gaussian is separable, exp(-(dx^2 + dy^2)/2) = gx(x) gy(y), so
// a row costs W + H expf for it (into shared memory, with their logs -d^2/2)
// and sum G = sum gx * sum gy.  Logs of z and of the normalized Gaussian gn
// are taken from the logits, where eps = 1e-24 is absorbed (z + eps == z in
// fp32 for z >~ 1.7e-17):
//   log(z + eps)  -> (v - M) - log S                  (multiplies z)
//   log(gn + eps) -> -dx^2/2 - dy^2/2 - log max(sum G, eps)   (multiplies gn)
// Below that point the term it enters is under 1e-15 of the row's sum.  The
// guard max(sum G, eps) is the one the normalization takes, so a target far
// off the grid (sum G underflows) gives finite logs, not 0 * inf.  KL keeps
// logf(gn + eps), which multiplies z there; JS keeps the one logf of
// 0.5 (z + gn) + eps: JS one logf an element, KL one, the others none, and
// one expf an element for the softmax.  Where the Gaussian has underflowed
// to gn = 0 (beyond ~14 sigma of the target: most of a 64x64 map at sigma
// 1 px), JS's term is z log 2 and KL's log(gn + eps) is log eps, so a warp
// whose values all lie there takes no logf at all.
template <int REG, bool THRESH, class L>
__global__ void __launch_bounds__(L::kRows * L::kRowThreads)
dsnt_head_fwd_kernel(const float* __restrict__ raw,
                     const float* __restrict__ targets,
                     float* __restrict__ coords, float* __restrict__ reg_out,
                     int h_arg, int w_arg, float threshold, float inv_sx,
                     float inv_sy, float tvx, float tvy, int n) {
  constexpr bool kGauss = uses_gauss<REG>();
  constexpr bool kIsVar = REG == kVar;
  constexpr int kNs = (kGauss || kIsVar) ? 5 : 3;   // sums of combine 1
  constexpr int kVals = L::kVals;
  extern __shared__ float smem[];  // row_smem_floats a row
  __shared__ float part[2][kWarps][kNs + 1];
  __shared__ float red[kWarps];
  const int w = L::kFixed ? 64 : w_arg;
  const int h = L::kFixed ? 64 : h_arg;
  const int hw = h * w;
  const size_t row = row_index<L>();
  if constexpr (L::kRows > 1) {
    if (row >= static_cast<size_t>(n)) return;   // the whole warp: no barrier
  }
  float* ctab = row_smem<REG, L>(smem, h, w);
  float* gfac = ctab + (L::kStep ? w + h : 0);

  float v[kVals], e[kVals];
  load_row<L>(raw + row * hw, hw, v);

  float acc[kNs];
#pragma unroll
  for (int k = 0; k < kNs; ++k) acc[k] = 0.f;
  if constexpr (kGauss) {
    gauss_factors<L>(gfac, targets + 2 * row, h, w, inv_sx, inv_sy, acc);
  }
  coord_table<L>(ctab, h, w);

  // Combine 1: the softmax's max and sums (and the Gaussian's sums).
  float tot[kNs], own;
  const float m = softmax_row<L, THRESH, kIsVar, true>(
      v, e, acc, part, ctab, h, w, threshold, tot, &own);
  const float rs = 1.f / tot[0];
  const float cx = tot[1] * rs;
  const float cy = tot[2] * rs;

  float regv = 0.f;
  if constexpr (kIsVar) {
    const float var_x = tot[3] * rs - cx * cx;
    const float var_y = tot[4] * rs - cy * cy;
    regv = (var_x - tvx) * (var_x - tvx) + (var_y - tvy) * (var_y - tvy);
  }
  if constexpr (kGauss) {
    // Combine 2: the regularizer against the normalized Gaussian.
    const float* gxs = gfac;
    const float* lgx = gfac + w;
    const float* gys = gfac + 2 * w;
    const float* lgy = gfac + 2 * w + h;
    const float sg = fmaxf(tot[3] * tot[4], kEps);
    const float rg = 1.f / sg;
    const float lsg = logf(sg);
    const float ls = logf(tot[0]);
    const float zc = own * rs;            // z = e * exp(m_w - M) / S
    const float log_eps = logf(kEps);
    float acc2 = 0.f;
    Walk<L> pos(w);
#pragma unroll
    for (int k = 0; k < kVals; ++k, pos.next(w)) {
      if (!value_in_row<L>(k, hw)) continue;
      int x, y;
      pos.at(k, w, &x, &y);
      const float z = e[k] * zc;
      const float gn = gxs[x] * rg * gys[y];
      if constexpr (REG == kJs) {
        if (gn == 0.f) {
          // z (log(z + eps) - log(z / 2 + eps)) = z log 2 where eps is
          // absorbed, and under 1e-22 where it is not.
          acc2 += z * kLn2;
        } else {
          const float lz = log_z(v[k], m, ls, z);
          const float lg = (lgx[x] + lgy[y]) - lsg;
          const float lm = logf(0.5f * (z + gn) + kEps);
          acc2 += z * (lz - lm) + gn * (lg - lm);
        }
      } else if constexpr (REG == kKl) {
        const float lgn = (gn == 0.f) ? log_eps : logf(gn + kEps);
        acc2 += z * (log_z(v[k], m, ls, z) - lgn);
      } else {
        acc2 += (z - gn) * (z - gn);
      }
    }
    const float sum = combine_sum<L>(acc2, red);
    regv = (REG == kJs) ? 0.5f * sum : (REG == kMse) ? sum / hw : sum;
  }
  if (row_thread<L>() == 0) {
    coords[2 * row] = cx;
    coords[2 * row + 1] = cy;
    reg_out[row] = regv;
  }
}

// d(reg)/dz for one element: z and the normalized Gaussian gn (js/kl/mse),
// or the grid position and the row's moments (var).  Exact derivative of
// the eps-guarded forward, the z/(z+eps) terms kept, as _reg_grad_rows in
// the JAX kernel.
template <int REG>
__device__ __forceinline__ float reg_grad(float z, float gn, float gx,
                                          float gy, float inv_hw, float mu_x,
                                          float mu_y, float cvx, float cvy) {
  if (REG == kJs) {
    const float m2 = 0.5f * (z + gn);
    const float m2e = m2 + kEps;
    return 0.5f * (logf(z + kEps) - logf(m2e)) + 0.5f * z / (z + kEps)
         - 0.5f * m2 / m2e;
  }
  if (REG == kKl) return logf(z + kEps) - logf(gn + kEps) + z / (z + kEps);
  if (REG == kMse) return 2.f * (z - gn) * inv_hw;
  if (REG == kVar) {
    return cvx * (gx * gx - 2.f * mu_x * gx) + cvy * (gy * gy - 2.f * mu_y * gy);
  }
  return 0.f;
}

// The backward of a row staged in shared memory (StagedRow: rows of 4,097
// to kMaxHw values, which no configuration of the repo runs): the row is
// read from device memory once, coalesced, into shared memory (2 * H * W
// floats: z, then u), and every later pass reads shared memory; grid
// coordinates come from the index by a division; three block reductions
// (six barriers).
template <int REG, bool THRESH>
__device__ __forceinline__ void bwd_row_staged(
    const float* __restrict__ raw, const float* __restrict__ targets,
    const float* __restrict__ g_coords, const float* __restrict__ g_reg,
    float* __restrict__ dh, int h, int w, float threshold, float inv_sx,
    float inv_sy, float tvx, float tvy) {
  constexpr bool kGauss = uses_gauss<REG>();
  extern __shared__ float smem[];
  __shared__ float red[kWarps * 5];
  const int hw = h * w;
  const size_t row = blockIdx.x;
  float* z = smem;            // logits, then exp(h - m), then z
  float* u = smem + hw;       // unnormalized Gaussian (kGauss), then u

  // Pass 0: stage the row; the softmax's shift.
  bool filter;
  const float m = stage_row<THRESH>(raw + row * hw, z, hw, threshold, red,
                                    &filter);

  // Pass 1: e = exp(h - m); sums of e and either the Gaussian's sum
  // (js/kl/mse) or e*X, e*Y, e*X^2, e*Y^2 (var: the moments its derivative
  // needs).
  float tx = 0.f, ty = 0.f;
  if (kGauss) {
    tx = targets[2 * row] * inv_sx;
    ty = targets[2 * row + 1] * inv_sy;
  }
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    const float ev = softmax_weight(z[i], m, filter, threshold);
    z[i] = ev;
    acc[0] += ev;
    if (kGauss || REG == kVar) {
      float gx, gy;
      grid_xy(i, h, w, &gx, &gy);
      if (kGauss) {
        const float dx = gx * inv_sx - tx;
        const float dy = gy * inv_sy - ty;
        const float gv = expf(-0.5f * (dx * dx + dy * dy));
        u[i] = gv;
        acc[1] += gv;
      } else {
        acc[1] += ev * gx;
        acc[2] += ev * gy;
        acc[3] += ev * gx * gx;
        acc[4] += ev * gy * gy;
      }
    }
  }
  block_sum<5>(acc, red);
  const float rs = 1.f / acc[0];
  const float rg = kGauss ? 1.f / fmaxf(acc[1], kEps) : 0.f;
  float mu_x = 0.f, mu_y = 0.f, cvx = 0.f, cvy = 0.f;
  if (REG == kVar) {
    mu_x = acc[1] * rs;
    mu_y = acc[2] * rs;
    cvx = 2.f * (acc[3] * rs - mu_x * mu_x - tvx);
    cvy = 2.f * (acc[4] * rs - mu_y * mu_y - tvy);
  }
  const float gcx = g_coords[2 * row];
  const float gcy = g_coords[2 * row + 1];
  const float gr = (REG == kNone) ? 0.f : g_reg[row];
  const float inv_hw = 1.f / hw;

  // Pass 2: z, u and <z, u>.  Each thread reads back in pass 3 only the
  // elements it wrote here.
  float dot[1] = {0.f};
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    const float zi = z[i] * rs;
    float gx, gy;
    grid_xy(i, h, w, &gx, &gy);
    float ui = gcx * gx + gcy * gy;
    if (REG != kNone) {
      const float gn = kGauss ? u[i] * rg : 0.f;
      ui += gr * reg_grad<REG>(zi, gn, gx, gy, inv_hw, mu_x, mu_y, cvx, cvy);
    }
    z[i] = zi;
    u[i] = ui;
    dot[0] += zi * ui;
  }
  block_sum<1>(dot, red);

  // Pass 3: dh = z (u - <z, u>), written once, coalesced.
  float* out = dh + row * hw;
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    out[i] = z[i] * (u[i] - dot[0]);
  }
}

// The backward of a row in registers (Map64, Slots<S>, WarpRow), on the
// forward's pieces: the logits loaded as the forward loads them (four float4
// a thread in Map64), the softmax and the Gaussian's sums in combine 1
// (softmax_row; var's moments there too), u in the registers that held the
// logits, <z, u> in combine 2 (combine_sum), and dh written once, coalesced
// (four float4 a thread in Map64, one float a value elsewhere).
//
// u takes the exact derivative of the eps-guarded forward where eps is
// absorbed (z, m2 >~ 1.7e-17 in fp32: z + eps == z); below that, the term
// enters dh = z (...) times z < 3.4e-17, far below any tolerance:
//   z / (z + eps), m2 / (m2 + eps)  -> 1, so they cancel (JS) or give +1 (KL)
//   log(z + eps)                    -> (v - M) - log S, from the logit
//                                      (log_z: 0 where z == 0)
//   JS: 0.5 (lz - logf(m2 + eps)), m2 = (z + gn) / 2; 0.5 ln 2 where gn == 0
//   KL: lz - logf(gn + eps) + 1; lz - log eps + 1 where gn == 0
//   mse and var: no transcendental.
// So js and kl take at most one logf an element, none where the Gaussian
// has underflowed to gn == 0 (beyond ~14 sigma of the target: most of a
// 64x64 map at sigma 1 px), plus the softmax's one expf.
//
// The separable gn = gx * (1 / max(sum G, eps)) * gy is the contract's
// exp(-(dx^2 + dy^2)/2) / max(sum G, eps) to a few ulp wherever it matters,
// as long as 1 / max(sum G, eps) <= 1.  A row whose sum G is below 1 (a
// target off the grid) scales by more than 1, and then lifts values that
// the contract's exp underflows to 0 or to an imprecise denormal before the
// normalization, and KL's log(gn + eps) sees the difference.  Such a row
// (uniform over the row's threads) takes the contract's form,
// expf(log gx + log gy) / max(sum G, eps): one more expf an element.  On a
// small map a Gaussian is cut by the edge far more often, so more rows take
// it there.
template <int REG, bool THRESH, class L>
__device__ __forceinline__ void bwd_row_regs(
    const float* __restrict__ raw, const float* __restrict__ targets,
    const float* __restrict__ g_coords, const float* __restrict__ g_reg,
    float* __restrict__ dh, int h_arg, int w_arg, float threshold,
    float inv_sx, float inv_sy, float tvx, float tvy, int n) {
  constexpr bool kGauss = uses_gauss<REG>();
  constexpr bool kIsVar = REG == kVar;
  constexpr int kNs = (kGauss || kIsVar) ? 5 : 3;   // sums of combine 1
  constexpr int kVals = L::kVals;
  const int w = L::kFixed ? 64 : w_arg;
  const int h = L::kFixed ? 64 : h_arg;
  const int hw = h * w;
  extern __shared__ float smem[];  // row_smem_floats a row
  __shared__ float part[2][kWarps][kNs + 1];
  __shared__ float red[kWarps];
  const size_t row = row_index<L>();
  if constexpr (L::kRows > 1) {
    if (row >= static_cast<size_t>(n)) return;   // the whole warp: no barrier
  }
  float* ctab = row_smem<REG, L>(smem, h, w);
  float* gfac = ctab + (L::kStep ? w + h : 0);

  float v[kVals], e[kVals];
  load_row<L>(raw + row * hw, hw, v);
  const float gcx = g_coords[2 * row];
  const float gcy = g_coords[2 * row + 1];
  const float gr = (REG == kNone) ? 0.f : g_reg[row];

  float acc[kNs];
#pragma unroll
  for (int k = 0; k < kNs; ++k) acc[k] = 0.f;
  if constexpr (kGauss) {
    gauss_factors<L>(gfac, targets + 2 * row, h, w, inv_sx, inv_sy, acc);
  }
  coord_table<L>(ctab, h, w);

  // Combine 1: the softmax's max and sums (and the Gaussian's sums); the
  // moments only where they are used (var), bar Map64's unchanged sums.
  float tot[kNs], own;
  const float m = softmax_row<L, THRESH, kIsVar, L::kFixed || kIsVar>(
      v, e, acc, part, ctab, h, w, threshold, tot, &own);
  const float rs = 1.f / tot[0];
  const float zc = own * rs;            // z = e * exp(m_w - M) / S
  float mu_x = 0.f, mu_y = 0.f, cvx = 0.f, cvy = 0.f;
  if constexpr (kIsVar) {
    mu_x = tot[1] * rs;
    mu_y = tot[2] * rs;
    cvx = 2.f * (tot[3] * rs - mu_x * mu_x - tvx);
    cvy = 2.f * (tot[4] * rs - mu_y * mu_y - tvy);
  }
  float rg = 0.f, ls = 0.f;
  if constexpr (kGauss) rg = 1.f / fmaxf(tot[3] * tot[4], kEps);
  if constexpr (REG == kJs || REG == kKl) ls = logf(tot[0]);
  const bool off_grid = rg > 1.f;          // sum G < 1: the contract's form
  [[maybe_unused]] const float log_eps = logf(kEps);
  // The normalized Gaussian at (x, y).
  [[maybe_unused]] auto gauss = [&](int x, int y) {
    return off_grid ? expf(gfac[w + x] + gfac[2 * w + h + y]) * rg
                    : gfac[x] * rg * gfac[2 * w + y];
  };

  // u from the grid coordinates and d = d(reg)/dz.  With no regularizer
  // (d = 0) a stepped layout forms u again from the table for dh rather
  // than hold it across combine 2 (16 registers fewer in Slots<16>).
  auto u_at = [&](float gx, float gy, float d) {
    return gcx * gx + gcy * gy + gr * d;
  };
  constexpr bool kHoldU = !(L::kStep && REG == kNone);

  // u (into v) and z (into e); this thread's share of <z, u>.
  float dot = 0.f;
  Walk<L> pos(w);
#pragma unroll
  for (int k = 0; k < kVals; ++k, pos.next(w)) {
    if constexpr (L::kStep) {
      if (!value_in_row<L>(k, hw)) continue;
    }
    int x, y;
    pos.at(k, w, &x, &y);
    float gx, gy;
    grid_at<L>(ctab, x, y, h, w, &gx, &gy);
    const float z = e[k] * zc;
    float d = 0.f;
    if constexpr (REG == kJs) {
      const float gn = gauss(x, y);
      if (gn == 0.f) {
        d = 0.5f * kLn2;
      } else {
        d = 0.5f * (log_z(v[k], m, ls, z) - logf(0.5f * (z + gn) + kEps));
      }
    } else if constexpr (REG == kKl) {
      const float gn = gauss(x, y);
      const float lgn = (gn == 0.f) ? log_eps : logf(gn + kEps);
      d = log_z(v[k], m, ls, z) - lgn + 1.f;
    } else if constexpr (REG == kMse) {
      const float gn = gauss(x, y);
      d = 2.f * (z - gn) * (1.f / hw);
    } else if constexpr (REG == kVar) {
      d = cvx * (gx * gx - 2.f * mu_x * gx) + cvy * (gy * gy - 2.f * mu_y * gy);
    }
    const float u = u_at(gx, gy, d);
    e[k] = z;
    if constexpr (kHoldU) v[k] = u;
    dot += z * u;
  }

  // Combine 2: <z, u>; then dh = z (u - <z, u>).
  dot = combine_sum<L>(dot, red);
  if constexpr (L::kFixed) {
    float4* out = reinterpret_cast<float4*>(dh + row * hw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * k;
      out[threadIdx.x + kThreads * k] =
          make_float4(e[i] * (v[i] - dot), e[i + 1] * (v[i + 1] - dot),
                      e[i + 2] * (v[i + 2] - dot), e[i + 3] * (v[i + 3] - dot));
    }
  } else {
    float* out = dh + row * hw + row_thread<L>();
    Walk<L> at(w);
#pragma unroll
    for (int k = 0; k < kVals; ++k, at.next(w)) {
      if (!value_in_row<L>(k, hw)) continue;
      float u = 0.f;
      if constexpr (kHoldU) {
        u = v[k];
      } else {
        int x, y;
        at.at(k, w, &x, &y);
        float gx, gy;
        grid_at<L>(ctab, x, y, h, w, &gx, &gy);
        u = u_at(gx, gy, 0.f);
      }
      out[L::kRowThreads * k] = e[k] * (u - dot);
    }
  }
}

// The layout of the backward for rows of more than 4,096 values.
struct StagedRow {
  static constexpr bool kStep = false;
  static constexpr int kRowThreads = kThreads;
  static constexpr int kRows = 1;
};

// The backward's blocks an SM that ptxas is held to (0: no bound, as for
// every layout but Slots<16>).  Left to itself, ptxas
// (nvcc 12.9) caps some Slots<16> instances at 64 registers and spills.
// Held to three blocks an SM (80 registers) none spills; the main path's
// instance (reg none, plain softmax) fits four (64 registers), so that 512
// rows take one wave of the 132 SMs.
template <int REG, bool THRESH, class L>
constexpr int bwd_min_blocks() {
  if constexpr (!std::is_same_v<L, Slots<16>>) return 0;
  return REG == kNone && !THRESH ? 4 : 3;
}

// Backward in layout L (Map64, Slots<S>, WarpRow or StagedRow).  REG is the
// regularizer whose derivative enters u (kNone when the caller has no reg
// cotangent); g_reg is read only then.
template <int REG, bool THRESH, class L>
__global__ void __launch_bounds__(L::kRows * L::kRowThreads,
                                  bwd_min_blocks<REG, THRESH, L>())
dsnt_head_bwd_kernel(const float* __restrict__ raw,
                     const float* __restrict__ targets,
                     const float* __restrict__ g_coords,
                     const float* __restrict__ g_reg, float* __restrict__ dh,
                     int h, int w, float threshold, float inv_sx,
                     float inv_sy, float tvx, float tvy, int n) {
  if constexpr (std::is_same_v<L, StagedRow>) {
    bwd_row_staged<REG, THRESH>(raw, targets, g_coords, g_reg, dh, h, w,
                                threshold, inv_sx, inv_sy, tvx, tvy);
  } else {
    bwd_row_regs<REG, THRESH, L>(raw, targets, g_coords, g_reg, dh, h, w,
                                 threshold, inv_sx, inv_sy, tvx, tvy, n);
  }
}

// Launches kernel over n rows in layout L, kRows rows a block; the kernel's
// last argument is n.
template <class L, typename Kernel, typename... Args>
cudaError_t launch_rows(Kernel kernel, int n, size_t smem, cudaStream_t stream,
                        Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = n / L::kRows + (n % L::kRows != 0);
  kernel<<<blocks, L::kRows * L::kRowThreads, smem, stream>>>(args..., n);
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, REG>, std::bool_constant<THRESH>) for
// the run-time (reg_kind, thresholded) pair.
template <typename F>
cudaError_t dispatch(int reg_kind, int thresholded, F f) {
  auto with_reg = [&](auto reg) {
    return thresholded ? f(reg, std::true_type{}) : f(reg, std::false_type{});
  };
  switch (reg_kind) {
    case kNone: return with_reg(std::integral_constant<int, kNone>{});
    case kJs: return with_reg(std::integral_constant<int, kJs>{});
    case kKl: return with_reg(std::integral_constant<int, kKl>{});
    case kMse: return with_reg(std::integral_constant<int, kMse>{});
    case kVar: return with_reg(std::integral_constant<int, kVar>{});
    default: return cudaErrorInvalidValue;
  }
}

// Calls f(L{}) for the layout of a row of h x w values: Map64 when map64
// (a 64x64 row at the alignment the kernel needs), else the smallest of
// WarpRow, Slots<4> and Slots<16> that holds the row, else Large.
template <class Large, typename F>
cudaError_t with_layout(int h, int w, bool map64, F f) {
  const int hw = h * w;
  if (map64) return f(Map64{});
  if (hw <= row_capacity<WarpRow>()) return f(WarpRow{});
  if (hw <= row_capacity<Slots<4>>()) return f(Slots<4>{});
  if (hw <= row_capacity<Slots<16>>()) return f(Slots<16>{});
  return f(Large{});
}

// Dynamic shared memory of the row-in-registers kernels, for each row of a
// block: the grid coordinates' table (stepped layouts) and the Gaussian's
// factors and their logs (js/kl/mse).
template <int REG, class L>
size_t row_smem_bytes(int h, int w) {
  return L::kRows * static_cast<size_t>(row_smem_floats<REG, L>(h, w)) *
         sizeof(float);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// 64x64 rows at a 16-byte aligned base take Map64; other rows of up to
// 4,096 values WarpRow or Slots<S> (with_layout); larger rows AnyMap.
cudaError_t fwd(const float* raw, const float* targets, float* coords,
                float* reg_out, int n, int h, int w, int reg_kind,
                int thresholded, float threshold, float inv_sx, float inv_sy,
                float tvx, float tvy, cudaStream_t stream) {
  const bool map64 = h == 64 && w == 64 && aligned16(raw);
  return dispatch(reg_kind, thresholded, [&](auto reg, auto thresh) {
    constexpr int REG = decltype(reg)::value;
    constexpr bool TH = decltype(thresh)::value;
    return with_layout<AnyMap>(h, w, map64, [&](auto layout) {
      using L = decltype(layout);
      return launch_rows<L>(dsnt_head_fwd_kernel<REG, TH, L>, n,
                            row_smem_bytes<REG, L>(h, w), stream, raw, targets,
                            coords, reg_out, h, w, threshold, inv_sx, inv_sy,
                            tvx, tvy);
    });
  });
}

// 64x64 rows whose raw and dh both start 16-byte aligned take Map64; other
// rows of up to 4,096 values WarpRow or Slots<S>; larger rows StagedRow
// (the row in 2 * H * W floats of shared memory).
cudaError_t bwd(const float* raw, const float* targets, const float* g_coords,
                const float* g_reg, float* dh, int n, int h, int w,
                int reg_kind, int thresholded, float threshold, float inv_sx,
                float inv_sy, float tvx, float tvy, cudaStream_t stream) {
  const bool map64 = h == 64 && w == 64 && aligned16(raw) && aligned16(dh);
  return dispatch(reg_kind, thresholded, [&](auto reg, auto thresh) {
    constexpr int REG = decltype(reg)::value;
    constexpr bool TH = decltype(thresh)::value;
    return with_layout<StagedRow>(h, w, map64, [&](auto layout) {
      using L = decltype(layout);
      const size_t smem =
          std::is_same_v<L, StagedRow>
              ? static_cast<size_t>(h) * w * sizeof(float) * 2
              : row_smem_bytes<REG, L>(h, w);
      return launch_rows<L>(dsnt_head_bwd_kernel<REG, TH, L>, n, smem, stream,
                            raw, targets, g_coords, g_reg, dh, h, w,
                            threshold, inv_sx, inv_sy, tvx, tvy);
    });
  });
}

bool bad_shape(int n, int h, int w) {
  return n <= 0 || h <= 0 || w <= 0 || h * w > kMaxHw;
}

}  // namespace

extern "C" {

// raw (n, h*w) f32, targets (n, 2) f32 (read only for js/kl/mse),
// coords (n, 2) f32 out, reg_out (n,) f32 out (0 for reg none).
// inv_sx = w / (2 sigma), inv_sy = h / (2 sigma): the Gaussian's grid scale;
// tvx, tvy = (2 sigma / w)^2, (2 sigma / h)^2: the var penalty's targets.
// Returns the cudaError_t of the launch.
int dsnt_head_fwd(const float* raw, const float* targets, float* coords,
                  float* reg_out, int n, int h, int w, int reg_kind,
                  int thresholded, float threshold, float inv_sx,
                  float inv_sy, float tvx, float tvy, cudaStream_t stream) {
  if (bad_shape(n, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fwd(raw, targets, coords, reg_out, n, h, w,
                              reg_kind, thresholded, threshold, inv_sx,
                              inv_sy, tvx, tvy, stream));
}

// raw (n, h*w) f32, targets (n, 2) f32 (read only for js/kl/mse),
// g_coords (n, 2) f32, g_reg (n,) f32 (read unless reg_kind is none),
// dh (n, h*w) f32 out.  Scalars as for dsnt_head_fwd.
int dsnt_head_bwd(const float* raw, const float* targets,
                  const float* g_coords, const float* g_reg, float* dh, int n,
                  int h, int w, int reg_kind, int thresholded, float threshold,
                  float inv_sx, float inv_sy, float tvx, float tvy,
                  cudaStream_t stream) {
  if (bad_shape(n, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bwd(raw, targets, g_coords, g_reg, dh, n, h, w,
                              reg_kind, thresholded, threshold, inv_sx,
                              inv_sy, tvx, tvy, stream));
}

const char* dsnt_head_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
