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
// The forward (redesigned for Hopper; see dsnt_head_fwd_kernel): one
// 256-thread block per row with the row in registers (16 values a thread
// for 64x64, four float4 loads issued together), a compile-time layout for
// the 64x64 map, one expf an element for the softmax, a separable Gaussian
// (W + H expf a row), logs of z and of the Gaussian taken from the logits
// (JS and KL one logf an element), and two barriers (one for none/var).
// The TPU kernels padded rows to 128 lanes with -1e30 logits and 1e4 grid
// coordinates; here loops are bounded by H*W, so any map size up to kMaxHw
// works.
//
// The backward (its first design, to be rebuilt on the forward's layouts):
// one 256-thread block per row; the row is read from device memory once,
// coalesced, into shared memory (16 KiB for a 64x64 map), and every later
// pass (exp, the Gaussian, the derivative) reads shared memory.  Grid
// coordinates are computed from the index, not read.
//
// Block sums use warp shuffles and a fixed order, so results are
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
// Where a thread's values sit in its row:
//   Map64     the flagship's 64x64 map: 16 values a thread as 4 float4; float4
//             number t + 256 k holds x = 4 (t % 16) + q, q = 0..3, of map row
//             y = t / 16 + 16 k.  w and h are compile-time constants, so the
//             grid coordinates come from the thread index by shifts.
//   AnyMap    any map of up to kMaxHw values, 64 a thread: value k of thread
//             t is element t + 256 k (coalesced scalar loads), its (x, y)
//             from a division.  Not on the main path; it spills registers.
struct Map64 {
  static constexpr int kVals = 16;
  static constexpr bool kFixed = true;
};

struct AnyMap {
  static constexpr int kVals = kMaxHw / kThreads;
  static constexpr bool kFixed = false;
};

// Keeps -d^2/2 finite for a target at any distance: 0 * (-inf) would be NaN.
constexpr float kLogFloor = -1e30f;
constexpr float kLn2 = 0.693147180559945309f;

template <class L>
__device__ __forceinline__ bool value_in_row(int k, int hw) {
  if constexpr (L::kFixed) {
    return true;
  } else {
    return static_cast<int>(threadIdx.x) + kThreads * k < hw;
  }
}

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

// The pixel-center coordinate (2 i + 1) / n - 1 of normalized_linspace.
__device__ __forceinline__ float grid_coord(int i, int n) {
  return (2.f * i + 1.f) / n - 1.f;
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
      v[k] = value_in_row<L>(k, hw) ? __ldg(x + threadIdx.x + kThreads * k)
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
template <int NS, int NR>
__device__ __forceinline__ float combine_warps(float (*part)[NS + 1],
                                               const float (&acc)[NS],
                                               float mw, float (&tot)[NS],
                                               float* own) {
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

// One barrier: the sum of v over the block, the same in every thread.
__device__ __forceinline__ float combine_sum(float v, float* red) {
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
// [4] sum e Y^2.  Returns m_w.
template <class L, bool VAR, int NS>
__device__ __forceinline__ float softmax_partials(const float (&v)[L::kVals],
                                                  float (&e)[L::kVals],
                                                  float (&acc)[NS], int h,
                                                  int w, bool filter,
                                                  float threshold) {
  float mt = -INFINITY;
#pragma unroll
  for (int k = 0; k < L::kVals; ++k) {
    if (value_in_row<L>(k, h * w) && !(filter && !(v[k] >= threshold))) {
      mt = fmaxf(mt, v[k]);
    }
  }
  const float mw = warp_max(mt);
#pragma unroll
  for (int k = 0; k < L::kVals; ++k) {
    const bool kept = value_in_row<L>(k, h * w) &&
                      !(filter && !(v[k] >= threshold));
    e[k] = kept ? expf(v[k] - mw) : 0.f;
    int x, y;
    value_xy<L>(k, w, &x, &y);
    const float gx = grid_coord(x, w);
    const float gy = grid_coord(y, h);
    acc[0] += e[k];
    acc[1] += e[k] * gx;
    acc[2] += e[k] * gy;
    if constexpr (VAR) {
      acc[3] += e[k] * gx * gx;
      acc[4] += e[k] * gy * gy;
    }
  }
  return mw;
}

// Forward, one 256-thread block per row, the row held in registers.
//   barrier 1: row max and the sums of e, e X, e Y (and e X^2, e Y^2 for
//              var, or the Gaussian's two factor sums), merged across warps
//              by rescaling each warp's partial with exp(m_w - M);
//   barrier 2: js/kl/mse only, the regularizer's sum.
// A thresholded row that keeps no logit takes one more barrier (the plain
// softmax's partials again).
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
__global__ void __launch_bounds__(kThreads)
dsnt_head_fwd_kernel(const float* __restrict__ raw,
                     const float* __restrict__ targets,
                     float* __restrict__ coords, float* __restrict__ reg_out,
                     int h_arg, int w_arg, float threshold, float inv_sx,
                     float inv_sy, float tvx, float tvy) {
  constexpr bool kGauss = uses_gauss<REG>();
  constexpr bool kIsVar = REG == kVar;
  constexpr int kNs = (kGauss || kIsVar) ? 5 : 3;   // sums of barrier 1
  constexpr int kNr = kGauss ? 3 : kNs;           // of them relative to a max
  constexpr int kVals = L::kVals;
  extern __shared__ float gfac[];  // kGauss: gx[w], log gx, gy[h], log gy
  __shared__ float part[2][kWarps][kNs + 1];
  __shared__ float red[kWarps];
  const int w = L::kFixed ? 64 : w_arg;
  const int h = L::kFixed ? 64 : h_arg;
  const int hw = h * w;
  const size_t row = blockIdx.x;

  float v[kVals], e[kVals];
  load_row<L>(raw + row * hw, hw, v);

  // The Gaussian's factors, each thread a few of the W + H.
  float acc[kNs];
#pragma unroll
  for (int k = 0; k < kNs; ++k) acc[k] = 0.f;
  if constexpr (kGauss) {
    const float tx = targets[2 * row];
    const float ty = targets[2 * row + 1];
    for (int c = threadIdx.x; c < w + h; c += kThreads) {
      const bool is_x = c < w;
      const float d = is_x ? (grid_coord(c, w) - tx) * inv_sx
                           : (grid_coord(c - w, h) - ty) * inv_sy;
      const float l = -0.5f * d * d;
      const float g = expf(l);
      float* f = is_x ? gfac + c : gfac + 2 * w + (c - w);
      f[0] = g;
      f[is_x ? w : h] = fmaxf(l, kLogFloor);
      if (is_x) {
        acc[3] += g;
      } else {
        acc[4] += g;
      }
    }
  }

  // Barrier 1: the softmax's max and sums (and the Gaussian's sums).
  float tot[kNs], own;
  float mw = softmax_partials<L, kIsVar>(v, e, acc, h, w, THRESH, threshold);
  float m = combine_warps<kNs, kNr>(part[0], acc, mw, tot, &own);
  if (THRESH && m == -INFINITY) {
    // No logit reaches the threshold: the plain softmax (the Gaussian's
    // partial sums are kept).
#pragma unroll
    for (int k = 0; k < kNr; ++k) acc[k] = 0.f;
    mw = softmax_partials<L, kIsVar>(v, e, acc, h, w, false, threshold);
    m = combine_warps<kNs, kNr>(part[1], acc, mw, tot, &own);
  }
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
    // Barrier 2: the regularizer against the normalized Gaussian.
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
#pragma unroll
    for (int k = 0; k < kVals; ++k) {
      if (!value_in_row<L>(k, hw)) continue;
      int x, y;
      value_xy<L>(k, w, &x, &y);
      const float z = e[k] * zc;
      const float gn = gxs[x] * rg * gys[y];
      if constexpr (REG == kJs) {
        if (gn == 0.f) {
          // z (log(z + eps) - log(z / 2 + eps)) = z log 2 where eps is
          // absorbed, and under 1e-22 where it is not.
          acc2 += z * kLn2;
        } else {
          const float lz = (v[k] - m) - ls;
          const float lg = (lgx[x] + lgy[y]) - lsg;
          const float lm = logf(0.5f * (z + gn) + kEps);
          acc2 += z * (lz - lm) + gn * (lg - lm);
        }
      } else if constexpr (REG == kKl) {
        const float lgn = (gn == 0.f) ? log_eps : logf(gn + kEps);
        acc2 += z * (((v[k] - m) - ls) - lgn);
      } else {
        acc2 += (z - gn) * (z - gn);
      }
    }
    const float sum = combine_sum(acc2, red);
    regv = (REG == kJs) ? 0.5f * sum : (REG == kMse) ? sum / hw : sum;
  }
  if (threadIdx.x == 0) {
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

// One block per row.  REG is the regularizer whose derivative enters u
// (kNone when the caller has no reg cotangent); g_reg is read only then.
template <int REG, bool THRESH>
__global__ void __launch_bounds__(kThreads)
dsnt_head_bwd_kernel(const float* __restrict__ raw,
                     const float* __restrict__ targets,
                     const float* __restrict__ g_coords,
                     const float* __restrict__ g_reg, float* __restrict__ dh,
                     int h, int w, float threshold, float inv_sx,
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

template <typename Kernel, typename... Args>
cudaError_t launch_rows(Kernel kernel, int n, size_t smem, cudaStream_t stream,
                        Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<n, kThreads, smem, stream>>>(args...);
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

template <int REG, bool THRESH, class L>
cudaError_t launch_fwd(const float* raw, const float* targets, float* coords,
                       float* reg_out, int n, int h, int w, float threshold,
                       float inv_sx, float inv_sy, float tvx, float tvy,
                       cudaStream_t stream) {
  const size_t smem =
      uses_gauss<REG>() ? 2 * static_cast<size_t>(h + w) * sizeof(float) : 0;
  return launch_rows(dsnt_head_fwd_kernel<REG, THRESH, L>, n, smem, stream,
                     raw, targets, coords, reg_out, h, w, threshold, inv_sx,
                     inv_sy, tvx, tvy);
}

// 64x64 rows at a 16-byte aligned base take Map64, every other map (up to
// kMaxHw values) the one generic layout.
cudaError_t fwd(const float* raw, const float* targets, float* coords,
                float* reg_out, int n, int h, int w, int reg_kind,
                int thresholded, float threshold, float inv_sx, float inv_sy,
                float tvx, float tvy, cudaStream_t stream) {
  const bool map64 = h == 64 && w == 64 &&
                     (reinterpret_cast<std::uintptr_t>(raw) & 15) == 0;
  return dispatch(reg_kind, thresholded, [&](auto reg, auto thresh) {
    constexpr int REG = decltype(reg)::value;
    constexpr bool TH = decltype(thresh)::value;
    if (map64) {
      return launch_fwd<REG, TH, Map64>(raw, targets, coords, reg_out, n, h,
                                         w, threshold, inv_sx, inv_sy, tvx,
                                         tvy, stream);
    }
    return launch_fwd<REG, TH, AnyMap>(
        raw, targets, coords, reg_out, n, h, w, threshold, inv_sx, inv_sy, tvx,
        tvy, stream);
  });
}

cudaError_t bwd(const float* raw, const float* targets, const float* g_coords,
                const float* g_reg, float* dh, int n, int h, int w,
                int reg_kind, int thresholded, float threshold, float inv_sx,
                float inv_sy, float tvx, float tvy, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(h) * w * sizeof(float) * 2;
  return dispatch(reg_kind, thresholded, [&](auto reg, auto thresh) {
    return launch_rows(
        dsnt_head_bwd_kernel<decltype(reg)::value, decltype(thresh)::value>, n,
        smem, stream, raw, targets, g_coords, g_reg, dh, h, w, threshold,
        inv_sx, inv_sy, tvx, tvy);
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
