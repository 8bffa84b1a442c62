// Train-mode BatchNorm with an optional ReLU epilogue for Hopper (sm_90a):
// flax's nn.BatchNorm(momentum=0.9, epsilon=1e-5) as the JAX package trains
// it, forward and backward.
//
// Replaces no Pallas kernel: the JAX package leaves train-mode BN to XLA,
// which fuses it.  The port wrote it as a composition of ~20 torch ops
// forward and ~30 backward, each a pass over fp32 temporaries; that
// composition took most of the device time of the ResNet-50 2x train step
// and most of the hg8 step's launches.
//
// Per channel c over the N*H*W values x of the input dtype T (bf16, fp16
// or fp32), in fp32:
//
//   mean = S1 / n, mean2 = S2 / n        (S1 = sum x, S2 = sum x^2, n = count)
//   d = mean2 - mean^2, var = max(d, 0), rstd = rsqrt(var + eps)
//   y = (x - mean) * (w * rstd) + b, rounded to T, then ReLU if asked
//   running <- 0.9 running + 0.1 (mean, var)
//
// and the exact gradient of that formula, with g = dy masked by the ReLU
// (recomputed from x: the output > 0 after rounding to T, as torch's
// threshold_backward reads it) and xhat = (x - mean) * rstd:
//
//   dbias = sum g, dweight = sum g xhat
//   dx = w rstd (g - sum g / n - [d >= 0] xhat sum(g xhat) / n)
//
// ([d >= 0] is the mask of torch's clamp_min backward.)  Every product and
// sum of the per-element formulas is written with the _rn intrinsics, so
// the forward and the backward recompute bitwise the same y, and nvcc
// contracts nothing into an FMA.
//
// Four kernels, two a pass:
//   bn_stats_kernel   reads x, writes [S1, S2]
//   bn_fwd_kernel     reads x, writes y and moves the running statistics
//   bn_dstats_kernel  reads x, dy, writes [sum g, sum g xhat], dbias, dweight
//   bn_bwd_kernel     reads x, dy, writes dx
// Under a data axis of several ranks the wrapper all-reduces [S1, S2] and
// [sum g, sum g xhat] between a pass's two kernels.
//
// What bounds them: bytes.  The least traffic is x read and y written
// forward, x and dy read and dx written backward (4 and 6 bytes a bf16
// value); each reduce kernel reads x (and dy) once more, 10 bytes of reads
// and writes beside that.  Design:
//
// - Two layouts, read where they lie, no copy: NCHW planes (a channel is N
//   runs of H*W values) and channels-last rows (an (N*H*W, C) matrix).
//   Loads and stores are 16-byte vectors (8 bf16/fp16 values, 4 fp32)
//   along H*W in planes and along C in rows, when the run length is a
//   multiple of the vector and the pointers are 16-byte aligned; otherwise
//   every access is scalar (the wrapper picks, VEC = 1).
// - The grid is (chunks, tiles): a tile is one channel in planes and TX
//   vectors of channels in rows (TX a power of two up to 32, so a warp
//   reads 512 contiguous bytes); chunks split the channel's values so
//   that the grid fills the SMs (the wrapper sizes them from the shape).
// - A reduce kernel's blocks write per-chunk partial sums; the last block
//   of a tile to finish (an integer counter, reset by that block) adds
//   them in chunk order.  No float atomics: a run repeats bitwise.  With
//   one chunk the block writes the sums itself.
// - Each thread keeps UNROLL independent 16-byte loads in flight.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kPlanes = 0;
constexpr int kRows = 1;

struct Args {
  const void* x;
  const void* dy;
  void* out;               // y (forward) or dx (backward)
  const float* tot;        // [S1 | S2], 2C
  const float* dtot;       // [sum g | sum g xhat], 2C
  const float* w;
  const float* b;
  float* rmean;            // null: leave the running statistics
  float* rvar;
  float keep_old, keep_new;
  float* part;             // [chunks][2][C] partial sums
  unsigned* counters;      // one per tile, zero between launches
  float* tot_out;          // [2][C] sums of a reduce kernel
  float* dw;
  float* db;
  int n, c, hw, chunks, tx;
  float count, eps;
  int relu;
};

// -- element types ----------------------------------------------------------

template <typename T> struct Elem;

template <> struct Elem<float> {
  static __device__ __forceinline__ float in(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float out(float v) { return v; }
};

template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float in(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <> struct Elem<__half> {
  static __device__ __forceinline__ float in(__half v) { return __half2float(v); }
  static __device__ __forceinline__ float round(float v) {
    return __half2float(__float2half_rn(v));
  }
  static __device__ __forceinline__ __half out(float v) { return __float2half_rn(v); }
};

// V consecutive values of T at p (16-byte aligned when V * sizeof(T) == 16).
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        T lo, hi;
        const unsigned short l = static_cast<unsigned short>(w[i] & 0xffffu);
        const unsigned short h = static_cast<unsigned short>(w[i] >> 16);
        if constexpr (std::is_same_v<T, __nv_bfloat16>) {
          lo = __ushort_as_bfloat16(l);
          hi = __ushort_as_bfloat16(h);
        } else {
          lo = __ushort_as_half(l);
          hi = __ushort_as_half(h);
        }
        f[2 * i] = Elem<T>::in(lo);
        f[2 * i + 1] = Elem<T>::in(hi);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = Elem<T>::in(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint32_t w[4];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(f[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned short lo, hi;
        if constexpr (std::is_same_v<T, __nv_bfloat16>) {
          lo = __bfloat16_as_ushort(Elem<T>::out(f[2 * i]));
          hi = __bfloat16_as_ushort(Elem<T>::out(f[2 * i + 1]));
        } else {
          lo = __half_as_ushort(Elem<T>::out(f[2 * i]));
          hi = __half_as_ushort(Elem<T>::out(f[2 * i + 1]));
        }
        w[i] = static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = Elem<T>::out(f[i]);
  }
}

// -- per-channel constants and per-element formulas --------------------------

struct Chan {
  float mean, rstd, mul, bias, var, keep;   // keep: [d >= 0]
  float ga, gk;                             // sum g / n, keep sum(g xhat) / n
};

// The forward's constants of channel c from its sums (and, with dtot, the
// backward's); every kernel computes them the same way.
__device__ __forceinline__ Chan channel(const Args& a, int c, bool grads) {
  Chan ch;
  ch.mean = __fdiv_rn(a.tot[c], a.count);
  const float mean2 = __fdiv_rn(a.tot[a.c + c], a.count);
  const float d = __fsub_rn(mean2, __fmul_rn(ch.mean, ch.mean));
  ch.var = d < 0.f ? 0.f : d;             // NaN stays NaN, as clamp_min
  ch.keep = d >= 0.f ? 1.f : 0.f;
  ch.rstd = rsqrtf(__fadd_rn(ch.var, a.eps));
  ch.mul = __fmul_rn(ch.rstd, a.w[c]);
  ch.bias = a.b[c];
  ch.ga = ch.gk = 0.f;
  if (grads) {
    ch.ga = __fdiv_rn(a.dtot[c], a.count);
    ch.gk = __fmul_rn(ch.keep, __fdiv_rn(a.dtot[a.c + c], a.count));
  }
  return ch;
}

// y before the ReLU, rounded to T (the value the forward stores and the
// backward's ReLU mask reads).
template <typename T>
__device__ __forceinline__ float y_of(float x, const Chan& ch) {
  return Elem<T>::round(
      __fadd_rn(__fmul_rn(__fsub_rn(x, ch.mean), ch.mul), ch.bias));
}

__device__ __forceinline__ float xhat_of(float x, const Chan& ch) {
  return __fmul_rn(__fsub_rn(x, ch.mean), ch.rstd);
}

// dy masked by the ReLU (NaN > 0 is false: threshold_backward's mask).
template <typename T>
__device__ __forceinline__ float g_of(float x, float dy, const Chan& ch, bool relu) {
  return (!relu || y_of<T>(x, ch) > 0.f) ? dy : 0.f;
}

// -- block reductions --------------------------------------------------------

// Sum over the block of one value per thread, in a fixed order; the result
// in every thread.  `red` holds kThreads / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                        // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) s += red[i];
  return s;
}

// The block's sums of one tile, vals[s * W + j] (stat s, channel c0 + j,
// j < nct), written out: directly with one chunk, else as a partial, and
// the tile's last block adds the partials in chunk order.  `red` holds
// kThreads floats.  DSTATS also writes dbias (stat 0) and dweight (stat 1).
template <bool DSTATS>
__device__ void finish(const Args& a, const float* vals, int W, int c0, int nct,
                       int tile, float* red) {
  const int tid = threadIdx.x;
  auto emit = [&](int s, int j, float v) {
    const int c = c0 + j;
    a.tot_out[s * a.c + c] = v;
    if (DSTATS) {
      float* g = s == 0 ? a.db : a.dw;
      if (g) g[c] = v;
    }
  };
  if (a.chunks == 1) {
    for (int p = tid; p < 2 * W; p += kThreads) {
      if (p % W < nct) emit(p / W, p % W, vals[p]);
    }
    return;
  }
  const int k = blockIdx.x;
  for (int p = tid; p < 2 * W; p += kThreads) {
    const int s = p / W, j = p % W;
    if (j < nct) a.part[(static_cast<long long>(k) * 2 + s) * a.c + c0 + j] = vals[p];
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (tid == 0) last = atomicAdd(&a.counters[tile], 1u) == static_cast<unsigned>(a.chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // P = 2W pairs (stat, channel), a power of two up to kThreads; G groups
  // of threads split the chunks, then a fixed tree adds the groups.
  const int P = 2 * W, G = kThreads / P;
  const int p = tid % P, q = tid / P;
  const int s = p / W, j = p % W;
  float acc = 0.f;
  if (j < nct) {
    const float* src = a.part + static_cast<long long>(s) * a.c + c0 + j;
#pragma unroll 16
    for (int kk = q; kk < a.chunks; kk += G) {
      acc += __ldcg(src + static_cast<long long>(kk) * 2 * a.c);
    }
  }
  red[tid] = acc;
  __syncthreads();
  for (int st = G >> 1; st > 0; st >>= 1) {
    if (q < st) red[q * P + p] += red[(q + st) * P + p];
    __syncthreads();
  }
  if (q == 0 && j < nct) emit(s, j, red[p]);
  if (tid == 0) a.counters[tile] = 0u;
}

// -- reduce kernels: stats (MODE 0) and dstats (MODE 1) ----------------------

template <int MODE> struct ReduceUnroll { static constexpr int value = MODE == 0 ? 4 : 2; };

template <typename T, int V, int MODE>
__device__ void reduce_planes(const Args& a) {
  constexpr int U = ReduceUnroll<MODE>::value;
  __shared__ float red[kThreads];
  __shared__ float vals[2];
  const int c = blockIdx.y;
  const unsigned hwv = static_cast<unsigned>(a.hw / V);
  const unsigned nv = static_cast<unsigned>(a.n) * hwv;
  const unsigned per = (nv + a.chunks - 1) / a.chunks;
  const unsigned lo = blockIdx.x * per;
  const unsigned hi = min(nv, lo + per);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  Chan ch;
  if (MODE == 1) ch = channel(a, c, false);
  float s0 = 0.f, s1 = 0.f;
  for (unsigned i0 = lo + threadIdx.x; i0 < hi; i0 += U * kThreads) {
    float f[U][V], g[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned i = i0 + u * kThreads;
      if (i < hi) {
        const unsigned nn = i / hwv;
        const unsigned sp = i - nn * hwv;
        const long long off =
            (static_cast<long long>(nn) * a.c + c) * a.hw + static_cast<long long>(sp) * V;
        load<T, V>(x + off, f[u]);
        if (MODE == 1) load<T, V>(dy + off, g[u]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) f[u][e] = g[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (MODE == 0) {
          s0 += f[u][e];
          s1 = __fmaf_rn(f[u][e], f[u][e], s1);
        } else {
          const float gg = g_of<T>(f[u][e], g[u][e], ch, a.relu);
          s0 += gg;
          s1 = __fmaf_rn(gg, xhat_of(f[u][e], ch), s1);
        }
      }
    }
  }
  s0 = block_sum(s0, red);
  s1 = block_sum(s1, red);
  if (threadIdx.x == 0) {
    vals[0] = s0;
    vals[1] = s1;
  }
  __syncthreads();
  finish<MODE == 1>(a, vals, 1, c, 1, c, red);
}

template <typename T, int V, int MODE>
__device__ void reduce_rows(const Args& a) {
  constexpr int U = ReduceUnroll<MODE>::value;
  __shared__ float red[2 * kThreads * V];
  __shared__ float vals[2 * 32 * V];
  const int TX = a.tx, TY = kThreads / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int tile = blockIdx.y;
  const int W = TX * V;
  const int c0 = tile * W;
  const int nct = min(W, a.c - c0);
  const int cv = tile * TX + tx;
  const bool active = cv * V < a.c;
  const int rows = a.n * a.hw;
  const int per = (rows + a.chunks - 1) / a.chunks;
  const int lo = blockIdx.x * per;
  const int hi = min(rows, lo + per);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  Chan ch[MODE == 1 ? V : 1];
  if (MODE == 1 && active) {
#pragma unroll
    for (int e = 0; e < (MODE == 1 ? V : 1); ++e) ch[e] = channel(a, cv * V + e, false);
  }
  float s0[V], s1[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s0[e] = s1[e] = 0.f;
  if (active) {
    for (int r0 = lo + ty; r0 < hi; r0 += U * TY) {
      float f[U][V], g[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * TY;
        if (r < hi) {
          const long long off = static_cast<long long>(r) * a.c + cv * V;
          load<T, V>(x + off, f[u]);
          if (MODE == 1) load<T, V>(dy + off, g[u]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) f[u][e] = g[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (MODE == 0) {
            s0[e] += f[u][e];
            s1[e] = __fmaf_rn(f[u][e], f[u][e], s1[e]);
          } else {
            const Chan& cc = ch[MODE == 1 ? e : 0];
            const float gg = g_of<T>(f[u][e], g[u][e], cc, a.relu);
            s0[e] += gg;
            s1[e] = __fmaf_rn(gg, xhat_of(f[u][e], cc), s1[e]);
          }
        }
      }
    }
  }
  // Over the block's rows, a fixed tree over ty: thread (ty, tx) holds its
  // V channels of stat s at red[s * kThreads * V + ty * W + tx * V + e].
  float* r0 = red + threadIdx.x * V;
  float* r1 = r0 + kThreads * V;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    r0[e] = s0[e];
    r1[e] = s1[e];
  }
  __syncthreads();
  for (int st = TY >> 1; st > 0; st >>= 1) {
    if (ty < st) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        r0[e] += r0[st * W + e];
        r1[e] += r1[st * W + e];
      }
    }
    __syncthreads();
  }
  if (ty == 0) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      vals[tx * V + e] = r0[e];
      vals[W + tx * V + e] = r1[e];
    }
  }
  __syncthreads();
  finish<MODE == 1>(a, vals, W, c0, nct, tile, red);
}

// -- elementwise kernels: normalise (MODE 0) and dx (MODE 1) -----------------

template <int MODE> struct MapUnroll { static constexpr int value = MODE == 0 ? 4 : 2; };

template <typename T, int V, int MODE>
__device__ __forceinline__ void map_vec(T* out, long long off, const Chan* ch, int stride_ch,
                                        bool relu, const float (&f)[V], const float (&g)[V]) {
  float o[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const Chan& cc = ch[e * stride_ch];
    if (MODE == 0) {
      const float y = y_of<T>(f[e], cc);
      o[e] = (relu && y <= 0.f) ? 0.f : y;
    } else {
      const float gg = g_of<T>(f[e], g[e], cc, relu);
      o[e] = __fmul_rn(cc.mul, __fsub_rn(__fsub_rn(gg, cc.ga),
                                         __fmul_rn(xhat_of(f[e], cc), cc.gk)));
    }
  }
  store<T, V>(out + off, o);
}

__device__ __forceinline__ void move_running(const Args& a, int c, const Chan& ch) {
  a.rmean[c] = __fadd_rn(__fmul_rn(a.keep_old, a.rmean[c]), __fmul_rn(a.keep_new, ch.mean));
  a.rvar[c] = __fadd_rn(__fmul_rn(a.keep_old, a.rvar[c]), __fmul_rn(a.keep_new, ch.var));
}

template <typename T, int V, int MODE>
__device__ void map_planes(const Args& a) {
  constexpr int U = MapUnroll<MODE>::value;
  const int c = blockIdx.y;
  const unsigned hwv = static_cast<unsigned>(a.hw / V);
  const unsigned nv = static_cast<unsigned>(a.n) * hwv;
  const unsigned per = (nv + a.chunks - 1) / a.chunks;
  const unsigned lo = blockIdx.x * per;
  const unsigned hi = min(nv, lo + per);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* out = static_cast<T*>(a.out);
  const Chan ch = channel(a, c, MODE == 1);
  if (MODE == 0 && a.rmean && blockIdx.x == 0 && threadIdx.x == 0) move_running(a, c, ch);
  for (unsigned i0 = lo + threadIdx.x; i0 < hi; i0 += U * kThreads) {
    float f[U][V], g[U][V];
    long long off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned i = i0 + u * kThreads;
      off[u] = -1;
      if (i < hi) {
        const unsigned nn = i / hwv;
        const unsigned sp = i - nn * hwv;
        off[u] = (static_cast<long long>(nn) * a.c + c) * a.hw + static_cast<long long>(sp) * V;
        load<T, V>(x + off[u], f[u]);
        if (MODE == 1) load<T, V>(dy + off[u], g[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (off[u] >= 0) map_vec<T, V, MODE>(out, off[u], &ch, 0, a.relu, f[u], g[u]);
    }
  }
}

template <typename T, int V, int MODE>
__device__ void map_rows(const Args& a) {
  constexpr int U = MapUnroll<MODE>::value;
  const int TX = a.tx, TY = kThreads / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int cv = blockIdx.y * TX + tx;
  if (cv * V >= a.c) return;
  const int rows = a.n * a.hw;
  const int per = (rows + a.chunks - 1) / a.chunks;
  const int lo = blockIdx.x * per;
  const int hi = min(rows, lo + per);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* out = static_cast<T*>(a.out);
  Chan ch[V];
#pragma unroll
  for (int e = 0; e < V; ++e) ch[e] = channel(a, cv * V + e, MODE == 1);
  if (MODE == 0 && a.rmean && blockIdx.x == 0 && ty == 0) {
#pragma unroll
    for (int e = 0; e < V; ++e) move_running(a, cv * V + e, ch[e]);
  }
  for (int r0 = lo + ty; r0 < hi; r0 += U * TY) {
    float f[U][V], g[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * TY;
      if (r < hi) {
        const long long off = static_cast<long long>(r) * a.c + cv * V;
        load<T, V>(x + off, f[u]);
        if (MODE == 1) load<T, V>(dy + off, g[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * TY;
      if (r < hi) {
        map_vec<T, V, MODE>(out, static_cast<long long>(r) * a.c + cv * V, ch, 1, a.relu,
                            f[u], g[u]);
      }
    }
  }
}

// The four kernels (their names are what a profile shows: one bn_fwd_kernel
// and one bn_bwd_kernel a call, as the wrapper counts).

template <typename T, int V, int L>
__global__ void __launch_bounds__(kThreads) bn_stats_kernel(const Args a) {
  if constexpr (L == kPlanes) reduce_planes<T, V, 0>(a);
  else reduce_rows<T, V, 0>(a);
}

template <typename T, int V, int L>
__global__ void __launch_bounds__(kThreads) bn_fwd_kernel(const Args a) {
  if constexpr (L == kPlanes) map_planes<T, V, 0>(a);
  else map_rows<T, V, 0>(a);
}

template <typename T, int V, int L>
__global__ void __launch_bounds__(kThreads) bn_dstats_kernel(const Args a) {
  if constexpr (L == kPlanes) reduce_planes<T, V, 1>(a);
  else reduce_rows<T, V, 1>(a);
}

template <typename T, int V, int L>
__global__ void __launch_bounds__(kThreads) bn_bwd_kernel(const Args a) {
  if constexpr (L == kPlanes) map_planes<T, V, 1>(a);
  else map_rows<T, V, 1>(a);
}

enum Kind { kStats = 0, kFwd = 1, kDstats = 2, kBwd = 3 };

template <typename T, int V, int L>
void launch_kind(int kind, const Args& a, dim3 grid, cudaStream_t st) {
  switch (kind) {
    case kStats: bn_stats_kernel<T, V, L><<<grid, kThreads, 0, st>>>(a); break;
    case kFwd: bn_fwd_kernel<T, V, L><<<grid, kThreads, 0, st>>>(a); break;
    case kDstats: bn_dstats_kernel<T, V, L><<<grid, kThreads, 0, st>>>(a); break;
    default: bn_bwd_kernel<T, V, L><<<grid, kThreads, 0, st>>>(a); break;
  }
}

template <typename T>
int launch_type(int kind, int layout, int vec, const Args& a, dim3 grid, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec != 1 && vec != kVec) return static_cast<int>(cudaErrorInvalidValue);
  if (layout == kPlanes) {
    if (vec == 1) launch_kind<T, 1, kPlanes>(kind, a, grid, st);
    else launch_kind<T, kVec, kPlanes>(kind, a, grid, st);
  } else {
    if (vec == 1) launch_kind<T, 1, kRows>(kind, a, grid, st);
    else launch_kind<T, kVec, kRows>(kind, a, grid, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch, as the wrapper fills it (ctypes.Structure ``_Launch`` of
// batch_norm.py, field for field): kind 0 stats, 1 fwd, 2 dstats, 3 bwd,
// over x of shape (n, c, hw) in `layout` (0 NCHW planes, 1 channels-last
// rows), dtype 0 fp32, 1 bf16, 2 fp16, `vec` values a load (1 or 16 bytes'
// worth); the grid is (chunks, tiles): tiles = c in planes, ceil(c / vec /
// tx) in rows.  Pointers a kernel does not use may be null.
struct Launch {
  const void* x;
  const void* dy;
  void* out;
  const float* tot;
  const float* dtot;
  const float* w;
  const float* b;
  float* rmean;
  float* rvar;
  float* part;
  unsigned* counters;
  float* tot_out;
  float* dw;
  float* db;
  int kind, dtype, layout, vec, tx, n, c, hw, chunks, relu;
  float count, eps, keep_old, keep_new;
};

// Returns the cudaError_t of the launch.
int bn_train(const Launch* l, cudaStream_t stream) {
  const int layout = l->layout, vec = l->vec, tx = l->tx, kind = l->kind;
  const int n = l->n, c = l->c, hw = l->hw, chunks = l->chunks;
  if (kind < kStats || kind > kBwd || n <= 0 || c <= 0 || hw <= 0 || chunks <= 0 ||
      chunks > 65535 || (layout != kPlanes && layout != kRows) || vec <= 0 ||
      (layout == kPlanes ? hw % vec : c % vec) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool reduce = kind == kStats || kind == kDstats;
  if (reduce && (l->tot_out == nullptr ||
                 (chunks > 1 && (l->part == nullptr || l->counters == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (layout == kRows && (tx <= 0 || tx > 32 || (tx & (tx - 1)) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{l->x, l->dy, l->out, l->tot, l->dtot, l->w, l->b, l->rmean, l->rvar,
         l->keep_old, l->keep_new, l->part, l->counters, l->tot_out, l->dw, l->db,
         n, c, hw, chunks, layout == kPlanes ? 1 : tx, l->count, l->eps, l->relu};
  const int tiles = layout == kPlanes ? c : (c / vec + tx - 1) / tx;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(tiles));
  switch (l->dtype) {
    case 0: return launch_type<float>(kind, layout, vec, a, grid, stream);
    case 1: return launch_type<__nv_bfloat16>(kind, layout, vec, a, grid, stream);
    case 2: return launch_type<__half>(kind, layout, vec, a, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* bn_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
