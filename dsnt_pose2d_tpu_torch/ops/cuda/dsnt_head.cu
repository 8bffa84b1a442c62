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
// What bounds it: bytes.  Each raw value is read once from device memory
// (4 bytes; the backward also writes 4) and costs ~10-30 flops and one to
// three transcendentals, below the H100's ~20 flops per byte of fp32
// balance.  Design: one 256-thread block per row; the row is read from
// device memory once, coalesced, into shared memory (16 KiB for a 64x64
// map), and every later pass (exp, the Gaussian, the regularizer and its
// derivative) reads shared memory.  The TPU kernels padded rows to 128 lanes
// with -1e30 logits and 1e4 grid coordinates; here loops are bounded by H*W,
// so any map size up to kMaxHw works.  Grid coordinates are computed from
// the index, not read.  Block sums use warp shuffles and a fixed warp order,
// so results are deterministic run to run.

#include <cuda_runtime.h>
#include <math.h>

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

template <int REG, bool THRESH>
__global__ void __launch_bounds__(kThreads)
dsnt_head_fwd_kernel(const float* __restrict__ raw,
                     const float* __restrict__ targets,
                     float* __restrict__ coords, float* __restrict__ reg_out,
                     int h, int w, float threshold, float inv_sx,
                     float inv_sy, float tvx, float tvy) {
  constexpr bool kGauss = uses_gauss<REG>();
  extern __shared__ float smem[];
  __shared__ float red[kWarps * 5];
  const int hw = h * w;
  float* e = smem;            // logits, then exp(h - m)
  float* g = smem + hw;       // unnormalized target Gaussian (kGauss only)
  const float* x = raw + static_cast<size_t>(blockIdx.x) * hw;

  // Pass 0: stage the row; the softmax's shift.
  bool filter;
  const float m = stage_row<THRESH>(x, e, hw, threshold, red, &filter);

  // Pass 1: e = exp(h - m); sums of e, e*X, e*Y and either the Gaussian's
  // sum (js/kl/mse) or e*X^2, e*Y^2 (var).
  float tx = 0.f, ty = 0.f;
  if (kGauss) {
    tx = targets[2 * blockIdx.x] * inv_sx;
    ty = targets[2 * blockIdx.x + 1] * inv_sy;
  }
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    const float ev = softmax_weight(e[i], m, filter, threshold);
    e[i] = ev;
    float gx, gy;
    grid_xy(i, h, w, &gx, &gy);
    acc[0] += ev;
    acc[1] += ev * gx;
    acc[2] += ev * gy;
    if (kGauss) {
      const float dx = gx * inv_sx - tx;
      const float dy = gy * inv_sy - ty;
      const float gv = expf(-0.5f * (dx * dx + dy * dy));
      g[i] = gv;
      acc[3] += gv;
    }
    if (REG == kVar) {
      acc[3] += ev * gx * gx;
      acc[4] += ev * gy * gy;
    }
  }
  block_sum<5>(acc, red);
  const float rs = 1.f / acc[0];
  const float cx = acc[1] * rs;
  const float cy = acc[2] * rs;

  float regv = 0.f;
  if (REG == kVar) {
    const float var_x = acc[3] * rs - cx * cx;
    const float var_y = acc[4] * rs - cy * cy;
    regv = (var_x - tvx) * (var_x - tvx) + (var_y - tvy) * (var_y - tvy);
  }
  if (kGauss) {
    // Pass 2: the regularizer against the normalized Gaussian.
    const float rg = 1.f / fmaxf(acc[3], kEps);
    float part[1] = {0.f};
    for (int i = threadIdx.x; i < hw; i += kThreads) {
      const float z = e[i] * rs;
      const float gn = g[i] * rg;
      if (REG == kJs) {
        const float lm = logf(0.5f * (z + gn) + kEps);
        part[0] += z * (logf(z + kEps) - lm) + gn * (logf(gn + kEps) - lm);
      } else if (REG == kKl) {
        part[0] += z * (logf(z + kEps) - logf(gn + kEps));
      } else {
        part[0] += (z - gn) * (z - gn);
      }
    }
    block_sum<1>(part, red);
    regv = (REG == kJs) ? 0.5f * part[0]
         : (REG == kMse) ? part[0] / hw : part[0];
  }
  if (threadIdx.x == 0) {
    coords[2 * blockIdx.x] = cx;
    coords[2 * blockIdx.x + 1] = cy;
    reg_out[blockIdx.x] = regv;
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

cudaError_t fwd(const float* raw, const float* targets, float* coords,
                float* reg_out, int n, int h, int w, int reg_kind,
                int thresholded, float threshold, float inv_sx, float inv_sy,
                float tvx, float tvy, cudaStream_t stream) {
  return dispatch(reg_kind, thresholded, [&](auto reg, auto thresh) {
    constexpr int REG = decltype(reg)::value;
    const size_t smem = static_cast<size_t>(h) * w * sizeof(float)
                        * (uses_gauss<REG>() ? 2 : 1);
    return launch_rows(dsnt_head_fwd_kernel<REG, decltype(thresh)::value>, n,
                       smem, stream, raw, targets, coords, reg_out, h, w,
                       threshold, inv_sx, inv_sy, tvx, tvy);
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
