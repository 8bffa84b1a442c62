// Fused DSNT-head forward for Hopper (sm_90a): flat softmax (plain or
// thresholded) + DSNT coordinate expectation + distribution regularizer, in
// one pass over the raw heatmaps.
//
// Replaces the TPU kernel dsnt_pose2d_tpu/ops/pallas/dsnt_head.py::_fwd_kernel
// (called through _fwd_call).  Contract per row r (one joint heatmap, H*W
// values flattened row-major):
//
//   m = max(h);  e = exp(h - m);  s = sum(e);  z = e / s
//   x = <z, X>;  y = <z, Y>          X, Y: pixel-center grid (2i+1)/L - 1
//   G = exp(-((X-tx)^2/sx^2 + (Y-ty)^2/sy^2)/2) / max(sum, 1e-24)
//   reg = JS(z||G) | KL(z||G) | MSE(z,G) | variance penalty | none
//
// Thresholded softmax drops logits below the threshold (weight 0); a row
// with every logit below it falls back to the plain softmax.  Logs stay in
// subtraction form log(p + eps) - log(q + eps), eps = 1e-24, as in the JAX
// package's ops/losses.py.  No fast-math: full-precision expf/logf and IEEE
// division, denormals kept.
//
// What bounds it: bytes.  Each raw value is read once from device memory
// (4 bytes) and costs ~10-20 flops and one or two transcendentals, far below
// the H100's ~20 flops per byte of fp32 balance.  Design: one 256-thread
// block per row; the row is read from device memory once, coalesced, into
// shared memory (16 KiB for a 64x64 map), and every later pass (exp, the
// Gaussian, the regularizer sum) reads shared memory.  The TPU kernel padded
// rows to 128 lanes with -1e30 logits and 1e4 grid coordinates; here loops
// are bounded by H*W, so any map size up to kMaxHw works.  Grid coordinates
// are computed from the index, not read.  Block sums use warp shuffles and a
// fixed warp order, so results are deterministic run to run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-24f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHw = 16384;  // MAX_HW in dsnt_head.py checks it first

enum RegKind { kNone = 0, kJs = 1, kKl = 2, kMse = 3, kVar = 4 };

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

template <int REG, bool THRESH>
__global__ void __launch_bounds__(kThreads)
dsnt_head_fwd_kernel(const float* __restrict__ raw,
                     const float* __restrict__ targets,
                     float* __restrict__ coords, float* __restrict__ reg_out,
                     int h, int w, float threshold, float inv_sx,
                     float inv_sy, float tvx, float tvy) {
  constexpr bool kGauss = (REG == kJs || REG == kKl || REG == kMse);
  extern __shared__ float smem[];
  __shared__ float red[kWarps * 5];
  const int hw = h * w;
  float* e = smem;            // logits, then exp(h - m)
  float* g = smem + hw;       // unnormalized target Gaussian (kGauss only)
  const float* x = raw + static_cast<size_t>(blockIdx.x) * hw;

  // Pass 0: stage the row; row max (and the max over kept logits).
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
  const bool filter = THRESH && mx[2] > 0.f;
  const float m = filter ? mx[1] : mx[0];

  // Pass 1: e = exp(h - m); sums of e, e*X, e*Y and either the Gaussian's
  // sum (js/kl/mse) or e*X^2, e*Y^2 (var).
  float tx = 0.f, ty = 0.f;
  if (kGauss) {
    tx = targets[2 * blockIdx.x] * inv_sx;
    ty = targets[2 * blockIdx.x + 1] * inv_sy;
  }
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    const float v = e[i];
    const float ev = (filter && !(v >= threshold)) ? 0.f : expf(v - m);
    e[i] = ev;
    const int r = i / w;
    const int c = i - r * w;
    const float gx = (2.f * c + 1.f) / w - 1.f;
    const float gy = (2.f * r + 1.f) / h - 1.f;
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

template <int REG, bool THRESH>
cudaError_t launch(const float* raw, const float* targets, float* coords,
                   float* reg_out, int n, int h, int w, float threshold,
                   float inv_sx, float inv_sy, float tvx, float tvy,
                   cudaStream_t stream) {
  constexpr bool kGauss = (REG == kJs || REG == kKl || REG == kMse);
  const size_t smem = static_cast<size_t>(h) * w * sizeof(float) * (kGauss ? 2 : 1);
  auto kernel = dsnt_head_fwd_kernel<REG, THRESH>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<n, kThreads, smem, stream>>>(raw, targets, coords, reg_out, h, w,
                                        threshold, inv_sx, inv_sy, tvx, tvy);
  return cudaGetLastError();
}

template <int REG>
cudaError_t launch_preact(int thresholded, const float* raw,
                          const float* targets, float* coords, float* reg_out,
                          int n, int h, int w, float threshold, float inv_sx,
                          float inv_sy, float tvx, float tvy,
                          cudaStream_t stream) {
  if (thresholded) {
    return launch<REG, true>(raw, targets, coords, reg_out, n, h, w,
                             threshold, inv_sx, inv_sy, tvx, tvy, stream);
  }
  return launch<REG, false>(raw, targets, coords, reg_out, n, h, w,
                            threshold, inv_sx, inv_sy, tvx, tvy, stream);
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
  if (n <= 0 || h <= 0 || w <= 0 || h * w > kMaxHw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (reg_kind) {
    case kNone:
      err = launch_preact<kNone>(thresholded, raw, targets, coords, reg_out,
                                 n, h, w, threshold, inv_sx, inv_sy, tvx, tvy,
                                 stream);
      break;
    case kJs:
      err = launch_preact<kJs>(thresholded, raw, targets, coords, reg_out, n,
                               h, w, threshold, inv_sx, inv_sy, tvx, tvy,
                               stream);
      break;
    case kKl:
      err = launch_preact<kKl>(thresholded, raw, targets, coords, reg_out, n,
                               h, w, threshold, inv_sx, inv_sy, tvx, tvy,
                               stream);
      break;
    case kMse:
      err = launch_preact<kMse>(thresholded, raw, targets, coords, reg_out,
                                n, h, w, threshold, inv_sx, inv_sy, tvx, tvy,
                                stream);
      break;
    case kVar:
      err = launch_preact<kVar>(thresholded, raw, targets, coords, reg_out,
                                n, h, w, threshold, inv_sx, inv_sy, tvx, tvy,
                                stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* dsnt_head_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
