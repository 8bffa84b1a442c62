// Calibration kernels for Hopper (sm_90a): the yardsticks that the other
// kernels' efficiency is stated against.  Over (rows, cols) fp32 with a
// scalar s read from device memory:
//
//   calib_copy:  o = x + s
//   calib_exp:   o = expf(x + s)
//   calib_smax:  o = softmax over each row of (x + s)
//
// Replaces the TPU kernels bench_kernel.py::calibrate::_copy_k, _exp_k and
// _smax_k.  There the loop-carried scalar sat in SMEM and was added inside
// the kernel so that XLA could hoist nothing out of the timing loop; here s
// is a 1-element fp32 tensor on the card that the kernel reads, which keeps
// the same contract and never syncs the host.
//
// What bounds them: bytes.  Each reads x once and writes o once,
// 2 * rows * cols * 4 bytes (268 MB at the bench's 8192 x 4096: 0.080 ms at
// the H100 SXM's 3.35 TB/s); their few operations per element (an add, an
// expf, a max, a sum and a division) are far below the fp32 rate.  Design:
//
// - copy gives each thread 4 float4 (16-byte loads and stores), all 4 loads
//   issued before the first store so that each warp keeps 2 KB in flight,
//   and one block of 256 threads to each 1024 float4 (a grid-stride loop
//   over 8 blocks per SM reached 2701 GB/s on an H100 80GB HBM3, 6% below
//   this file's softmax).  Its rate is the ceiling every other kernel is
//   stated against, so its layout stays fixed;
// - exp takes the same code in its own layout, ExpLayout below (see there
//   for why it is faster than the copy's);
// - both launchers take cols % 4 == 0 only, so rows * cols is whole float4s,
//   and the grid's ragged end is masked;
// - smax runs one block of 256 threads per row and keeps the row in
//   registers: each thread holds up to 4 float4 (16 floats, cols <= 4096),
//   so x is read once and o written once.  The row maximum and then the sum
//   of exponentials are reduced by warp shuffles and one pass through shared
//   memory, in a fixed order.
//
// No fast math (see build.py): expf is the full-precision one, and the
// division is IEEE, so exp agrees with torch.exp to a few ulp and copy is
// bitwise equal to x + s.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                            // float4 per thread
constexpr int kSmaxMaxCols = kThreads * kVec * 4;  // 4096
constexpr int kWarps = kThreads / 32;

struct AddOp {
  __device__ float operator()(float v, float s) const { return __fadd_rn(v, s); }
};

struct ExpOp {
  __device__ float operator()(float v, float s) const {
    return expf(__fadd_rn(v, s));
  }
};

// How an elementwise kernel cuts the array: T threads a block, V float4 a
// thread (float4 number b * T * V + t + k * T, k = 0..V-1, all V loads
// issued before the first store).
template <int T, int V>
struct Layout {
  static constexpr int kThreads = T;
  static constexpr int kVec = V;
};

using CopyLayout = Layout<kThreads, kVec>;

// exp's layout: 128 threads, 2 float4 a thread, which is the geometry of
// PyTorch's vectorized elementwise kernels.  Timed in turns against
// torch.exp at (8192, 4096) on an H100 80GB HBM3 at 700 W, it reads what
// torch.exp reads (0.0922-0.0924 ms against 0.0923), while the copy's 256 x
// 4, 128 x 4 and 256 x 8 read 0.0929-0.0943, like the copy itself.  The
// time follows the number of waves of resident blocks, not a thread's share
// of the work: 128 x 2 (24 registers) makes 32768 blocks, ~15.5 waves at 16
// blocks an SM, while 256 x 4 and 128 x 4 make ~7.8 and 256 x 8 (48
// registers, 5 blocks an SM) ~6.2, so more of the card idles in their last
// wave.  No evict-first hints (__ldcs/__stcs): they read 0.6% faster in
// turns but 0.9% slower right after the copy's calls, so their time
// depends on what ran before; without them the kernel reads the same in
// either order.
using ExpLayout = Layout<128, 2>;

template <typename Op, class L>
__device__ __forceinline__ void elementwise(const float* __restrict__ x,
                                            const float* __restrict__ s,
                                            float* __restrict__ o,
                                            long long n4) {
  const Op op{};
  const float sv = *s;
  const long long first =
      static_cast<long long>(blockIdx.x) * (L::kThreads * L::kVec) +
      threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  float4 v[L::kVec];
#pragma unroll
  for (int k = 0; k < L::kVec; ++k) {
    const long long i = first + k * L::kThreads;
    if (i < n4) v[k] = x4[i];
  }
#pragma unroll
  for (int k = 0; k < L::kVec; ++k) {
    const long long i = first + k * L::kThreads;
    if (i < n4) {
      v[k].x = op(v[k].x, sv);
      v[k].y = op(v[k].y, sv);
      v[k].z = op(v[k].z, sv);
      v[k].w = op(v[k].w, sv);
      o4[i] = v[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
calib_copy_kernel(const float* __restrict__ x, const float* __restrict__ s,
                  float* __restrict__ o, long long n4) {
  elementwise<AddOp, CopyLayout>(x, s, o, n4);
}

__global__ void __launch_bounds__(ExpLayout::kThreads)
calib_exp_kernel(const float* __restrict__ x, const float* __restrict__ s,
                 float* __restrict__ o, long long n4) {
  elementwise<ExpOp, ExpLayout>(x, s, o, n4);
}

// Reduces v over the block in a fixed order; every thread gets the result.
// `red` holds one value per warp; the caller's next use of it must follow a
// __syncthreads (the one inside the next call does).
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  const int warp = threadIdx.x / 32;
  __syncthreads();                 // red may still be read by a last reduce
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__global__ void __launch_bounds__(kThreads)
calib_smax_kernel(const float* __restrict__ x, const float* __restrict__ s,
                  float* __restrict__ o, int cols) {
  __shared__ float red[kWarps];
  const float sv = *s;
  const int c4 = cols / 4;
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  const float4* xr = reinterpret_cast<const float4*>(x + base);
  float4* orow = reinterpret_cast<float4*>(o + base);

  float4 v[kVec];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < c4) {
      v[k] = xr[i];
      v[k].x = __fadd_rn(v[k].x, sv);
      v[k].y = __fadd_rn(v[k].y, sv);
      v[k].z = __fadd_rn(v[k].z, sv);
      v[k].w = __fadd_rn(v[k].w, sv);
      m = fmaxf(m, fmaxf(fmaxf(v[k].x, v[k].y), fmaxf(v[k].z, v[k].w)));
    }
  }
  m = block_reduce<true>(m, red);

  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < c4) {
      v[k].x = expf(v[k].x - m);
      v[k].y = expf(v[k].y - m);
      v[k].z = expf(v[k].z - m);
      v[k].w = expf(v[k].w - m);
      sum += (v[k].x + v[k].y) + (v[k].z + v[k].w);
    }
  }
  sum = block_reduce<false>(sum, red);

#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < c4) {
      float4 r = v[k];
      r.x = r.x / sum;
      r.y = r.y / sum;
      r.z = r.z / sum;
      r.w = r.w / sum;
      orow[i] = r;
    }
  }
}

// float4 of a (rows, cols) array, cols % 4 == 0, and the blocks that cover them.
long long float4s(int rows, int cols) {
  return static_cast<long long>(rows) * (cols / 4);
}

template <class L>
unsigned elementwise_blocks(long long n4) {
  constexpr int per_block = L::kThreads * L::kVec;
  return static_cast<unsigned>((n4 + per_block - 1) / per_block);
}

bool bad_shape(int rows, int cols) {
  return rows <= 0 || cols <= 0 || cols % 4 != 0;
}

}  // namespace

extern "C" {

// x, o (rows, cols) f32, 16-byte aligned, cols % 4 == 0; s (1,) f32.
// Each returns the cudaError_t of its launch.
int calib_copy(const float* x, const float* s, float* o, int rows, int cols,
               cudaStream_t stream) {
  if (bad_shape(rows, cols)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = float4s(rows, cols);
  calib_copy_kernel<<<elementwise_blocks<CopyLayout>(n4), kThreads, 0,
                      stream>>>(x, s, o, n4);
  return static_cast<int>(cudaGetLastError());
}

int calib_exp(const float* x, const float* s, float* o, int rows, int cols,
              cudaStream_t stream) {
  if (bad_shape(rows, cols)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = float4s(rows, cols);
  calib_exp_kernel<<<elementwise_blocks<ExpLayout>(n4), ExpLayout::kThreads,
                     0, stream>>>(x, s, o, n4);
  return static_cast<int>(cudaGetLastError());
}

// cols <= kSmaxMaxCols (4096): the row is held in registers.
int calib_smax(const float* x, const float* s, float* o, int rows, int cols,
               cudaStream_t stream) {
  if (bad_shape(rows, cols) || cols > kSmaxMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  calib_smax_kernel<<<rows, kThreads, 0, stream>>>(x, s, o, cols);
  return static_cast<int>(cudaGetLastError());
}

const char* calib_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
