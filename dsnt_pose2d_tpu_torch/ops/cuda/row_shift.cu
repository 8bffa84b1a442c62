// Per-row fractional shift for Hopper (sm_90a):
//
//   out[r, i] = (1 - f_r) * rows[r, k_r + i] + f_r * rows[r, k_r + i + stride]
//
// Replaces the TPU kernels dsnt_pose2d_tpu/ops/pallas/row_shift.py::_kernel_vec
// and its A/B twin _kernel_legacy (same contract, bitwise-equal to each
// other).  Their 128-aligned window copy and static-roll ladder exist only
// because TPU lanes cannot take unaligned dynamic slices; a GPU thread reads
// any address, so the contract is computed directly.
//
// Padding: the caller's contract is kept (starts in [0, L - out_len - stride],
// the rows pre-padded by the caller as in data/augment.py), and loads are
// also bounds-checked: a tap outside [0, L) of its own row reads 0, so a bad
// start can never read a neighbouring row.
//
// The lerp is written with __fmul_rn / __fadd_rn so nvcc cannot contract it
// into an FMA: the result is then bitwise-equal to the plain PyTorch version,
// which rounds each product and the sum separately.
//
// What bounds it: bytes.  The least traffic is each row's window (out_len +
// stride values) read once and the output written once; three flops an
// element are nothing beside that.  The first design (one thread per output
// element, one 4-byte load of new data in flight per thread) was bound by
// latency at 0.66 of the measured copy ceiling on an H100 80GB HBM3 (700 W).
// Design:
//
// - The output is cut into units of 4 elements that are 16-byte aligned in
//   the flat (n_rows, out_len) array: a row whose start is not aligned
//   (out_len % 4 != 0) gets a partial first and last unit.  Units are
//   numbered row by row over the whole array, so a short row (768 outputs)
//   shares a block with its neighbours and no thread idles; each thread
//   takes kUnits units, kThreads apart (coalesced).
// - A whole unit whose taps lie inside its row reads the 2 or 3 aligned
//   float4 that cover its 4 + stride input values and picks its taps from
//   registers: the misalignment (row base + start) mod 4 is one value per
//   row, so a warp takes one branch of the 4-way switch.  Every unit's
//   loads are issued before the first lerp, so each thread keeps 4-6
//   16-byte loads in flight; neighbouring units re-read their shared
//   float4 from L1, not from device memory.  The output goes out as one
//   float4 store.
// - A partial unit, or one with a tap outside its row, takes the scalar,
//   bounds-checked path; so does every unit when a pointer is not 16-byte
//   aligned or the stride is not 1 or 3 (the vector path is compiled for
//   the strides the shear warp uses: 1 for gray rows, 3 for RGB).
// - starts and fracs are staged once per block in shared memory.
//
// An aligned float4 that holds the last needed value of the array may
// extend past its end by up to 3 values: the 16 aligned bytes never cross a
// page, and they are never used.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 2;                         // units per thread
constexpr int kUnitsPerBlock = kThreads * kUnits;
constexpr int kMaxRowsPerBlock = kUnitsPerBlock + 1;

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, f), a), __fmul_rn(f, b));
}

// Value I of the floats held in w[0], w[1], ... (I known at compile time).
template <int I, int NV>
__device__ __forceinline__ float pick(const float4 (&w)[NV]) {
  const float4& v = w[I / 4];
  if constexpr (I % 4 == 0) return v.x;
  else if constexpr (I % 4 == 1) return v.y;
  else if constexpr (I % 4 == 2) return v.z;
  else return v.w;
}

// A unit's 4 outputs from the float4 it loaded, SH = misalignment.
template <int SH, int STRIDE, int NV>
__device__ __forceinline__ float4 lerp_unit(const float4 (&w)[NV], float f) {
  float4 o;
  o.x = lerp_rn(pick<SH + 0>(w), pick<SH + 0 + STRIDE>(w), f);
  o.y = lerp_rn(pick<SH + 1>(w), pick<SH + 1 + STRIDE>(w), f);
  o.z = lerp_rn(pick<SH + 2>(w), pick<SH + 2 + STRIDE>(w), f);
  o.w = lerp_rn(pick<SH + 3>(w), pick<SH + 3 + STRIDE>(w), f);
  return o;
}

// STRIDE 1 or 3: vector path where possible; 0: every unit scalar, any stride.
template <int STRIDE>
__global__ void __launch_bounds__(kThreads)
row_shift_kernel(const float* __restrict__ rows, const int* __restrict__ starts,
                 const float* __restrict__ fracs, float* __restrict__ out,
                 int n_rows, int len, int out_len, int stride, int units,
                 bool vec) {
  // The float4 that cover 4 + STRIDE values starting at any misalignment.
  constexpr int kNv = STRIDE > 0 ? (3 + 3 + STRIDE) / 4 + 1 : 1;
  __shared__ int s_start[kMaxRowsPerBlock];
  __shared__ float s_frac[kMaxRowsPerBlock];

  const long long total = static_cast<long long>(n_rows) * units;
  const long long u0 = static_cast<long long>(blockIdx.x) * kUnitsPerBlock;
  const long long u_last = min(u0 + kUnitsPerBlock, total) - 1;
  const int r0 = static_cast<int>(u0 / units);
  const int nr = static_cast<int>(u_last / units) - r0 + 1;
  for (int i = threadIdx.x; i < nr; i += kThreads) {
    s_start[i] = starts[r0 + i];
    s_frac[i] = fracs[r0 + i];
  }
  __syncthreads();

  int row[kUnits], col[kUnits], shift[kUnits] = {};
  bool fast[kUnits];
  float4 w[kUnits][kNv];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const long long u = u0 + k * kThreads + threadIdx.x;
    row[k] = -1;
    fast[k] = false;
    if (u > u_last) continue;
    const int r = static_cast<int>(u / units);
    const int j = static_cast<int>(u - static_cast<long long>(r) * units);
    // The row's output starts `lead` values past a 16-byte boundary, so
    // unit 0 begins `lead` columns before it.
    const int lead = static_cast<int>((static_cast<long long>(r) * out_len) & 3);
    const int c0 = 4 * j - lead;
    const int s = s_start[r - r0];
    row[k] = r;
    col[k] = c0;
    if (STRIDE == 0 || !vec) continue;
    const int t0 = s + c0;              // first tap of the unit in its row
    fast[k] = c0 >= 0 && c0 + 4 <= out_len && t0 >= 0 &&
              t0 + 3 + STRIDE < len;
    if (!fast[k]) continue;
    const long long g0 = static_cast<long long>(r) * len + t0;
    const int sh = static_cast<int>(g0 & 3);
    shift[k] = sh;
    const float4* p = reinterpret_cast<const float4*>(rows + (g0 - sh));
    const int nv = (sh + 3 + STRIDE) / 4 + 1;
#pragma unroll
    for (int m = 0; m < kNv; ++m) {
      if (m < nv) w[k][m] = __ldg(p + m);
    }
  }

#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int r = row[k];
    if (r < 0) continue;
    const float f = s_frac[r - r0];
    float* orow = out + static_cast<long long>(r) * out_len;
    if (fast[k]) {
      if constexpr (STRIDE > 0) {
        float4 o;
        switch (shift[k]) {
          case 0: o = lerp_unit<0, STRIDE>(w[k], f); break;
          case 1: o = lerp_unit<1, STRIDE>(w[k], f); break;
          case 2: o = lerp_unit<2, STRIDE>(w[k], f); break;
          default: o = lerp_unit<3, STRIDE>(w[k], f); break;
        }
        *reinterpret_cast<float4*>(orow + col[k]) = o;
      }
      continue;
    }
    const float* irow = rows + static_cast<long long>(r) * len;
    const int s = s_start[r - r0];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = col[k] + q;
      if (c < 0 || c >= out_len) continue;
      const int ia = s + c;
      const int ib = ia + stride;
      const float a = (ia >= 0 && ia < len) ? irow[ia] : 0.f;
      const float b = (ib >= 0 && ib < len) ? irow[ib] : 0.f;
      orow[c] = lerp_rn(a, b, f);
    }
  }
}

}  // namespace

extern "C" {

// rows (n_rows, len) f32, starts (n_rows,) i32, fracs (n_rows,) f32,
// out (n_rows, out_len) f32.  Returns the cudaError_t of the launch.
int row_shift(const float* rows, const int* starts, const float* fracs,
              float* out, int n_rows, int len, int out_len, int stride,
              cudaStream_t stream) {
  if (n_rows <= 0 || out_len <= 0 || len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Units a row may need: its (lead + out_len) columns, lead in [0, 3].
  const int units = (out_len + 3) / 4 + 1;
  const long long blocks =
      (static_cast<long long>(n_rows) * units + kUnitsPerBlock - 1) /
      kUnitsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = ((reinterpret_cast<std::uintptr_t>(rows) |
                     reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (stride) {
    case 1:
      row_shift_kernel<1><<<grid, kThreads, 0, stream>>>(
          rows, starts, fracs, out, n_rows, len, out_len, stride, units, vec);
      break;
    case 3:
      row_shift_kernel<3><<<grid, kThreads, 0, stream>>>(
          rows, starts, fracs, out, n_rows, len, out_len, stride, units, vec);
      break;
    default:
      row_shift_kernel<0><<<grid, kThreads, 0, stream>>>(
          rows, starts, fracs, out, n_rows, len, out_len, stride, units, vec);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* row_shift_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
