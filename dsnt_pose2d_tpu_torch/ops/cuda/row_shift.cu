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
// What bounds it: bytes.  Each output element reads two (mostly cached)
// inputs and does three flops; the least traffic is one read of the input
// rows and one write of the output.  Design: one thread per output element;
// blockIdx.x walks rows (no 65535 limit on rows), blockIdx.y tiles the
// output row, so neighbouring threads touch neighbouring addresses and every
// load and store is coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
row_shift_kernel(const float* __restrict__ rows, const int* __restrict__ starts,
                 const float* __restrict__ fracs, float* __restrict__ out,
                 int len, int out_len, int stride) {
  const int r = blockIdx.x;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= out_len) return;
  const float* row = rows + static_cast<size_t>(r) * len;
  const int ia = starts[r] + i;
  const int ib = ia + stride;
  const float f = fracs[r];
  const float a = (ia >= 0 && ia < len) ? row[ia] : 0.f;
  const float b = (ib >= 0 && ib < len) ? row[ib] : 0.f;
  out[static_cast<size_t>(r) * out_len + i] =
      __fadd_rn(__fmul_rn(__fsub_rn(1.f, f), a), __fmul_rn(f, b));
}

}  // namespace

extern "C" {

// rows (n_rows, len) f32, starts (n_rows,) i32, fracs (n_rows,) f32,
// out (n_rows, out_len) f32.  Returns the cudaError_t of the launch.
int row_shift(const float* rows, const int* starts, const float* fracs,
              float* out, int n_rows, int len, int out_len, int stride,
              cudaStream_t stream) {
  const int col_blocks = (out_len + kThreads - 1) / kThreads;
  if (n_rows <= 0 || out_len <= 0 || len <= 0 || col_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(n_rows, col_blocks);
  row_shift_kernel<<<grid, kThreads, 0, stream>>>(rows, starts, fracs, out,
                                                  len, out_len, stride);
  return static_cast<int>(cudaGetLastError());
}

const char* row_shift_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
