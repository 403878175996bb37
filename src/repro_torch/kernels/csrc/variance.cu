// Dense column statistics (the variance screen's reduction over a dense
// row block, kernel K5) for Hopper.
//
// Replaces the TPU kernel of repro/kernels/variance.py: `_kernel`
// (launched by `column_stats_pallas`).  One launch reduces a dense (m, n)
// row-major block A, float32 or float64, to
//
//   sum[c]   = sum_r a[r, c]
//   sumsq[c] = sum_r a[r, c] * a[r, c]        a = float32(A[r, c])
//
// accumulated in float32, as the TPU kernel does (`astype(float32)`).
//
// Design.  The TPU kernel walks row tiles in order on one core and keeps
// its sums in the output block across the row axis; on Hopper blocks run
// in parallel and in no order, so nothing carries between CTAs: one
// thread owns one column, the grid runs over column tiles (256 columns a
// CTA, ~400 CTAs at NYTimes width), and the row axis is the loop inside
// the thread.  Neighbouring threads read neighbouring addresses of a row,
// so every load of a warp is one 128-byte line (float32).  Each thread
// adds its rows in ascending order in float32 registers; `a * a` rounds
// before its add (the build's --fmad=false).  No atomics: the result is
// the same bits on every run.
//
// What bounds it: bytes.  Every element is read once (105 MB for a
// (256, 102,660) float32 block, 0.031 ms at 3.35 TB/s) and 8 bytes a
// column are written; the 3 operations an element are far below the
// card's float32 rate.  A row loop unrolled by 8 keeps 8 independent
// loads in flight a thread.
//
// Contract: A contiguous, m >= 0, n >= 1 (checked here too); shapes,
// types and devices are checked by the Python wrapper, kernels/variance.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
column_stats_kernel(const T* __restrict__ A, long long m, int n,
                    float* __restrict__ out_sum, float* __restrict__ out_sumsq) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n) return;
  const T* p = A + c;
  float s = 0.0f, ss = 0.0f;
#pragma unroll 8
  for (long long r = 0; r < m; ++r) {
    const float a = (float)__ldg(p + r * (long long)n);
    s += a;
    ss += a * a;
  }
  out_sum[c] = s;
  out_sumsq[c] = ss;
}

template <typename T>
int launch(const void* A, long long m, int n, void* out_sum, void* out_sumsq,
           cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  column_stats_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(A), m, n, static_cast<float*>(out_sum),
      static_cast<float*>(out_sumsq));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int column_stats_launch(int dtype_bytes, const void* A, long long m, int n,
                        void* out_sum, void* out_sumsq, void* stream) {
  if (m < 0 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4) return launch<float>(A, m, n, out_sum, out_sumsq, st);
  if (dtype_bytes == 8) return launch<double>(A, m, n, out_sum, out_sumsq, st);
  return (int)cudaErrorInvalidValue;
}

const char* column_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
