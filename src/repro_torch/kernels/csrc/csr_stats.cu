// CSR column statistics (the variance screen's reduction, kernel K2) for
// Hopper.
//
// Replaces the TPU kernel of repro/kernels/csr_stats.py: `_kernel`
// (launched by `csr_column_stats_pallas`).  One launch reduces a whole
// megabatch of C padded CSR chunks, flattened to `total` = C * E entries:
//
//   sum[c]   += v      for every entry (v, c) with 0 <= c < n
//   sumsq[c] += v * v
//
// and writes both as float32 (n,) vectors.
//
// Design.  The TPU kernel turns the scatter into a one-hot matrix product
// only because the TPU has no scatter; Hopper has one, so this is a plain
// scatter-add: each thread takes entries in a grid-stride loop and adds
// them with atomics into a float64 accumulator (`acc`, interleaved
// [sum_c, sumsq_c] pairs, zeroed by the caller).  Float atomics add in an
// order that changes from run to run; in float64 the sum of float32
// values (and of their exact float64 squares) is exact for integer counts
// and far below float32's rounding otherwise, and the one rounding to
// float32 at the end makes the result independent of that order in
// practice.  The last block to finish (a ticket counter after a memory
// fence) rounds the accumulator to the float32 outputs, so the whole
// reduction is one launch.  Zero values (the chunks' padding) are
// skipped: they add nothing.
//
// What bounds it: bytes at best (8 bytes read per entry, 8 per column
// written), but in practice the atomics: a Zipf corpus sends most entries
// to a few hundred columns, and adds to one address serialise in L2.
//
// Contract: `acc` holds 2n doubles plus one 8-byte slot for the ticket,
// all zero; shapes, types and devices are checked by the Python wrapper,
// kernels/csr_stats.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocks = 132 * 4;

__global__ void __launch_bounds__(kThreads)
csr_stats_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                 long long total, int n, double* __restrict__ acc,
                 unsigned int* __restrict__ ticket, float* __restrict__ out_sum,
                 float* __restrict__ out_sumsq) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const float v = vals[i];
    const int c = cols[i];
    if (v == 0.0f || c < 0 || c >= n) continue;
    const double d = (double)v;
    atomicAdd(&acc[2 * (long long)c], d);
    atomicAdd(&acc[2 * (long long)c + 1], d * d);
  }
  // Last block out rounds the accumulator to float32.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const double2* pairs = reinterpret_cast<const double2*>(acc);
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const double2 p = __ldcg(pairs + c);   // L2: where the atomics landed
    out_sum[c] = (float)p.x;
    out_sumsq[c] = (float)p.y;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int csr_stats_launch(const void* vals, const void* cols, long long total, int n,
                     void* acc, void* out_sum, void* out_sumsq, void* stream) {
  if (n <= 0 || total < 0) return (int)cudaErrorInvalidValue;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  double* a = static_cast<double*>(acc);
  csr_stats_kernel<<<(int)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols), total, n, a,
      reinterpret_cast<unsigned int*>(a + 2 * (long long)n),
      static_cast<float*>(out_sum), static_cast<float*>(out_sumsq));
  return (int)cudaGetLastError();
}

const char* csr_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
