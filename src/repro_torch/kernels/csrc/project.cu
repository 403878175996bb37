// Sparse-projection gather-matvec (the serving hot path, kernel K4) for
// Hopper.
//
// Replaces the TPU kernel of repro/kernels/project.py: `_kernel`
// (launched by `sparse_project_pallas`, via `ops.sparse_project`).  For a
// batch of B documents X (B, n) and k packed sparse components
// (support_idx, values), both (k, cap):
//
//   out[b, c] = sum_{j < cap} values[c, j] * X[b, support_idx[c, j]]
//
// Design.  The TPU kernel transposes the batch so that gathering a column
// of X becomes a row DMA, points padded slots at an appended zero row and
// accumulates over a sequential grid axis in a VMEM output block.  None of
// that carries over: here one thread owns one output (b, c), reads X
// row-major as it is, loops over its component's `cap` slots in slot
// order, accumulates in float32 and writes out[b, c] once.  No atomics
// (the result is deterministic), no shared memory.  Thread t owns
// (b, c) = (t / k, t % k), so a warp's writes are contiguous in `out`.
//
// Padding.  The packer fills slots past a component's cardinality with
// (index 0, value 0.0).  A slot whose value is exactly 0 is skipped: that
// is what the TPU path does by sending it to the zero row.  The
// reference's plain version instead multiplies X[b, 0] by 0; the two
// differ only when X[b, 0] is not finite.  A slot whose index lies outside
// [0, n) is skipped too, so a bad pack cannot read out of bounds (the
// projector validates the pack on the host, so the serving path never has
// one).
//
// What bounds it: bytes, and in practice the launch.  At the serving
// shape (B 64, k 5, cap 8) it touches 2,560 scattered float32 values of
// X: at most 2,560 32-byte sectors (82 KB), plus the pack (320 B) and the
// output (1.3 KB): ~0.03 us at 3.35 TB/s, against a few us of launch
// latency.  A dense X @ W would read the whole 26.3 MB batch.
//
// Contract: X is (B, n) contiguous float32, support_idx (k, cap) int32 and
// values (k, cap) float32, contiguous, out (B, k) float32, all on one
// device; checked by the Python wrapper, kernels/project.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
sparse_project_kernel(const float* __restrict__ X, long long B, long long n,
                      const int* __restrict__ idx,
                      const float* __restrict__ vals, int k, int cap,
                      float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * k) return;
  const long long b = t / k;
  const int c = (int)(t - b * k);
  const float* row = X + b * n;
  const int* ci = idx + (long long)c * cap;
  const float* cv = vals + (long long)c * cap;
  float acc = 0.0f;
  for (int j = 0; j < cap; ++j) {
    const float v = cv[j];
    const int w = ci[j];
    if (v == 0.0f || w < 0 || (long long)w >= n) continue;
    acc = __fadd_rn(acc, __fmul_rn(v, __ldg(row + w)));
  }
  out[t] = acc;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int sparse_project_launch(const void* X, long long B, long long n,
                          const void* idx, const void* vals, int k, int cap,
                          void* out, void* stream) {
  if (B < 0 || n < 1 || k < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  const long long total = B * (long long)k;
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  sparse_project_kernel<<<(unsigned int)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), B, n, static_cast<const int*>(idx),
      static_cast<const float*>(vals), k, cap, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* sparse_project_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
