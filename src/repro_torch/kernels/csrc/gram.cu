// Dense Gram C = A^T A (the reduced covariance's numerator over a dense
// row block, kernel K6) for Hopper.
//
// Replaces the TPU kernel of repro/kernels/gram.py: `_kernel` (launched
// by `gram_pallas`).  One launch computes, for a row-major (m, n) float32
// block A (the support columns of a row block),
//
//   C[a, b] = sum_r A[r, a] * A[r, b]           C (n, n) float32
//
// with the contraction over rows, accumulated in float32.
//
// Design.  The TPU kernel accumulates 128 x 128 output tiles in VMEM over
// a sequential row-tile axis.  Here each CTA owns one 32 x 32 output tile
// (ta, tb) of the upper triangle (grid = n_tiles (n_tiles + 1) / 2) and
// walks the rows in panels of 64: it stages the panel's 32 columns of
// tile ta and of tile tb in shared memory (one panel on the diagonal;
// each row of a panel is one 128-byte load), then every thread adds its
// 1 x 4 outputs' products over the panel's rows, in row order, in float32
// registers on the CUDA cores (each multiply and add rounded: the build's
// --fmad=false).  The sum of every output runs over r = 0 .. m-1 in
// ascending order whatever the launch, so the result is the same bits on
// every run.  The tile is written once, with its mirror below the
// diagonal, so C is exactly symmetric.  Ragged m and n are masked here:
// no padding contract.
//
// What bounds it: operations, at the path's shapes.  The function needs
// the upper triangle only: m n (n + 1) operations (64.1 MFLOP at
// (256, 500), 0.00096 ms at 67 TFLOP/s on the CUDA cores) against
// m n + n^2 floats of traffic.  The tensor-core (wgmma, 3xTF32)
// contraction is later work.
//
// Contract: A contiguous, m >= 0, n >= 1 (checked here too); shapes,
// types and devices are checked by the Python wrapper, kernels/gram.py.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;            // output tile edge
constexpr int kRows = 64;         // rows a shared-memory panel holds
constexpr int kThreads = 256;     // a thread owns 1 x 4 outputs of the tile

__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ A, int m, int n, int n_tiles,
            float* __restrict__ C) {
  __shared__ __align__(16) float Pa[kRows][kT];
  __shared__ __align__(16) float Pb[kRows][kT];
  // blockIdx.x -> (ta, tb), ta <= tb, row-major over the upper triangle
  int rem = blockIdx.x, ta = 0;
  while (rem >= n_tiles - ta) { rem -= n_tiles - ta; ++ta; }
  const int tb = ta + rem;
  const bool diag = ta == tb;
  float (*Qb)[kT] = diag ? Pa : Pb;
  const int lo_a = ta * kT, lo_b = tb * kT;
  const int a = threadIdx.x >> 3;           // row of the tile (column of A in tile ta)
  const int b0 = (threadIdx.x & 7) * 4;     // first of 4 columns in tile tb
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;

  for (int r0 = 0; r0 < m; r0 += kRows) {
    const int rows = min(kRows, m - r0);
    for (int e = threadIdx.x; e < kRows * kT; e += kThreads) {
      const int rr = e / kT, cc = e % kT;
      const long long row = (long long)(r0 + rr) * n;
      const bool in = rr < rows;
      Pa[rr][cc] = (in && lo_a + cc < n) ? __ldg(A + row + lo_a + cc) : 0.f;
      if (!diag) Pb[rr][cc] = (in && lo_b + cc < n) ? __ldg(A + row + lo_b + cc) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float pa = Pa[r][a];
      const float4 pb = *reinterpret_cast<const float4*>(&Qb[r][b0]);
      acc0 += pa * pb.x;
      acc1 += pa * pb.y;
      acc2 += pa * pb.z;
      acc3 += pa * pb.w;
    }
    __syncthreads();
  }
  const int ga = lo_a + a;
  if (ga >= n) return;
  const float out[4] = {acc0, acc1, acc2, acc3};
  for (int k = 0; k < 4; ++k) {
    const int gb = lo_b + b0 + k;
    if (gb >= n) break;
    C[(long long)ga * n + gb] = out[k];
    if (!diag) C[(long long)gb * n + ga] = out[k];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int gram_launch(const void* A, int m, int n, void* C, void* stream) {
  if (m < 0 || n < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + kT - 1) / kT;
  const long long blocks = (long long)n_tiles * (n_tiles + 1) / 2;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gram_kernel<<<(int)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), m, n, n_tiles, static_cast<float*>(C));
  return (int)cudaGetLastError();
}

const char* gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
