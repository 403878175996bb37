// CSR gather-Gram (the reduced covariance's numerator, kernel K3) for
// Hopper.
//
// Replaces the TPU kernels of repro/kernels/csr_gram.py: `_batched_kernel`
// (launched by `csr_gram_batched_pallas`) and `_kernel` (launched by
// `csr_gram_pallas`, the same function for one chunk).  One launch
// computes, over a megabatch of C padded CSR chunks of E entries each,
//
//   G = sum_c B_c^T B_c,   B_c[seg, col] += v  for every entry of chunk c
//
// with B_c the chunk densified to (R, n_hat) on the support: `seg` is the
// chunk-local row (< R) and a local column >= n_hat is the off-support
// sentinel, dropped.  G is (n_hat, n_hat) float32.
//
// Design.  The TPU kernels densify a whole chunk into an (R, n_pad)
// scratch in VMEM (1 MB at n_pad 512); a Hopper block has 227 KB of
// shared memory.  So each CTA owns one T x T output tile (i, j) of the
// upper triangle (grid = n_tiles (n_tiles + 1) / 2) and, for each chunk:
//   1. zeroes two (R, T) shared-memory panels, for the columns of tile i
//      and of tile j (one panel on the diagonal);
//   2. scans the chunk's E entries and adds each on-support entry whose
//      column falls in tile i or j into its panel (shared-memory atomics;
//      the entries need not be sorted by row);
//   3. accumulates panel_i^T panel_j over the R rows, in registers, in
//      row order, on the CUDA cores in float32.
// The accumulators live in registers across the C chunks, and the tile is
// written once, with its mirror below the diagonal.  A store chunk never
// holds two entries at one (row, col) and zero values (padding) are
// skipped, so each panel cell receives at most one add and the result is
// deterministic: the same inputs give the same bits on every run.
//
// What bounds it: the function itself needs only the entries' bytes (12
// per slot) and the sparse product's multiply-adds, a bound well under a
// microsecond per megabatch at the streaming fit's shape (C = 8, E =
// 16,384, R = 512, n_hat in the hundreds).  This design pays instead for
// the dense contraction of the panels (2 C R n_pad^2 operations on the
// CUDA cores) and for re-reading the megabatch's entries once per tile
// (from L2), and those set its time.  The tensor-core (wgmma) contraction
// and a schedule that reads the entries once are later work.
//
// Contract: shapes, types and devices are checked by the Python wrapper,
// kernels/csr_gram.py; R * T * 2 floats must fit a block's shared memory
// (checked here too).

#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;            // output tile edge
constexpr int kThreads = 256;     // a thread owns 1 x 4 outputs of the tile
constexpr int kSmemLimit = 232448;

__global__ void __launch_bounds__(kThreads)
csr_gram_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                const int* __restrict__ segs, int C, int E, int R, int n_hat,
                int n_tiles, float* __restrict__ G) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // blockIdx.x -> (ti, tj), ti <= tj, row-major over the upper triangle
  int rem = blockIdx.x, ti = 0;
  while (rem >= n_tiles - ti) { rem -= n_tiles - ti; ++ti; }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  float* Pi = smem;
  float* Pj = diag ? smem : smem + R * kT;
  const int lo_i = ti * kT, lo_j = tj * kT;
  const int a = threadIdx.x >> 3;           // row of the tile (column of G in tile i)
  const int b0 = (threadIdx.x & 7) * 4;     // first of 4 columns in tile j
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  const int words4 = (diag ? 1 : 2) * R * kT / 4;

  for (int c = 0; c < C; ++c) {
    for (int k = threadIdx.x; k < words4; k += blockDim.x)
      smem4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    const float* v = vals + (long long)c * E;
    const int* cl = cols + (long long)c * E;
    const int* sg = segs + (long long)c * E;
    for (int p = threadIdx.x; p < E; p += blockDim.x) {
      const float x = v[p];
      const int col = cl[p];
      const int r = sg[p];
      if (x == 0.0f || col < 0 || col >= n_hat || r < 0 || r >= R) continue;
      const unsigned oi = (unsigned)(col - lo_i);
      if (oi < (unsigned)kT) atomicAdd(&Pi[r * kT + oi], x);
      if (!diag) {
        const unsigned oj = (unsigned)(col - lo_j);
        if (oj < (unsigned)kT) atomicAdd(&Pj[r * kT + oj], x);
      }
    }
    __syncthreads();
    for (int r = 0; r < R; ++r) {
      const float pa = Pi[r * kT + a];
      const float4 pb = *reinterpret_cast<const float4*>(&Pj[r * kT + b0]);
      acc0 += pa * pb.x;
      acc1 += pa * pb.y;
      acc2 += pa * pb.z;
      acc3 += pa * pb.w;
    }
    __syncthreads();
  }
  const int gi = lo_i + a;
  if (gi >= n_hat) return;
  const float out[4] = {acc0, acc1, acc2, acc3};
  for (int k = 0; k < 4; ++k) {
    const int gj = lo_j + b0 + k;
    if (gj >= n_hat) break;
    G[(long long)gi * n_hat + gj] = out[k];
    if (!diag) G[(long long)gj * n_hat + gi] = out[k];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int csr_gram_launch(const void* vals, const void* cols, const void* segs, int C,
                    int E, int R, int n_hat, void* G, void* stream) {
  if (C < 1 || E < 0 || R < 1 || n_hat < 1) return (int)cudaErrorInvalidValue;
  const int smem = 2 * R * kT * (int)sizeof(float);   // two (R, kT) panels
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      csr_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_hat + kT - 1) / kT;
  const int blocks = n_tiles * (n_tiles + 1) / 2;
  csr_gram_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<const int*>(segs), C, E, R, n_hat, n_tiles,
      static_cast<float*>(G));
  return (int)cudaGetLastError();
}

const char* csr_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
