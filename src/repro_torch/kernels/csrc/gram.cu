// Dense Gram C = A^T A (the reduced covariance's numerator over a dense
// row block, kernel K6) for Hopper.
//
// Replaces the TPU kernel of repro/kernels/gram.py: `_kernel` (launched
// by `gram_pallas`).  One launch computes, for a row-major (m, n) float32
// block A (the support columns of a row block),
//
//   C[a, b] = sum_r A[r, a] * A[r, b]           C (n, n) float32
//
// with the contraction over rows.
//
// Design.  The TPU kernel accumulates 128 x 128 output tiles in VMEM over
// a sequential row-tile axis.  Here a CTA of 4 warps owns one 64 x 64
// output tile (ta, tb) of the upper triangle and a slab of rows: the
// plan (kernels/gram.py:plan_gram) splits the rows into `split` slabs of
// `slab_rows`, up to 8, when the triangle alone has too few tiles to fill
// the 132 SMs, so grid = tiles x split, and a tile's slabs are one
// thread-block cluster.  The CTA streams its slab in panels of 32 rows by
// cp.async (16-byte copies when n % 4 == 0, else 4-byte ones, zero-filled
// past row m and column n: no padding contract) into a ring of 3 stages,
// so the next panels' copies overlap this one's contraction.  The
// contraction and the arithmetic are gram_tc.cuh's: mma.sync on the
// tensor cores in 3xTF32, each warp 32 x 32 outputs (32 accumulators a
// thread).  A split tile's partials are added in slab order through the
// cluster's distributed shared memory, each CTA a strip of rows, so the
// result is the same bits on every run; each strip is written once with
// its mirror, so C is exactly symmetric.
//
// What bounds it.  The function reads m n floats and writes n^2; the
// upper triangle it mirrors needs m n (n + 1) operations, which on the
// CUDA cores (67 TFLOP/s) set the bound: 0.00096 ms at (256, 500),
// 0.0160 ms at (256, 2048).  Its own 3xTF32 arithmetic is three
// products a term on the tensor cores (495 TFLOP/s dense TF32): 3 m n
// (n + 1) operations take 0.00039 ms at (256, 500), under the bytes'
// 0.00045 ms at 3.35 TB/s, and 0.0065 ms at (256, 2048), over the bytes'
// 0.0056 ms.  What the design does about it: the tensor cores take the
// arithmetic off the CUDA cores, 64-wide tiles halve the re-reads of A
// against 32-wide ones (each column is read n_tiles + 1 times, from L2),
// and the row split fills the card at small n.  At (256, 500) the time
// is latency (the launch, a panel's copy, the cluster's barriers), not a
// rate; at (256, 2048) the contraction's instructions and the 16 MB
// written.
//
// Contract: A contiguous, m >= 0, n >= 1 (checked here too); shapes,
// types and devices are checked by the Python wrapper, kernels/gram.py.

#include <climits>

#include "gram_tc.cuh"

namespace {

using namespace gram_tc;

constexpr int kT = 64;            // output tile edge
constexpr int kLd = staged_pitch(kT);  // pitch of the staged output tile
constexpr int kBK = 32;           // rows of a staged panel
constexpr int kStages = 3;        // panels in flight
constexpr int kThreads = 128;     // 4 warps, each 32 x 32 outputs
constexpr int kStageFloats = 2 * kBK * kT;
constexpr int kSmemBytes = kStages * kStageFloats * (int)sizeof(float);
static_assert(kSmemBytes >= kT * kLd * (int)sizeof(float), "epilogue tile");

// rows [r0, r0 + kBK) of columns [lo, lo + kT) into panel P; rows at or
// past r_end and columns at or past n are zero-filled
template <bool kVec>
__device__ __forceinline__ void load_panel(float* P, const float* A, int r_end, int n,
                                           int r0, int lo) {
  if (kVec) {
    for (int i = threadIdx.x; i < kBK * (kT / 4); i += kThreads) {
      const int rr = i / (kT / 4), c = (i % (kT / 4)) * 4;
      const int row = r0 + rr, col = lo + c;
      const bool in = row < r_end && col < n;
      cp_async16(P + pidx<kT>(rr, c), in ? A + (size_t)row * n + col : A, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * kT; i += kThreads) {
      const int rr = i / kT, c = i % kT;
      const int row = r0 + rr, col = lo + c;
      const bool in = row < r_end && col < n;
      cp_async4(P + pidx<kT>(rr, c), in ? A + (size_t)row * n + col : A, in ? 4 : 0);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
gram_kernel(const float* __restrict__ A, int m, int n, int n_tiles, int split,
            int slab_rows, float* __restrict__ C) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x / split, part = blockIdx.x % split;
  int ta, tb;
  tile_coords(tile, n_tiles, ta, tb);
  const bool diag = ta == tb;
  const int lo_a = ta * kT, lo_b = tb * kT;
  const int r_begin = part * slab_rows, r_end = min(m, r_begin + slab_rows);
  const int panels = r_end > r_begin ? (r_end - r_begin + kBK - 1) / kBK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m_off = (warp >> 1) * 32, n_off = (warp & 1) * 32;
  const bool idle = diag && WarpTile<kT, 2, 4>::below_diagonal(m_off, n_off);
  WarpTile<kT, 2, 4> wt;
  GRAM_TRACE(0);

  auto panel_a = [&](int s) { return smem + s * kStageFloats; };
  auto panel_b = [&](int s) { return diag ? panel_a(s) : panel_a(s) + kBK * kT; };
  auto issue = [&](int p) {     // one commit group per panel, empty past the last
    if (p < panels) {
      const int s = p % kStages, r0 = r_begin + p * kBK;
      load_panel<kVec>(panel_a(s), A, r_end, n, r0, lo_a);
      if (!diag) load_panel<kVec>(panel_b(s), A, r_end, n, r0, lo_b);
    }
    cp_async_commit();
  };

  for (int p = 0; p < kStages - 1; ++p) issue(p);
  for (int p = 0; p < panels; ++p) {
    cp_async_wait<kStages - 2>();   // panel p has landed (this thread's copies)
    __syncthreads();                // ... everyone's; and panel p - 1 is done
    issue(p + kStages - 1);         // into panel p - 1's stage
    if (!idle) {
      const float* Pa = panel_a(p % kStages);
      const float* Pb = panel_b(p % kStages);
#pragma unroll
      for (int k0 = 0; k0 < kBK; k0 += 8) wt.step(Pa, Pb, k0, m_off, n_off, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  GRAM_TRACE(2);   // loop
  wt.stage(smem, m_off, n_off, lane);
  int a0, a1;
  cluster_sum_strip<kT>(smem, a0, a1);
  GRAM_TRACE(3);   // cluster_sum
  write_rows<kT>(smem, C, n, lo_a, lo_b, diag, a0, a1);
  GRAM_TRACE(4);   // write
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `split` slabs (at most 8: one cluster) of `slab_rows` rows (a multiple
// of 32) must cover the m rows.
int gram_launch(const void* A, int m, int n, int split, int slab_rows, void* C,
                void* stream) {
  if (m < 0 || n < 1 || split < 1 || split > kMaxCluster || slab_rows < kBK ||
      slab_rows % kBK != 0 || (long long)split * slab_rows < m)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + kT - 1) / kT;
  const long long blocks = (long long)n_tiles * (n_tiles + 1) / 2 * split;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  static int smem_set[2][16];
  auto kernel = vec ? gram_kernel<true> : gram_kernel<false>;
  cudaError_t err = allow_smem(kernel, kSmemBytes, smem_set[vec]);
  if (err != cudaSuccess) return (int)err;
  err = launch_clustered(kernel, (int)blocks, kThreads, kSmemBytes, stream, split,
                         static_cast<const float*>(A), m, n, n_tiles, split, slab_rows,
                         static_cast<float*>(C));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
