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
// only because the TPU has no scatter; Hopper has one, so this is a
// scatter-add into a float64 accumulator (`acc`, [sum_c, sumsq_c] pairs),
// one cooperative launch in three steps:
//   1. each CTA takes a contiguous share of the entries (a run of
//      documents) and adds them into a table in its shared memory, open
//      addressing keyed by column (a multiplicative hash, so no column
//      order is assumed), float64 sums; a Zipf corpus repeats its frequent
//      columns within a run, so the table absorbs their repeats.  An entry
//      that finds no free slot in kProbes tries goes straight to the
//      accumulator.  The table's sums are then added to the accumulator,
//      one pair of float64 atomics per distinct column of the share;
//   2. a grid barrier (cooperative_groups): every add has landed;
//   3. every CTA rounds its slice of the columns to float32 and writes
//      zeros back, so the accumulator, a per-stream workspace the wrapper
//      keeps (kernels/csr_stats.py), is zero between launches and no call
//      allocates or clears it.
// In float64 the sum of float32 values (and of their exact float64
// squares) is exact for integer counts and far below float32's rounding
// otherwise, so the single rounding at the end makes the result
// independent of the order in which the atomics land.  Zero values (the
// chunks' padding) are skipped: they add nothing.
//
// What bounds it: bytes at best (8 bytes read per entry, 8 per column
// written), but in practice the adds: a Zipf corpus sends most entries to
// a few hundred columns, and adds to one address serialise (in L2 for the
// global atomics, which the shared table spares; in shared memory, where a
// float64 add is a compare-and-swap loop, for the table's).
//
// Contract: the grid fits the card at once (the wrapper's plan; the
// launch clamps it to what the occupancy calculator allows); `acc` holds
// 2n zero doubles; shapes, types and devices are checked by the wrapper.

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "phase_trace.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kProbes = 8;        // slots an entry tries before the accumulator

__device__ __forceinline__ unsigned hash_slot(int c, int log2_slots) {
  return ((unsigned)c * 2654435761u) >> (32 - log2_slots);
}

__global__ void __launch_bounds__(kThreads)
csr_stats_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                 long long total, int n, int log2_slots, double* acc,
                 float* __restrict__ out_sum, float* __restrict__ out_sumsq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = 1 << log2_slots;
  double* tsum = reinterpret_cast<double*>(smem_raw);
  double* tsq = tsum + slots;
  int* keys = reinterpret_cast<int*>(tsq + slots);
  PHASE_START(threadIdx.x == 0, blockIdx.x);
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    keys[s] = -1;
    tsum[s] = 0.0;
    tsq[s] = 0.0;
  }
  __syncthreads();

  const long long share = (total + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * share;
  const long long hi = min(total, lo + share);
  for (long long e = lo + threadIdx.x; e < hi; e += blockDim.x) {
    const float v = vals[e];
    const int c = cols[e];
    if (v == 0.0f || c < 0 || c >= n) continue;
    const double d = (double)v;
    unsigned h = hash_slot(c, log2_slots);
    bool kept = false;
    for (int p = 0; p < kProbes; ++p) {
      const int k = atomicCAS(&keys[h], -1, c);
      if (k == -1 || k == c) {
        atomicAdd(&tsum[h], d);
        atomicAdd(&tsq[h], d * d);
        kept = true;
        break;
      }
      h = (h + 1) & (slots - 1);
    }
    if (!kept) {
      atomicAdd(&acc[2 * (long long)c], d);
      atomicAdd(&acc[2 * (long long)c + 1], d * d);
    }
  }
  __syncthreads();
  PHASE_MARK(threadIdx.x == 0, blockIdx.x, 2);    // scatter
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const int c = keys[s];
    if (c >= 0) {
      atomicAdd(&acc[2 * (long long)c], tsum[s]);
      atomicAdd(&acc[2 * (long long)c + 1], tsq[s]);
    }
  }
  PHASE_MARK(threadIdx.x == 0, blockIdx.x, 3);    // flush (thread 0's slots)

  cg::this_grid().sync();
  PHASE_MARK(threadIdx.x == 0, blockIdx.x, 4);    // grid_sync

  double2* pairs = reinterpret_cast<double2*>(acc);
  const int stride = gridDim.x * blockDim.x;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < n; c += stride) {
    const double2 p = __ldcg(pairs + c);          // L2: where the atomics landed
    out_sum[c] = (float)p.x;
    out_sumsq[c] = (float)p.y;
    __stcg(pairs + c, make_double2(0.0, 0.0));
  }
  PHASE_MARK(threadIdx.x == 0, blockIdx.x, 5);    // finish (thread 0's columns)
}

// CTAs of kThreads with `smem` bytes that the card holds at once (the
// cooperative launch's limit), cached for the last device and size: one
// 64-bit word (device + 1, smem, blocks), so concurrent callers read a
// whole entry or none.
int co_resident_blocks(size_t smem) {
  static std::atomic<unsigned long long> cache{0};
  int dev;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const unsigned long long key = ((unsigned long long)(dev + 1) << 48)
                                 | ((unsigned long long)smem << 16);
  const unsigned long long hit = cache.load(std::memory_order_relaxed);
  if ((hit & ~0xffffull) == key) return (int)(hit & 0xffff);
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
      || cudaFuncSetAttribute(csr_stats_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem) != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, csr_stats_kernel, kThreads, smem) != cudaSuccess)
    return 0;
  const int blocks = sms * per_sm;
  cache.store(key | (unsigned long long)blocks, std::memory_order_relaxed);
  return blocks;
}

}  // namespace

extern "C" {

// Launch on `stream`: `blocks` CTAs (clamped to what the card holds at
// once), a table of 2^log2_slots columns each.  Returns the cudaError_t of
// the launch (0 = success).
int csr_stats_launch(const void* vals, const void* cols, long long total, int n,
                     int blocks, int log2_slots, void* acc, void* out_sum,
                     void* out_sumsq, void* stream) {
  if (n <= 0 || total < 0 || blocks < 1 || log2_slots < 4 || log2_slots > 13)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)2 * sizeof(double) + sizeof(int)) << log2_slots;
  const int most = co_resident_blocks(smem);
  if (most < 1) return (int)cudaErrorInvalidConfiguration;
  if (blocks > most) blocks = most;
  const float* v = static_cast<const float*>(vals);
  const int* c = static_cast<const int*>(cols);
  double* a = static_cast<double*>(acc);
  float* s = static_cast<float*>(out_sum);
  float* q = static_cast<float*>(out_sumsq);
  void* args[] = {&v, &c, &total, &n, &log2_slots, &a, &s, &q};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)csr_stats_kernel, dim3(blocks), dim3(kThreads), args, smem,
      static_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

const char* csr_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
