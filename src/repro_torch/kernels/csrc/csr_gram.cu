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
// chunk-local row, and an entry with a local column outside [0, n_hat)
// (the off-support sentinel), a row outside [0, R) or the value 0
// (padding) is dropped.  G is (n_hat, n_hat) float32.
//
// Design.  The TPU kernels densify a whole chunk into an (R, n_pad)
// scratch in VMEM (1 MB at n_pad 512); a Hopper block has 227 KB of
// shared memory.  Here a CTA of 16 warps owns one 128 x 128 output tile
// (i, j) of the upper triangle, one group of chunks and one row slab:
// grid = tiles x slabs x groups (kernels/csr_gram.py:plan_csr_gram), and
// a tile's chunk groups, at most 8, are one thread-block cluster.  Slabs
// interleave the rows (slab s takes rows r with r % slabs == s, as panel
// row r / slabs), so they share out the occupied rows whatever their
// order; there are as many as the two (R / slabs, 128) float32 panels
// need to fit shared memory beside the staging.  For each chunk of its
// group the CTA
//   1. streams the chunk's entries through shared memory by cp.async, in
//      pieces of 2,048 (16-byte copies when E % 4 == 0, else 4-byte
//      ones), 2 pieces in flight; each thread copies and then reads only
//      its own slots, so the stream needs no barrier;
//   2. adds each entry of its slab whose column falls in tile i or j into
//      the panels and notes the highest panel row it touched (the
//      entries need not be sorted by row).  A float add to shared memory
//      is a compare-and-swap loop on this card, so a thread's cells go in
//      one round of swaps (`add_cells`) rather than one loop each;
//   3. contracts panel_i^T panel_j over the occupied rows only (one past
//      the highest touched, rounded up to 8) on the tensor cores
//      (gram_tc.cuh: mma.sync, 3xTF32, each warp 32 x 32 outputs), and
//      zeroes those rows again for its next chunk.
// The cluster adds its CTAs' partial tiles in group (chunk) order through
// distributed shared memory, each CTA a strip of rows; the slabs' strips
// meet in a workspace, where the last to arrive adds them in slab order
// and writes the strip once with its mirror: G is exactly symmetric.
// Without duplicate (row, col) entries every panel cell receives at most
// one add and the result is the same bits on every run; duplicates are
// summed too (exactly, on integer counts), in the order the swaps land.
//
// What bounds it: the function needs the entries' bytes (12 per slot)
// and the sparse product's multiply-adds, 2 sum_r k_r^2 on the CUDA
// cores; at the streaming fit's shape (C 8, E 16,384, n_hat 220) the
// bytes bound, 0.00053 ms at 3.35 TB/s.  Its own arithmetic, the dense
// 3xTF32 contraction of the occupied rows (3 sum_c R_occ,c n_hat
// (n_hat + 1) operations on the tensor cores, 495 TFLOP/s), is under
// that too.  What the design does about it: each CTA reads only its own
// chunk, and 128-wide tiles in 4 slabs read the megabatch 12 times in
// all from L2 (64-wide tiles in 2 slabs, 20 times); it contracts only
// the occupied rows (about a third of R on NYTimes chunks); and the grid
// at that shape is 96 CTAs of one per SM, one wave.  What sets its time
// is the scan (the L2 reads and the swap rounds) and the adding of the
// partials across the cluster and the slabs, not the arithmetic.
//
// Contract: shapes, types and devices are checked by the Python wrapper,
// kernels/csr_gram.py, which also allocates the workspace and the arrival
// counters; the panels and the staging must fit a block's shared memory
// (checked here too).

#include <climits>

#include "gram_tc.cuh"

namespace {

using namespace gram_tc;

constexpr int kT = 128;                     // output tile edge
constexpr int kLd = staged_pitch(kT);       // pitch of the staged output tile
constexpr int kThreads = 512;               // 16 warps, each 32 x 32 outputs
constexpr int kPer = 4;                     // slots a thread copies per piece
constexpr int kPiece = kThreads * kPer;     // slots of a staged piece
constexpr int kStages = 3;                  // staged pieces, 2 in flight
constexpr int kStagingBytes = kStages * kPiece * 12;
constexpr int kSmemLimit = 232448 - 1024;   // dynamic: the rest is static
constexpr int kMaxSlabsLog2 = 3;
constexpr int kMaxSlabs = 1 << kMaxSlabsLog2;

// slot k of this thread's kPer slots in a piece
template <bool kVec>
__device__ __forceinline__ int slot(int k) {
  return kVec ? threadIdx.x * kPer + k : threadIdx.x + k * kThreads;
}

// this thread's slots of the piece at entry e0 into stage buffers
// (sv, sc, ss); slots at or past E are zero-filled (value 0: dropped)
template <bool kVec>
__device__ __forceinline__ void issue_piece(float* sv, int* sc, int* ss, const float* v,
                                            const int* c, const int* s, int E, int e0) {
  if (kVec) {
#pragma unroll
    for (int k = 0; k < kPer; k += 4) {
      const int o = slot<true>(k), e = e0 + o;
      const bool in = e < E;                // E % 4 == 0: all four or none
      cp_async16(sv + o, in ? v + e : v, in ? 16 : 0);
      cp_async16(sc + o, in ? c + e : c, in ? 16 : 0);
      cp_async16(ss + o, in ? s + e : s, in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int o = slot<false>(k), e = e0 + o;
      const bool in = e < E;
      cp_async4(sv + o, in ? v + e : v, in ? 4 : 0);
      cp_async4(sc + o, in ? c + e : c, in ? 4 : 0);
      cp_async4(ss + o, in ? s + e : s, in ? 4 : 0);
    }
  }
}

// smem[cell[j]] += add[j] for each bit j of `todo`.  Float adds to
// shared memory are compare-and-swap loops on this card; one loop per
// entry would wait out each swap's latency in turn, so all of a thread's
// cells go in one round of loads and swaps, and only the cells whose swap
// lost a race (another add landed first) go round again.
template <int N>
__device__ __forceinline__ void add_cells(float* smem, const int (&cell)[N],
                                          const float (&add)[N], unsigned todo) {
  while (todo) {
    const unsigned round = todo;
    unsigned seen[N], got[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (round >> j & 1u)
        seen[j] = __float_as_uint(*reinterpret_cast<volatile float*>(smem + cell[j]));
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (round >> j & 1u)
        got[j] = atomicCAS(reinterpret_cast<unsigned*>(smem + cell[j]), seen[j],
                           __float_as_uint(__uint_as_float(seen[j]) + add[j]));
#pragma unroll
    for (int j = 0; j < N; ++j)
      if ((round >> j & 1u) && got[j] == seen[j]) todo &= ~(1u << j);
  }
}

// The slabs of a tile meet here: each CTA holds, in rows [a0, a1) of E,
// its cluster's sum of that strip for its slab.  With one slab it writes
// the strip; otherwise it stores the strip in work[tile][slab], and the
// last of the slabs to arrive at the strip (a counter per tile and strip,
// zero at launch and reset by that CTA) adds them in slab order and
// writes it.
__device__ __forceinline__ void finish_strip(float* E, float* G, int n, int lo_i,
                                             int lo_j, bool diag, int a0, int a1,
                                             float* work, int* counters, int tile,
                                             int slab, int slabs, int strip) {
  __shared__ int s_last;
  if (slabs > 1) {
    float* tiles = work + (size_t)tile * slabs * kT * kT;
    for (int e = threadIdx.x; e < (a1 - a0) * kT; e += kThreads) {
      const int a = a0 + e / kT, b = e % kT;
      tiles[(size_t)slab * kT * kT + a * kT + b] = E[a * kLd + b];
    }
    __syncthreads();
    int* counter = counters + tile * kMaxCluster + strip;
    if (threadIdx.x == 0) {   // release the CTA's stores, acquire the other slabs'
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
      s_last = atomicAdd(counter, 1) == slabs - 1;
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    }
    __syncthreads();
    if (!s_last) return;
    for (int e = threadIdx.x; e < (a1 - a0) * kT; e += kThreads) {
      const int a = a0 + e / kT, b = e % kT;
      float x[kMaxSlabs];      // every slab's load in flight before the adds
#pragma unroll
      for (int k = 0; k < kMaxSlabs; ++k)
        if (k < slabs) x[k] = __ldcg(tiles + (size_t)k * kT * kT + a * kT + b);
      float sum = x[0];
#pragma unroll
      for (int k = 1; k < kMaxSlabs; ++k)
        if (k < slabs) sum += x[k];
      E[a * kLd + b] = sum;
    }
    if (threadIdx.x == 0) *counter = 0;
    __syncthreads();
  }
  write_rows<kT>(E, G, n, lo_i, lo_j, diag, a0, a1);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
csr_gram_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                const int* __restrict__ segs, int C, int E, int R, int n_hat,
                int n_tiles, int slabs_log2, int panel_rows, int groups,
                int chunks_per_group, float* __restrict__ G,
                float* __restrict__ work, int* __restrict__ counters) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_rows;        // one past the highest panel row touched
  const int slabs = 1 << slabs_log2;
  const int group = blockIdx.x % groups, tile_slab = blockIdx.x / groups;
  const int tile = tile_slab >> slabs_log2, slab = tile_slab & (slabs - 1);
  int ti, tj;
  tile_coords(tile, n_tiles, ti, tj);
  const bool diag = ti == tj;
  const int lo_i = ti * kT, lo_j = tj * kT;
  float* Pi = smem;
  float* Pj = diag ? smem : smem + panel_rows * kT;
  float* sv = smem + 2 * panel_rows * kT;
  int* sc = reinterpret_cast<int*>(sv + kStages * kPiece);
  int* ss = sc + kStages * kPiece;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m_off = (warp >> 2) * 32, n_off = (warp & 3) * 32;
  const bool idle = diag && WarpTile<kT, 2, 4>::below_diagonal(m_off, n_off);
  WarpTile<kT, 2, 4> wt;
  GRAM_TRACE(0);
  const int c_begin = group * chunks_per_group;
  const int c_end = min(C, c_begin + chunks_per_group);
  const int pieces = (E + kPiece - 1) / kPiece;
  const int panel_words = (diag ? 1 : 2) * panel_rows * kT;

  for (int c = c_begin; c < c_end; ++c) {
    const float* v = vals + (size_t)c * E;
    const int* cl = cols + (size_t)c * E;
    const int* sg = segs + (size_t)c * E;
    auto issue = [&](int p) {   // one commit group per piece, empty past the last
      if (p < pieces) {
        const int st = (p % kStages) * kPiece;
        issue_piece<kVec>(sv + st, sc + st, ss + st, v, cl, sg, E, p * kPiece);
      }
      cp_async_commit();
    };
    for (int p = 0; p < kStages - 1; ++p) issue(p);
    if (c == c_begin) {         // zero the panels while the first pieces land
      float4* z = reinterpret_cast<float4*>(smem);
      for (int k = threadIdx.x; k < panel_words / 4; k += kThreads)
        z[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (threadIdx.x == 0) s_rows = 0;
      __syncthreads();
    }
    int hi = 0;
    for (int p = 0; p < pieces; ++p) {
      cp_async_wait<kStages - 2>();   // piece p: this thread's own slots
      const int st = (p % kStages) * kPiece;
      int cell[2 * kPer];             // this thread's entries' panel cells
      float add[2 * kPer];
      unsigned todo = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int o = st + slot<kVec>(k);
        const float x = sv[o];
        const int col = sc[o], r = ss[o];
        const bool real = x != 0.f && (unsigned)col < (unsigned)n_hat &&
                          (unsigned)r < (unsigned)R && (r & (slabs - 1)) == slab;
        const int pr = r >> slabs_log2;
        const unsigned oi = (unsigned)(col - lo_i), oj = (unsigned)(col - lo_j);
        const bool in_i = real && oi < (unsigned)kT;
        const bool in_j = real && !diag && oj < (unsigned)kT;
        cell[2 * k] = (int)(Pi - smem) + pidx<kT>(pr, (int)oi);
        cell[2 * k + 1] = (int)(Pj - smem) + pidx<kT>(pr, (int)oj);
        add[2 * k] = add[2 * k + 1] = x;
        todo |= (in_i ? 1u : 0u) << (2 * k) | (in_j ? 1u : 0u) << (2 * k + 1);
        if (in_i || in_j) hi = max(hi, pr + 1);
      }
      add_cells(smem, cell, add, todo);
      issue(p + kStages - 1);         // into piece p - 1's slots, read already
    }
    cp_async_wait<0>();
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) atomicMax(&s_rows, hi);
    __syncthreads();
    const int rows = (s_rows + 7) & ~7;   // <= panel_rows, a multiple of 8
    GRAM_TRACE(2);                        // scan
    if (!idle)
      for (int k0 = 0; k0 < rows; k0 += 8) wt.step(Pi, Pj, k0, m_off, n_off, lane);
    if (c + 1 < c_end) {              // zero the touched rows for the next chunk
      __syncthreads();
      float4* zi = reinterpret_cast<float4*>(Pi);
      float4* zj = reinterpret_cast<float4*>(Pj);
      for (int k = threadIdx.x; k < rows * kT / 4; k += kThreads) {
        zi[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!diag) zj[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (threadIdx.x == 0) s_rows = 0;
      __syncthreads();
    }
  }
  __syncthreads();
  wt.stage(smem, m_off, n_off, lane);
  GRAM_TRACE(3);   // contract
  int a0, a1;
  cluster_sum_strip<kT>(smem, a0, a1);
  GRAM_TRACE(4);   // cluster_sum
  finish_strip(smem, G, n_hat, lo_i, lo_j, diag, a0, a1, work, counters, tile, slab,
               slabs, group);
  GRAM_TRACE(5);   // finish
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// 2^slabs_log2 slabs of `panel_rows` rows (a multiple of 8) must cover the
// R rows and `groups` groups (at most 8: one cluster) of
// `chunks_per_group` the C chunks; with more than one slab, `work` holds
// tiles * slabs * 128 * 128 floats and `counters` tiles * 8 zeroed ints.
int csr_gram_launch(const void* vals, const void* cols, const void* segs, int C, int E,
                    int R, int n_hat, int slabs_log2, int panel_rows, int groups,
                    int chunks_per_group, void* G, void* work, void* counters,
                    void* stream) {
  if (C < 1 || E < 0 || R < 1 || n_hat < 1 || slabs_log2 < 0 ||
      slabs_log2 > kMaxSlabsLog2 ||
      panel_rows < 8 || panel_rows % 8 != 0 ||
      ((long long)panel_rows << slabs_log2) < R || groups < 1 || groups > kMaxCluster ||
      chunks_per_group < 1 || (long long)groups * chunks_per_group < C ||
      (long long)(groups - 1) * chunks_per_group >= C ||
      (slabs_log2 > 0 && (!work || !counters)))
    return (int)cudaErrorInvalidValue;
  const long long smem_ll = 2LL * panel_rows * kT * sizeof(float) + kStagingBytes;
  if (smem_ll > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_ll;
  const int n_tiles = (n_hat + kT - 1) / kT;
  const long long blocks = ((long long)n_tiles * (n_tiles + 1) / 2 * groups) << slabs_log2;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(vals) |
                         reinterpret_cast<uintptr_t>(cols) |
                         reinterpret_cast<uintptr_t>(segs);
  const bool vec = E % 4 == 0 && (addr & 15) == 0;
  static int smem_set[2][16];
  auto kernel = vec ? csr_gram_kernel<true> : csr_gram_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem, smem_set[vec]);
  if (err != cudaSuccess) return (int)err;
  err = launch_clustered(kernel, (int)blocks, kThreads, smem, stream, groups,
                         static_cast<const float*>(vals), static_cast<const int*>(cols),
                         static_cast<const int*>(segs), C, E, R, n_hat, n_tiles,
                         slabs_log2, panel_rows, groups, chunks_per_group,
                         static_cast<float*>(G), static_cast<float*>(work),
                         static_cast<int*>(counters));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* csr_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
