// Tensor-core Gram contraction shared by K3 (csr_gram.cu) and K6 (gram.cu).
//
// A CTA owns one kT x kT output tile (ta, tb), ta <= tb, of a Gram
// G = P^T P whose rows are the contraction dimension, or a partial of it
// over a subset of the rows.  Its warps hold the tile in mma.sync
// accumulators; each step contracts 8 rows of two shared-memory panels,
// Pa (the columns of tile ta) and Pb (those of tb; Pa itself on the
// diagonal), each row kT floats with an XOR swizzle (`pidx`) that makes
// every fragment load free of bank conflicts.
//
// Arithmetic, 3xTF32.  Each operand x is split as x = hi + lo with
// hi = rna_tf32(x) and lo = rna_tf32(x - hi) (x - hi is exact in
// float32), and each step of 8 rows sums lo*hi, hi*lo and hi*hi, in
// that order, from zero in the tensor core (lo*lo, <= 2^-22 |ab|, is
// dropped), then adds the step's sum to the float32 accumulator with a
// rounded add.  A TF32 product is exact in the tensor core, so the only
// rounding beyond float32 sums is lo's (<= 2^-22 |x|) and the tensor
// core's own within a step.  That is not round-to-nearest: summed in the
// tensor core across all the rows, a Gram of random floats drifted past
// the card test's bar of 1e-6 of its largest entry; a step's sum is
// small, and so is its drift.  An integer of at most 11 significant bits
// (every count up to 2048) is its own hi and has lo = 0, so on
// bag-of-words counts every product and partial sum is an integer below
// 2^24 and the result is exact in any order.
//
// Why mma.sync (m16n8k8, tf32) and not wgmma: wgmma takes TF32 operands
// only K-major, and both operands of a Gram come from row-major data
// whose rows are K; mma.sync fragments are loaded by hand from any
// layout, so the panels are staged as they lie in memory (cp.async of
// whole row segments) and no transpose is needed.  At the port's shapes
// the contraction is a few microseconds of tensor-core work; loads and
// latency, not the instruction's rate, set the time.
//
// Partial tiles.  Where the rows (K6) or the chunks (K3) of one tile are
// split over the CTAs of a thread-block cluster, the partial tiles are
// added through distributed shared memory in the CTAs' rank order, each
// CTA a strip of rows, so the result is the same bits on every run, in
// one launch.  The tile is written once, with its mirror below the
// diagonal, so the Gram is exactly symmetric.
#pragma once

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

// Phase marks: GRAM_TRACE(0) where a CTA starts, GRAM_TRACE(k) at the end
// of phase k.  Empty here; scripts/phase_trace.py builds copies that
// define it to record the clocks.
#ifndef GRAM_TRACE
#define GRAM_TRACE(col) ((void)0)
#endif

namespace gram_tc {

// Every piece below takes the tile edge kT (the panels' width).
constexpr int kMaxCluster = 8;    // CTAs a cluster may hold on every Hopper part

// Pitch of a staged output tile: rows stay 16-byte aligned (the cluster's
// float4 reads), and a column read by a warp (the mirror's) costs at most
// a 4-way bank conflict on a strip of a few rows.
__host__ __device__ constexpr int staged_pitch(int kT) { return kT + 4; }

// Element (r, c) of a kT-wide panel: XOR of column bits 3-4 with the row's
// low two bits, so the 32 lanes of a fragment load (rows r0 + t, columns
// c0 + g, t < 4, g < 8) hit 32 banks; 16-byte groups stay contiguous.
template <int kT>
__device__ __forceinline__ int pidx(int r, int c) {
  return r * kT + (c ^ ((r & 3) << 3));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; `bytes` below the size zero-fills the rest
// (0 copies nothing and writes zeros; `src` must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// cvt.rna.tf32.f32 in two integer operations: the same rounding, to the
// nearest 10-bit mantissa, ties away from zero (a carry rounds the
// exponent up), for finite x
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(__float_as_uint(x));
  lo = rna_tf32(__float_as_uint(x - __uint_as_float(hi)));
}

// d += a * b, a 16 x 8 (row), b 8 x 8 (col), TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and
// device, not on every launch; `done` holds, per device, the largest size
// set so far.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int (&done)[16]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 16 && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 16) done[dev] = bytes;
  return err;
}

// Launch `kernel` on `stream` in clusters of `cluster` consecutive CTAs.
template <typename... Params, typename... Args>
inline cudaError_t launch_clustered(void (*kernel)(Params...), int blocks, int threads,
                                    int smem, void* stream, int cluster, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// blockIdx-style index -> (ta, tb), ta <= tb, row-major over the upper
// triangle of n_tiles x n_tiles tiles
__device__ __forceinline__ void tile_coords(int tile, int n_tiles, int& ta, int& tb) {
  int rem = tile, a = 0;
  while (rem >= n_tiles - a) { rem -= n_tiles - a; ++a; }
  ta = a;
  tb = a + rem;
}

// One warp's (16 MI) x (8 NI) block of the output tile, at (m_off, n_off).
template <int kT, int MI, int NI>
struct WarpTile {
  static constexpr int kLd = staged_pitch(kT);
  float acc[MI][NI][4];

  __device__ __forceinline__ WarpTile() {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  }

  // On a diagonal tile, a block wholly below the diagonal is the mirror
  // of one above it: its warp computes nothing (and stages zeros).
  static __device__ __forceinline__ bool below_diagonal(int m_off, int n_off) {
    return n_off + 8 * NI - 1 < m_off;
  }

  // acc += Pa[k0:k0+8, m_off:...]^T Pb[k0:k0+8, n_off:...]
  __device__ __forceinline__ void step(const float* Pa, const float* Pb, int k0,
                                       int m_off, int n_off, int lane) {
    const int g = lane >> 2, t = lane & 3;
    uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int m = m_off + 16 * i + g;
      split_tf32(Pa[pidx<kT>(k0 + t, m)], ah[i][0], al[i][0]);
      split_tf32(Pa[pidx<kT>(k0 + t, m + 8)], ah[i][1], al[i][1]);
      split_tf32(Pa[pidx<kT>(k0 + t + 4, m)], ah[i][2], al[i][2]);
      split_tf32(Pa[pidx<kT>(k0 + t + 4, m + 8)], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int c = n_off + 8 * j + g;
      split_tf32(Pb[pidx<kT>(k0 + t, c)], bh[j][0], bl[j][0]);
      split_tf32(Pb[pidx<kT>(k0 + t + 4, c)], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(d, al[i], bh[j]);
        mma_tf32(d, ah[i], bl[j]);
        mma_tf32(d, ah[i], bh[j]);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] += d[k];
      }
  }

  // the accumulators into the staged tile E (kT x kLd floats)
  __device__ __forceinline__ void stage(float* E, int m_off, int n_off, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int r = m_off + 16 * i + g, c = n_off + 8 * j + 2 * t;
        E[r * kLd + c] = acc[i][j][0];
        E[r * kLd + c + 1] = acc[i][j][1];
        E[(r + 8) * kLd + c] = acc[i][j][2];
        E[(r + 8) * kLd + c + 1] = acc[i][j][3];
      }
  }
};

// Rows [a0, a1) of the staged tile into G (n x n, row-major) at
// (lo_a + a, lo_b + b), and their mirror at (lo_b + b, lo_a + a); on a
// diagonal tile only entries a <= b are read, so both halves come from
// one value.  Both passes write along G's rows.
template <int kT>
__device__ __forceinline__ void write_rows(const float* E, float* G, int n, int lo_a,
                                           int lo_b, bool diag, int a0, int a1) {
  constexpr int kLd = staged_pitch(kT);
  const int rows = a1 - a0;
  for (int e = threadIdx.x; e < rows * kT; e += blockDim.x) {
    const int a = a0 + e / kT, b = e % kT, ga = lo_a + a, gb = lo_b + b;
    if (ga < n && gb < n && (!diag || a <= b))
      G[(size_t)ga * n + gb] = E[a * kLd + b];
  }
  for (int e = threadIdx.x; e < rows * kT; e += blockDim.x) {
    const int b = e / rows, a = a0 + e % rows, ga = lo_a + a, gb = lo_b + b;
    if (ga < n && gb < n && (!diag || a <= b))
      G[(size_t)gb * n + ga] = E[a * kLd + b];
  }
}

// The partials of one tile, staged in the E of each CTA of a thread-block
// cluster (the cluster's CTAs are the tile's parts, ranked in part order),
// added through distributed shared memory: rank r adds the rows
// [a0, a1) = its strip of ceil(kT / ranks) rows, over ranks 0, 1, ... in
// turn, into its own E.  The cluster's barriers bracket the reads, so no
// CTA leaves while another still reads its E.  Call after every warp has
// staged its block.
template <int kT>
__device__ __forceinline__ void cluster_sum_strip(float* E, int& a0, int& a1) {
  namespace cg = cooperative_groups;
  constexpr int kLd = staged_pitch(kT);
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int strip = (kT + ranks - 1) / ranks;
  a0 = min(kT, rank * strip);
  a1 = min(kT, a0 + strip);
  cluster.sync();
  if (ranks > 1) {
    for (int q = threadIdx.x; q < (a1 - a0) * kT / 4; q += blockDim.x) {
      float4* p = reinterpret_cast<float4*>(E + (a0 + 4 * q / kT) * kLd + (4 * q) % kT);
      float4 x[kMaxCluster];    // every rank's load in flight before the adds
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k)
        if (k < ranks) x[k] = *cluster.map_shared_rank(p, k);
      float4 sum = x[0];
#pragma unroll
      for (int k = 1; k < kMaxCluster; ++k)
        if (k < ranks) {
          sum.x += x[k].x;
          sum.y += x[k].y;
          sum.z += x[k].z;
          sum.w += x[k].w;
        }
      *p = sum;       // only this rank reads its strip's rows
    }
  }
  cluster.sync();
}

}  // namespace gram_tc
