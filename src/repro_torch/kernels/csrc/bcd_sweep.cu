// Box-QP coordinate descent for one BCD row update (kernel K7, the
// legacy per-row solver path) for Hopper.
//
// Replaces the TPU kernel of repro/kernels/bcd_sweep.py: `_qp_kernel`
// (launched by `qp_sweep_pallas`).  One launch runs `sweeps` passes of
// coordinate descent (11) with the closed-form step (13) on
//
//   min_u u^T Y u   s.t.  ||u - s||_inf <= lam,   u_j = u0_j (pinned)
//
// from u0, and returns u, w = Y u and R2 = u^T w.  Per coordinate i != j:
//
//   g = w_i - Y_ii u_i;  eta = clip(-g / Y_ii, s_i - lam, s_i + lam)  if Y_ii > 0
//                        eta = (g > 0 ? s_i - lam : s_i + lam)         otherwise
//   w += Y[:, i] (eta - u_i);  u_i = eta
//
// What bounds it: a dependency chain.  Each coordinate step needs the w
// the step before left, so a launch is sweeps * n dependent steps, and
// its time is that count times the latency of one step (a subtraction,
// the divide, the clamp's selects, d, and the multiply-add that brings the
// next coordinate's w up to date), far above its bytes (n^2 + 3n values
// in, 2n + 1 out) and its operations (~2 n^2 (sweeps + 1)).
//
// Design: one CTA, as the TPU grid is (1,), in one of two schemes that
// the size picks (kernels/bcd_sweep.py: `plan_qp_sweep`; no fallback):
//   WARP  (`qp_sweep_warp_kernel<T, NS>`; float32 n_pad <= 224, float64
//         <= 160, which every row update of the per-row fit is) one warp
//         and no barrier: K1's coordinate step (box_qp.cuh).  Index q
//         belongs to lane q % 32; u, w and s live in registers, NS =
//         n_pad / 32 slots a lane, a template parameter so the loops
//         unroll.  Y is copied once into shared memory, flat at stride n
//         as it lies in global memory, by one Hopper bulk copy
//         (`cp.async.bulk`, one mbarrier) of its 16-byte-aligned interior,
//         the bytes before the first and after the last 16-byte boundary
//         by plain loads (the copy needs 16-byte-aligned addresses and
//         sizes, which a row of n values has only for some n); the matvec
//         w0 = Y u0 starts when it has landed.  Copying in 8 chunks, each
//         taken by the matvec as it landed, was 1.0-3.0 us slower a
//         launch at n 24-128 and 1.9 us (2 %) faster at n 192 on the H100
//         (PERF.md), so one copy it is.  The coordinate loop is
//         software-pipelined for the warp's in-order issue: a step
//         fetches the next coordinate's operands first (its row, diagonal
//         and divisor; its u, s and w from their lane), runs its own chain
//         on the operands fetched a step earlier, and carries w_(i+1),
//         brought up to date by its own term, so no shuffle sits on the
//         chain; the axpy is w += Y[i] d with no select.  Coordinate j is
//         pinned: once the matvec is done, row j of the copy is set to
//         zero, and j's s is held at 0 and its divisor at 1, so its step
//         adds 0 d = 0 to w whatever row j of Y holds, and its u is never
//         written.  Lanes past n in the last slot read the next row's
//         values in the loop: their w is never read and never written out.
//   BLOCK (`qp_sweep_block_kernel<T>`; larger n, no path launches it)
//         min(512, n_pad) threads: u, w and s in shared memory, Y read from
//         global memory (L2), the block sharing each step's axpy and
//         meeting at one barrier a step (the owner of w_i keeps its new w_i
//         and u_i in registers and stores them at the next step, when
//         nobody reads them); a step whose eta equals u_i leaves w as it
//         is.  The WARP scheme replaced it at the fit's sizes: a barrier a
//         step took 225 ns a step at n 192 on the H100 (PERF.md).
//
// Exactness.  Built with --fmad=false, every multiply and add rounds on its
// own as in the plain version; the division is the IEEE one bit for bit
// (`Divisor`).  Both schemes reduce in one fixed order: w0_i sums q = 0 ..
// n - 1 in order; R2 is a shuffle-down tree per 32 indices, then the
// trees' totals in index order (WARP: its slots; BLOCK: its warps).  So at
// the sizes both take, they give the same bits for w and R2 (u may differ
// in the sign of a zero: WARP writes eta where d = 0, BLOCK keeps u_i),
// and runs are deterministic.  The plain version reduces in another order.
//
// Y is read by rows: Y[q, i] for the matvec and Y[i, q] for the axpy, so a
// warp reads consecutive addresses.  That reads column i as the TPU kernel
// does only because Y is symmetric, which it is on the path (X with row
// and column j zeroed; BCD keeps X symmetric): the wrapper's contract.
// Neither scheme needs row and column j to be zero.
//
// Contract: Y (n, n) symmetric and contiguous, s and u0 (n,); the
// scheme's shared memory within a block's (checked
// here); shapes, types and devices are checked by the Python wrapper,
// kernels/bcd_sweep.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "box_qp.cuh"
#include "phase_trace.cuh"

namespace {

constexpr int kMaxThreads = 512;              // BLOCK: threads of the CTA
constexpr int kRedSlots = kMaxThreads / 32;   // BLOCK: a warp's partial sum
constexpr int kSmemLimit = 232448;
constexpr int kMatvecRows = 4;    // WARP: rows of Y loaded at once by w0 = Y u0
template <typename T>
constexpr int kMaxSlots = sizeof(T) == 4 ? 7 : 5;   // WARP: n_pad 224 / 160

// ---------------------------------------------------------------- WARP

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory; `bar` completes when they have landed.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the first phase of `bar` to complete.
__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}"
      :: "r"(smem_addr(bar)), "r"(0u) : "memory");
}

// The n argument need not be a multiple of 32; NS = ceil(n / 32).
template <typename T, int NS>
__global__ void __launch_bounds__(32)
qp_sweep_warp_kernel(const T* __restrict__ Y, const T* __restrict__ s_in,
                     const T* __restrict__ u0, T lam, int j, int n,
                     int sweeps, T* __restrict__ u_out, T* __restrict__ w_out,
                     T* __restrict__ r2_out) {
  constexpr int n_pad = 32 * NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x;
  PHASE_START(lane == 0, blockIdx.x);
  // Y at the offset that puts its 16-byte boundaries on shared memory's,
  // then u0 for the matvec and 32 zero words: the look-ahead past the last
  // row reads up to n_pad + 2 words beyond Y.  Y's 16-byte-aligned
  // interior [head, body) comes in one bulk copy, the bytes around it by
  // plain loads.
  const size_t nn = (size_t)n * n, ybytes = nn * sizeof(T);
  const int shift = (int)(reinterpret_cast<uintptr_t>(Y) & 15);
  T* Ys = reinterpret_cast<T*>(smem_raw + shift);
  T* uv = Ys + nn;
  const size_t lead = (size_t)((16 - shift) & 15);
  const size_t head = lead < ybytes ? lead : ybytes;
  const size_t body = head + ((ybytes - head) & ~(size_t)15);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(&bar)), "r"(1u) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (body > head)
      bulk_copy(reinterpret_cast<char*>(Ys) + head,
                reinterpret_cast<const char*>(Y) + head,
                (uint32_t)(body - head), &bar);
  }
  for (size_t e = lane; e < head / sizeof(T); e += 32) Ys[e] = Y[e];
  for (size_t e = body / sizeof(T) + lane; e < nn; e += 32) Ys[e] = Y[e];
  T s[NS], u[NS], w[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    const int q = 32 * m + lane;
    s[m] = q < n && q != j ? s_in[q] : T(0);
    u[m] = q < n ? u0[q] : T(0);
    w[m] = T(0);
    uv[q] = u[m];
  }
  uv[n_pad + lane] = T(0);
  __syncwarp();
  PHASE_SPAN(lane == 0, blockIdx.x, 2);
  if (body > head) bar_wait(&bar);
  PHASE_SPAN(lane == 0, blockIdx.x, 3);

  // w0 = Y u0: Y's column i is its row i, over q in order; a block of
  // rows' loads before their multiply-adds.  The last slot's lanes past n
  // add 0.  Every sum starts at +0, so w is never -0.
  const bool tail_in = 32 * (NS - 1) + lane < n;
  int q = 0;
  for (; q + kMatvecRows <= n; q += kMatvecRows) {
    T uq[kMatvecRows], yq[kMatvecRows][NS];
#pragma unroll
    for (int e = 0; e < kMatvecRows; ++e) {
      uq[e] = uv[q + e];
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const T y = Ys[(q + e) * n + 32 * m + lane];
        yq[e][m] = m + 1 < NS || tail_in ? y : T(0);
      }
    }
#pragma unroll
    for (int e = 0; e < kMatvecRows; ++e)
#pragma unroll
      for (int m = 0; m < NS; ++m) w[m] += yq[e][m] * uq[e];
  }
  for (; q < n; ++q) {
    const T uq = uv[q];
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      const T y = Ys[q * n + 32 * m + lane];
      w[m] += (m + 1 < NS || tail_in ? y : T(0)) * uq;
    }
  }
  // The pinned coordinate's row of the copy to zero, whatever Y holds
  // there: step j then adds 0 d to w (see the header).
  __syncwarp();
  if (j >= 0 && j < n)
    for (int e = lane; e < n; e += 32) Ys[(size_t)j * n + e] = T(0);
  __syncwarp();
  PHASE_SPAN(lane == 0, blockIdx.x, 4);

  // Coordinate descent; coordinate j is pinned (see the header).  A step
  // first fetches every operand of the next coordinate that it does not
  // change itself, then runs its own chain on the operands fetched a step
  // earlier; wi, the w of the current coordinate, is carried the same
  // way: w_(i+1) is read from its lane before this step's axpy and
  // brought up to date with the step's own term, the very multiply and add
  // its lane does.  Where d is 0 the axpy adds +-0 to a w that is never
  // -0; the owner of u_i takes eta whenever i != j (with d = 0, eta equals
  // u_i up to the sign of a zero).  The slack past Y takes the look-ahead
  // beyond the last row.
  for (int sw = 0; sw < sweeps; ++sw) {
    T wi = __shfl_sync(kFull, w[0], 0);
    T ui = __shfl_sync(kFull, u[0], 0);
    T si = __shfl_sync(kFull, s[0], 0);
    const T* dgp = Ys;                    // &Y[i][i]
    const T* row = Ys + lane;             // &Y[i][lane]
    T y1 = dgp[0], xc = dgp[1];           // Y[i][i], Y[i][i + 1]
    Divisor<T> dy(j == 0 ? T(1) : y1);
    T xm[NS];
#pragma unroll
    for (int m = 0; m < NS; ++m) xm[m] = row[32 * m];
#pragma unroll
    for (int mi = 0; mi < NS; ++mi) {
      if (32 * mi >= n) break;
      const int lim = min(32, n - 32 * mi);
      // coordinate 32 mi + li; wn, un, sn: its successor's w, u, s
      auto step = [&](int li, T wn, T un, T sn) {
        const int i = 32 * mi + li;
        const T* dgn = dgp + n + 1;
        const T* rown = row + n;
        T xm_n[NS];
#pragma unroll
        for (int m = 0; m < NS; ++m) xm_n[m] = rown[32 * m];
        const T y1_n = dgn[0], xc_n = dgn[1];
        const Divisor<T> dy_n(i + 1 == j ? T(1) : y1_n);
        const bool own = lane == li && i != j;
        T eta;
        const T d = coordinate_step(wi, ui, si, y1, dy, lam, eta);
        wi = wn + xc * d;
        u[mi] = own ? eta : u[mi];
#pragma unroll
        for (int m = 0; m < NS; ++m) w[m] = w[m] + xm[m] * d;
        ui = un;
        si = sn;
        y1 = y1_n;
        dy = dy_n;
        xc = xc_n;
        dgp = dgn;
        row = rown;
#pragma unroll
        for (int m = 0; m < NS; ++m) xm[m] = xm_n[m];
      };
      for (int li = 0; li + 1 < lim; ++li)
        step(li, __shfl_sync(kFull, w[mi], li + 1),
             __shfl_sync(kFull, u[mi], li + 1),
             __shfl_sync(kFull, s[mi], li + 1));
      // the slot's last coordinate: its successor is the next slot's lane
      // 0, or there is none (the values then go unused)
      const int m1 = mi + 1 < NS ? mi + 1 : mi;
      if (mi + 1 < NS && lim == 32)
        step(lim - 1, __shfl_sync(kFull, w[m1], 0),
             __shfl_sync(kFull, u[m1], 0), __shfl_sync(kFull, s[m1], 0));
      else
        step(lim - 1, wi, ui, si);
    }
  }
  PHASE_SPAN(lane == 0, blockIdx.x, 5);

  // R2: a tree per slot, the slots' totals in slot order
  T R2 = T(0);
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    T v = T(0);
    if (32 * m + lane < n) v += u[m] * w[m];
    R2 += warp_tree(v);
  }
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    const int qo = 32 * m + lane;
    if (qo < n) {
      u_out[qo] = u[m];
      w_out[qo] = w[m];
    }
  }
  if (lane == 0) *r2_out = R2;
  PHASE_SPAN(lane == 0, blockIdx.x, 6);
  PHASE_MARK(lane == 0, blockIdx.x, 8);         // the launch's end
}

// --------------------------------------------------------------- BLOCK

// Sum of one value per thread, in a fixed order; every thread gets the
// same total.  Starts with a barrier so `red` is free to reuse.
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = T(0);
  const int nw = blockDim.x >> 5;
  for (int k = 0; k < nw; ++k) total += red[k];
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
qp_sweep_block_kernel(const T* __restrict__ Y, const T* __restrict__ s_in,
                      const T* __restrict__ u0, T lam, int j, int n,
                      int sweeps, T* __restrict__ u_out,
                      T* __restrict__ w_out, T* __restrict__ r2_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* u = reinterpret_cast<T*>(smem_raw);
  T* w = u + n;
  T* s = w + n;
  T* red = s + n;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < n; i += nt) {
    s[i] = s_in[i];
    u[i] = u0[i];
  }
  __syncthreads();
  // w = Y u0; Y[q, i] = Y[i, q], read along rows
  for (int i = tid; i < n; i += nt) {
    T acc = T(0);
    for (int q = 0; q < n; ++q) acc += Y[(size_t)q * n + i] * u[q];
    w[i] = acc;
  }
  __syncthreads();

  for (int sw = 0; sw < sweeps; ++sw) {
    int pend = -1;
    T pend_w = T(0), pend_u = T(0);
    for (int i = 0; i < n; ++i) {
      if (i == j) continue;                  // coordinate j is pinned
      if (pend >= 0) { w[pend] = pend_w; u[pend] = pend_u; pend = -1; }
      const T* Yi = Y + (size_t)i * n;
      const T y1 = Yi[i];
      const T ui = u[i];
      const T g = w[i] - y1 * ui;
      const T lo = s[i] - lam;
      const T hi = s[i] + lam;
      T eta;
      if (y1 > T(0)) {
        eta = -g / y1;
        eta = eta < lo ? lo : eta;
        eta = eta > hi ? hi : eta;
      } else {
        eta = g > T(0) ? lo : hi;
      }
      const T d = eta - ui;
      if (d != T(0)) {
        for (int q = tid; q < n; q += nt) {
          const T wq = w[q] + Yi[q] * d;
          if (q == i) { pend = q; pend_w = wq; pend_u = eta; }
          else w[q] = wq;
        }
      }
      __syncthreads();
    }
    if (pend >= 0) { w[pend] = pend_w; u[pend] = pend_u; }
    __syncthreads();
  }

  T part = T(0);
  for (int i = tid; i < n; i += nt) part += u[i] * w[i];
  const T r2 = block_sum(part, red);
  for (int i = tid; i < n; i += nt) {
    u_out[i] = u[i];
    w_out[i] = w[i];
  }
  if (tid == 0) *r2_out = r2;
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, T, int, int, int, T*,
                        T*, T*);

// qp_sweep_warp_kernel<T, ns>, for 1 <= ns <= kMaxSlots<T>
template <typename T, int NS = 1>
Kernel<T> warp_kernel(int ns) {
  if constexpr (NS > kMaxSlots<T>) {
    return nullptr;
  } else {
    return ns == NS ? qp_sweep_warp_kernel<T, NS> : warp_kernel<T, NS + 1>(ns);
  }
}

// scheme 0 (WARP): one warp; 1 (BLOCK): `threads` threads
template <typename T>
int launch(int scheme, const void* Y, const void* s, const void* u0,
           double lam, int j, int n, int sweeps, void* u_out, void* w_out,
           void* r2_out, int threads, cudaStream_t stream) {
  const size_t n_pad = (size_t)(n + 31) / 32 * 32;
  const bool warp = scheme == 0;
  const size_t smem = warp ? (n_pad * n_pad + n_pad + 32) * sizeof(T) + 16
                           : (3 * (size_t)n + kRedSlots) * sizeof(T);
  Kernel<T> kern = nullptr;
  if (warp)
    kern = warp_kernel<T>((int)(n_pad / 32));
  else if (scheme == 1)
    kern = qp_sweep_block_kernel<T>;
  if (kern == nullptr || smem > (size_t)kSmemLimit || (warp && threads != 32))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<1, threads, smem, stream>>>(
      static_cast<const T*>(Y), static_cast<const T*>(s),
      static_cast<const T*>(u0), (T)lam, j, n, sweeps, static_cast<T*>(u_out),
      static_cast<T*>(w_out), static_cast<T*>(r2_out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `lam` is rounded to the working type, as the plain version does.
int qp_sweep_launch(int dtype_bytes, int scheme, const void* Y, const void* s,
                    const void* u0, double lam, int j, int n, int sweeps,
                    void* u_out, void* w_out, void* r2_out, int threads,
                    void* stream) {
  if (n < 1 || sweeps < 0 || threads <= 0 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 8)
    return launch<double>(scheme, Y, s, u0, lam, j, n, sweeps, u_out, w_out,
                          r2_out, threads, st);
  if (dtype_bytes == 4)
    return launch<float>(scheme, Y, s, u0, lam, j, n, sweeps, u_out, w_out,
                         r2_out, threads, st);
  return (int)cudaErrorInvalidValue;
}

const char* qp_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
