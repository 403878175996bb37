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
// Design.  The recursion is sequential (each eta needs the w the previous
// step left), so one CTA runs it, as the TPU grid is (1,).  u, w and s
// live in shared memory; w = Y u0 is computed in the kernel by a
// fixed-order matvec (thread i sums q = 0 .. n-1 in order).  Each
// coordinate step: every thread computes the same scalar eta from
// shared memory, then the block does the axpy on w and meets at one
// barrier; the owner of w_i keeps its new w_i and u_i in registers and
// stores them at the next step, when nobody reads them (as K1 does).  A
// step whose eta equals u_i leaves w as it is.  R2 is a fixed-order block
// reduction, so runs are deterministic.  Every multiply and add rounds on
// its own (the build's --fmad=false), as in the plain version.
//
// Y is read by rows: Y[q, i] for the matvec and Y[i, q] for the axpy, so a
// warp reads consecutive addresses.  That reads column i as the TPU kernel
// does only because Y is symmetric, which it is on the path (X with row
// and column j zeroed; BCD keeps X symmetric): the wrapper's contract.
//
// What bounds it: latency.  A launch is a chain of sweeps * (n - 1)
// dependent steps, one barrier each (plus the matvec), so its time is
// that chain times a barrier and a shared-memory round trip, far above
// its bytes (n^2 + 3n values) or its operations (~2 n^2 (sweeps + 1)).
//
// Contract: Y (n, n) symmetric and contiguous, s and u0 (n,); blockDim a
// multiple of 32, at most 512, and (3n + 16) values within a block's
// shared memory (checked here); shapes, types and devices are checked by
// the Python wrapper, kernels/bcd_sweep.py.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kRedSlots = kMaxThreads / 32;
constexpr int kSmemLimit = 232448;

// Sum of one value per thread, in a fixed order; every thread gets the
// same total.  Starts with a barrier so `red` is free to reuse.
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
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
qp_sweep_kernel(const T* __restrict__ Y, const T* __restrict__ s_in,
                const T* __restrict__ u0, T lam, int j, int n, int sweeps,
                T* __restrict__ u_out, T* __restrict__ w_out,
                T* __restrict__ r2_out) {
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
int launch(const void* Y, const void* s, const void* u0, double lam, int j,
           int n, int sweeps, void* u_out, void* w_out, void* r2_out,
           int threads, cudaStream_t stream) {
  const size_t smem = (3 * (size_t)n + kRedSlots) * sizeof(T);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      qp_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  qp_sweep_kernel<T><<<1, threads, smem, stream>>>(
      static_cast<const T*>(Y), static_cast<const T*>(s),
      static_cast<const T*>(u0), (T)lam, j, n, sweeps, static_cast<T*>(u_out),
      static_cast<T*>(w_out), static_cast<T*>(r2_out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `lam` is rounded to the working type, as the plain version does.
int qp_sweep_launch(int dtype_bytes, const void* Y, const void* s,
                    const void* u0, double lam, int j, int n, int sweeps,
                    void* u_out, void* w_out, void* r2_out, int threads,
                    void* stream) {
  if (n < 1 || sweeps < 0 || threads <= 0 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 8)
    return launch<double>(Y, s, u0, lam, j, n, sweeps, u_out, w_out, r2_out,
                          threads, st);
  if (dtype_bytes == 4)
    return launch<float>(Y, s, u0, lam, j, n, sweeps, u_out, w_out, r2_out,
                         threads, st);
  return (int)cudaErrorInvalidValue;
}

const char* qp_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
