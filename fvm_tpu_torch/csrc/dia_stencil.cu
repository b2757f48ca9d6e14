// Fused DIA stencil for Hopper (sm_90a), float32 and float64.
//
// Replaces the TPU kernel fvm_tpu/ops/pallas_kernels.py:_dia_kernel
// (pl.pallas_call at line 218).  For each row i of an n-row operator with
// a static set of D <= 16 signed offsets:
//
//   Ax[i] = diag[i] * x[i] + sum_k coef[k, i] * x[i + off[k]]   (x = 0 outside [0, n))
//
//   mode 0 (mv):       y = Ax
//   mode 1 (residual): y = b - Ax
//   mode 2 (jacobi):   y = x + omega * (b - Ax) / diag
//
// x, b and y are row-major (n, m) with m = 1..3 right-hand sides; coef is
// (D, n) row-major.  The bound is memory traffic: each call reads diag,
// the D coefficient rows, x (and b) and writes y once, ~2(D+1)m flops per
// row.  One thread per row: coef[k, i] and diag[i] are loaded once per row
// and coalesced across the warp; the m right-hand sides accumulate in
// registers.  The x reads at i + off[k] are coalesced as well, and their
// reuse by neighbouring rows (offsets reach +-nx = 1024 rows at the 1M-cell
// cavity, so a shared-memory tile would be mostly halo) is left to the
// 50 MB L2, which holds the whole vector.
//
// Built with -fmad=false: each product and sum is rounded on its own, in
// the same order as the plain PyTorch version (diag term first, then the
// offsets in order), so the two agree bit for bit on the same inputs.
//
// C interface, bound with ctypes: the launcher copies the host offsets
// into the kernel's parameter block, launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

#define MAX_OFFSETS 16
#define THREADS 256

struct Offsets {
  int d[MAX_OFFSETS];
};

template <typename T, int M, int MODE>
__global__ void __launch_bounds__(THREADS)
dia_stencil_kernel(const T* __restrict__ coef, const T* __restrict__ diag,
                   const T* __restrict__ x, const T* __restrict__ b,
                   T* __restrict__ y, long long n, Offsets off, int D,
                   T omega) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const T dg = diag[i];
    T acc[M];
#pragma unroll
    for (int j = 0; j < M; ++j) acc[j] = dg * x[i * M + j];
    for (int k = 0; k < D; ++k) {
      const T ck = coef[(long long)k * n + i];
      const long long c = i + off.d[k];
      if (c >= 0 && c < n) {
#pragma unroll
        for (int j = 0; j < M; ++j) acc[j] = acc[j] + ck * x[c * M + j];
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T out;
      if (MODE == 0) {
        out = acc[j];
      } else if (MODE == 1) {
        out = b[i * M + j] - acc[j];
      } else {
        out = x[i * M + j] + omega * (b[i * M + j] - acc[j]) / dg;
      }
      y[i * M + j] = out;
    }
  }
}

template <typename T, int M, int MODE>
static void launch_one(const T* coef, const T* diag, const T* x, const T* b,
                       T* y, long long n, const Offsets& off, int D, T omega,
                       cudaStream_t stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  dia_stencil_kernel<T, M, MODE><<<(unsigned)blocks, THREADS, 0, stream>>>(
      coef, diag, x, b, y, n, off, D, omega);
}

template <typename T, int M>
static int launch_mode(const T* coef, const T* diag, const T* x, const T* b,
                       T* y, long long n, const Offsets& off, int D, int mode,
                       T omega, cudaStream_t stream) {
  switch (mode) {
    case 0: launch_one<T, M, 0>(coef, diag, x, b, y, n, off, D, omega, stream); break;
    case 1: launch_one<T, M, 1>(coef, diag, x, b, y, n, off, D, omega, stream); break;
    case 2: launch_one<T, M, 2>(coef, diag, x, b, y, n, off, D, omega, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename T>
static int dia_stencil(const void* coef, const void* diag, const void* x,
                       const void* b, void* y, long long n, int m,
                       const int* offsets, int D, int mode, double omega,
                       void* stream) {
  if (n < 0 || D < 0 || D > MAX_OFFSETS) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Offsets off;
  for (int k = 0; k < MAX_OFFSETS; ++k) off.d[k] = k < D ? offsets[k] : 0;
  const T* c = (const T*)coef;
  const T* dg = (const T*)diag;
  const T* xx = (const T*)x;
  const T* bb = (const T*)b;
  T* yy = (T*)y;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  switch (m) {
    case 1: rc = launch_mode<T, 1>(c, dg, xx, bb, yy, n, off, D, mode, (T)omega, s); break;
    case 2: rc = launch_mode<T, 2>(c, dg, xx, bb, yy, n, off, D, mode, (T)omega, s); break;
    case 3: rc = launch_mode<T, 3>(c, dg, xx, bb, yy, n, off, D, mode, (T)omega, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" int dia_stencil_f32(const void* coef, const void* diag,
                               const void* x, const void* b, void* y,
                               long long n, int m, const int* offsets, int D,
                               int mode, double omega, void* stream) {
  return dia_stencil<float>(coef, diag, x, b, y, n, m, offsets, D, mode,
                            omega, stream);
}

extern "C" int dia_stencil_f64(const void* coef, const void* diag,
                               const void* x, const void* b, void* y,
                               long long n, int m, const int* offsets, int D,
                               int mode, double omega, void* stream) {
  return dia_stencil<double>(coef, diag, x, b, y, n, m, offsets, D, mode,
                             omega, stream);
}
