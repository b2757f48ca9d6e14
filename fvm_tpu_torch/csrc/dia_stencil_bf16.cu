// dia_stencil in bfloat16: the narrow variant, one row per thread.
//
// See dia_stencil.cuh for what it computes.  Built with -DDIA_NARROW
// -DDIA_BF16 into the C entry point dia_narrow_bf16; the wrapper
// (ops/dia_kernel.py) sends every bfloat16 call here, at any n.  It serves
// AMG(precision="bf16"), whose cycle runs in bfloat16 (the JAX package's
// fvm_tpu/linear/amg.py:1144-1175, which hands the bfloat16 operands to
// the TPU kernel fvm_tpu/ops/pallas_kernels.py:_dia_kernel).
//
// Rounding, defined here and in dia_stencil_plain alike: every operand is
// read as bfloat16 and widened to float32 (exact), every product and sum
// is taken in float32 in the plain version's order (diag term first, then
// the offsets in order; -fmad=false, IEEE division), and the result is
// rounded to bfloat16 once, on the store (round to nearest even).  So the
// kernel equals the plain version bit for bit.
//
// What bounds it: bytes, as in float32, at 2 bytes a value: each call
// reads diag, D coefficient rows, x and b once and writes y once.  This
// first form is the simple one: all of a row's loads issued before its
// first product (the offset loop unrolled at compile time, DMAX = 4 or
// 16), scalar 2-byte loads.  Loads of 8 bf16 rows per thread (16 bytes,
// the float32 wide variant's design) are for a later change.

#include "dia_stencil.cuh"

#define BF16_THREADS 256

__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int M, int MODE, int DMAX>
__global__ void __launch_bounds__(BF16_THREADS)
dia_bf16_kernel(const __nv_bfloat16* __restrict__ coef, long long ld,
                const __nv_bfloat16* __restrict__ diag,
                const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ b,
                __nv_bfloat16* __restrict__ y, long long n, Offsets off,
                int D, float omega) {
  const long long step = (long long)gridDim.x * BF16_THREADS;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (long long i = (long long)blockIdx.x * BF16_THREADS + threadIdx.x;
       i < n; i += step) {
    // every load of the row first ...
    __nv_bfloat16 dg = diag[i], xc[M], bb[M], c[DMAX], xs[DMAX][M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      xc[j] = x[i * M + j];
      bb[j] = MODE != 0 ? b[i * M + j] : zero;
    }
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < D) {
        const long long s = i + off.d[k];
        const bool in = s >= 0 && s < n;
        c[k] = coef[k * ld + i];
#pragma unroll
        for (int j = 0; j < M; ++j) xs[k][j] = in ? x[s * M + j] : zero;
      }
    }
    // ... then float32 arithmetic in the plain version's order, one
    // rounding on the store
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float xj = widen(xc[j]);
      float acc = widen(dg) * xj;
#pragma unroll
      for (int k = 0; k < DMAX; ++k)
        if (k < D) acc = acc + widen(c[k]) * widen(xs[k][j]);
      y[i * M + j] = __float2bfloat16_rn(
          dia_finish<float, MODE>(acc, xj, widen(bb[j]), widen(dg), omega));
    }
  }
}

template <int M, int MODE, int DMAX>
static void launch(const __nv_bfloat16* coef, long long ld,
                   const __nv_bfloat16* diag, const __nv_bfloat16* x,
                   const __nv_bfloat16* b, __nv_bfloat16* y, long long n,
                   const Offsets& off, int D, float omega,
                   cudaStream_t stream) {
  long long blocks = (n + BF16_THREADS - 1) / BF16_THREADS;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  dia_bf16_kernel<M, MODE, DMAX><<<(unsigned)blocks, BF16_THREADS, 0,
                                   stream>>>(coef, ld, diag, x, b, y, n, off,
                                             D, omega);
}

template <int M, int MODE>
static void launch_d(const __nv_bfloat16* coef, long long ld,
                     const __nv_bfloat16* diag, const __nv_bfloat16* x,
                     const __nv_bfloat16* b, __nv_bfloat16* y, long long n,
                     const Offsets& off, int D, float omega,
                     cudaStream_t stream) {
  if (D <= 4)
    launch<M, MODE, 4>(coef, ld, diag, x, b, y, n, off, D, omega, stream);
  else
    launch<M, MODE, MAX_OFFSETS>(coef, ld, diag, x, b, y, n, off, D, omega,
                                 stream);
}

template <int M>
static void launch_mode(const __nv_bfloat16* coef, long long ld,
                        const __nv_bfloat16* diag, const __nv_bfloat16* x,
                        const __nv_bfloat16* b, __nv_bfloat16* y, long long n,
                        const Offsets& off, int D, int mode, float omega,
                        cudaStream_t stream) {
  switch (mode) {
    case 0: launch_d<M, 0>(coef, ld, diag, x, b, y, n, off, D, omega, stream); break;
    case 1: launch_d<M, 1>(coef, ld, diag, x, b, y, n, off, D, omega, stream); break;
    default: launch_d<M, 2>(coef, ld, diag, x, b, y, n, off, D, omega, stream); break;
  }
}

extern "C" int DIA_ENTRY(dia_narrow)(const void* coef, long long ld,
                                     const void* diag, const void* x,
                                     const void* b, void* y, long long n,
                                     int m, const int* offsets, int D,
                                     int mode, double omega, void* stream) {
  int rc = dia_check_args(coef, ld, diag, n, m, D, mode, b);
  if (rc != 0) return rc;
  if (n == 0) return 0;
  const Offsets off = dia_offsets(offsets, D);
  const real* c = (const real*)coef;
  const real* dg = (const real*)diag;
  const real* xx = (const real*)x;
  const real* bb = (const real*)b;
  real* yy = (real*)y;
  cudaStream_t s = (cudaStream_t)stream;
  const float om = (float)omega;
  switch (m) {
    case 1: launch_mode<1>(c, ld, dg, xx, bb, yy, n, off, D, mode, om, s); break;
    case 2: launch_mode<2>(c, ld, dg, xx, bb, yy, n, off, D, mode, om, s); break;
    default: launch_mode<3>(c, ld, dg, xx, bb, yy, n, off, D, mode, om, s); break;
  }
  return (int)cudaGetLastError();
}
