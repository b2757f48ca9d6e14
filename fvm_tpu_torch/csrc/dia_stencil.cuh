// Fused DIA stencil for Hopper (sm_90a): what the two variants share.
//
// Replaces the TPU kernel fvm_tpu/ops/pallas_kernels.py:_dia_kernel
// (pl.pallas_call at line 218).  For each row i of an n-row operator with
// a set of D <= 16 signed offsets d_k:
//
//   Ax[i] = diag[i] * x[i] + sum_k coef[k, i] * x[i + d_k]   (x = 0 outside [0, n))
//
//   mode 0 (mv):       y = Ax
//   mode 1 (residual): y = b - Ax
//   mode 2 (jacobi):   y = x + omega * (b - Ax) / diag
//
// x, b and y are row-major (n, M), M = 1..3 right-hand sides, at any base
// address (element-aligned).  coef is (D, n) with a row stride ld that is a
// multiple of 32 elements and a 16-byte aligned base; diag is (n,) with a
// 16-byte aligned base.  The wrapper (ops/dia_kernel.py) checks all of it.
//
// dia_stencil.cu holds the two variants the wrapper chooses between by n
// alone (wide for large levels, narrow for small ones).
//
// Both are built with -fmad=false and sum in the plain version's order
// (diag term first, then the offsets in order, out-of-range x read as 0 and
// still added), so each agrees bit for bit with dia_stencil_plain.
//
// The source is compiled once per variant and element type: -DDIA_F64
// selects double, -DDIA_BF16 bfloat16 (dia_stencil_bf16.cu), and the C
// entry point carries the type in its name.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_OFFSETS 16
#define COEF_ALIGN 32  // elements: coef row stride granule

#if defined(DIA_BF16)
#include <cuda_bf16.h>
typedef __nv_bfloat16 real;
#define DIA_ENTRY(name) name##_bf16
#elif defined(DIA_F64)
typedef double real;
#define DIA_ENTRY(name) name##_f64
#else
typedef float real;
#define DIA_ENTRY(name) name##_f32
#endif

struct Offsets {
  int d[MAX_OFFSETS];
};

// y from the accumulated A x, in the plain version's order
template <typename T, int MODE>
__device__ __forceinline__ T dia_finish(T acc, T xc, T bb, T dg, T omega) {
  if (MODE == 0) return acc;
  if (MODE == 1) return bb - acc;
  return xc + omega * (bb - acc) / dg;
}

// The arguments every entry point takes; 0 when they are what the kernels
// take, else cudaErrorInvalidValue.
static inline int dia_check_args(const void* coef, long long ld,
                                 const void* diag, long long n, int m, int D,
                                 int mode, const void* b) {
  if (n < 0 || D < 0 || D > MAX_OFFSETS || m < 1 || m > 3 || mode < 0 ||
      mode > 2)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)coef & 15) || ((uintptr_t)diag & 15) ||
      (D > 0 && (ld % COEF_ALIGN != 0 || ld < n)))
    return (int)cudaErrorInvalidValue;
  if (mode != 0 && b == nullptr) return (int)cudaErrorInvalidValue;
  return 0;
}

// 16-byte vectors of a thread's rows: R = 16 / sizeof(T) consecutive rows
// (4 in float32, 2 in float64) of an (n, M) array are R M elements, M
// 16-byte accesses
template <typename T, int K>
struct alignas(16) Pack {
  T v[K];
};

template <typename T, int K>
__device__ __forceinline__ void vload(const T* p, T* out) {
  const Pack<T, K> w = *reinterpret_cast<const Pack<T, K>*>(p);
#pragma unroll
  for (int e = 0; e < K; ++e) out[e] = w.v[e];
}

template <typename T, int K>
__device__ __forceinline__ void vstore(T* p, const T* in) {
  Pack<T, K> w;
#pragma unroll
  for (int e = 0; e < K; ++e) w.v[e] = in[e];
  *reinterpret_cast<Pack<T, K>*>(p) = w;
}

template <typename T, int E, int SHIFT>
__device__ __forceinline__ void vload_shifted(const T* p, T* out) {
  T v[2 * E];
  vload<T, E>(p, v);
  vload<T, E>(p + E, v + E);
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = v[e + SHIFT];
}

// Rows [q + sh, q + sh + R) of an (., M) array whose row q starts at the
// 16-byte aligned p, 0 <= sh < R, R M elements a whole number of 16-byte
// vectors: one set of vectors when sh is 0, else two, shifted in
// registers (reads 2 R rows from p).
template <typename T, int M, int R>
__device__ __forceinline__ void vload_rows(const T* p, int sh, T* out) {
  constexpr int E = R * M;
  if (sh == 0) {
    vload<T, E>(p, out);
  } else if constexpr (R == 2) {
    vload_shifted<T, E, M>(p, out);
  } else if constexpr (R == 4) {
    if (sh == 1)
      vload_shifted<T, E, M>(p, out);
    else if (sh == 2)
      vload_shifted<T, E, 2 * M>(p, out);
    else
      vload_shifted<T, E, 3 * M>(p, out);
  }
}

static inline Offsets dia_offsets(const int* offsets, int D) {
  Offsets off;
  for (int k = 0; k < MAX_OFFSETS; ++k) off.d[k] = k < D ? offsets[k] : 0;
  return off;
}
