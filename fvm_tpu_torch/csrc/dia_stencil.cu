// dia_stencil: the two dispatched variants, wide and narrow.
//
// See dia_stencil.cuh for what it computes.  Compiled once per variant and
// element type: -DDIA_NARROW selects narrow, -DDIA_F64 double; the C entry
// point is dia_{wide,narrow}_{f32,f64}.  The wrapper takes wide from
// WIDE_MIN_ROWS rows on (ops/dia_kernel.py), narrow below.
//
// What bounds it.  On the fine level (1M rows) a call moves ~(D + 4) n
// words and is bound by HBM bytes; that takes ~18 KB in flight per SM
// (3.35 TB/s x ~0.7 us / 132).  On the coarse AMG levels (512 to 131K
// rows) the operator sits in L2 and the time is the kernel's chain of
// dependent memory round trips.  The first port of this kernel lost on
// both counts: a runtime-D offset loop (one coef/x round trip per offset,
// ~2 loads in flight per thread) and scalar loads.
//
// Design, both variants (each choice measured on an NVIDIA H100 80GB HBM3
// at 700 W; scripts/dia_ab.py times both against an earlier commit's
// kernel, and PERF.md holds the numbers):
// - The offset loop is unrolled at compile time (to DMAX = 4 or 16, with a
//   uniform k < D predicate) and every load of a thread's rows is issued
//   before the first product uses one: one round trip instead of ~D.
// - x, b and y may lie at any base address.  When any of them is not
//   16-byte aligned a uniform flag sends their accesses through scalar
//   loads and stores inside the same kernel; the ragged last group of rows
//   is predicated.
// - A plain one-group-per-thread grid, no persistence.
//
// wide (large levels): R consecutive rows per thread, 16-byte accesses.
//   For m = 1, R = 16 / sizeof(T) (4 in float32): coef and diag are one
//   16-byte load per offset, x, b and y one each; x at i + d is one more
//   where R divides d (the +-nx offsets), else two shifted in registers
//   (the +-1 offsets).  This keeps several times the bytes in flight per
//   thread that one row would (fine-level Jacobi 0.0130 ms against 0.0176
//   with one row).  For m >= 2, R = 1, so there wide compiles to the same
//   one-row-per-thread code as narrow: on the interleaved (n, 2) momentum
//   vectors one row per thread (0.0132 ms) beat R = 2 with float4 over two
//   rows (0.0158) and R = 4 (0.0149).
// narrow (small levels): one row per thread.  On a level that fits in a
//   few waves the chain per thread is the time: the wide variant's four
//   rows per thread (four IEEE divisions in Jacobi) cost more than its
//   wider loads save.
//
// A third design was measured and not kept (PERF.md): persistent CTAs fed
// by TMA bulk copies through a 3-stage shared-memory ring, the counterpart
// of the Pallas kernel's double-buffered halo DMA.  It lost to these two at
// every level of the 1024^2 cavity and on the 2048^2 and 4096^2 fine
// levels.

#include "dia_stencil.cuh"

#define DIRECT_THREADS 256

// the variant's names: C entry point and kernel (as profiles show it)
#ifdef DIA_NARROW
#define DIRECT_ENTRY DIA_ENTRY(dia_narrow)
#define DIRECT_KERNEL dia_narrow_kernel
#else
#define DIRECT_ENTRY DIA_ENTRY(dia_wide)
#define DIRECT_KERNEL dia_wide_kernel
#endif

template <typename T, int M>
__host__ __device__ constexpr int direct_rows() {
#ifdef DIA_NARROW
  return 1;
#else
  return M == 1 ? (int)(16 / sizeof(T)) : 1;
#endif
}

// K consecutive elements starting at element e0 of an array of `len`,
// 0 past its end; 16-byte vector loads when `vec`
template <typename T, int K>
__device__ __forceinline__ void load_span(const T* __restrict__ p,
                                          long long e0, long long len,
                                          bool vec, T* out) {
  if (vec) {
    vload<T, K>(p + e0, out);
  } else {
#pragma unroll
    for (int e = 0; e < K; ++e) out[e] = e0 + e < len ? p[e0 + e] : T(0);
  }
}

template <typename T, int M, int MODE, int DMAX>
__global__ void __launch_bounds__(DIRECT_THREADS)
DIRECT_KERNEL(const T* __restrict__ coef, long long ld,
              const T* __restrict__ diag, const T* __restrict__ x,
              const T* __restrict__ b, T* __restrict__ y, long long n,
              Offsets off, int D, T omega, int aligned) {
  constexpr int R = direct_rows<T, M>();  // rows per thread
  constexpr int E = R * M;                // elements per thread
  // R rows of coef and diag are one 16-byte vector
  constexpr bool VROW = R * sizeof(T) == 16;
  // R rows of x, b and y are whole 16-byte vectors
  constexpr bool VX = R > 1 && E * sizeof(T) % 16 == 0;
  const long long groups = (n + R - 1) / R;
  const long long step = (long long)gridDim.x * DIRECT_THREADS;
  for (long long g = (long long)blockIdx.x * DIRECT_THREADS + threadIdx.x;
       g < groups; g += step) {
    const long long i0 = g * R;
    const bool full = i0 + R <= n;
    const bool xvec = VX && full && aligned;
    T dg[R], xc[E], bb[E], c[DMAX][R], xs[DMAX][E];
    // every load of the group first ...
    load_span<T, R>(diag, i0, n, VROW && full, dg);
    load_span<T, E>(x, i0 * M, n * M, xvec, xc);
    if (MODE != 0) load_span<T, E>(b, i0 * M, n * M, xvec, bb);
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < D) {
        const int d = off.d[k];
        load_span<T, R>(coef + k * ld, i0, n, VROW && full, c[k]);
        const long long s = i0 + d;
        const int sh = ((d % R) + R) % R;  // s - sh is a multiple of R
        if (s >= 0 && s + R <= n) {
          if (VX && aligned && s - sh + (sh ? 2 * R : R) <= n) {
            if constexpr (VX)
              vload_rows<T, M, R>(x + (s - sh) * M, sh, xs[k]);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) xs[k][e] = x[s * M + e];
          }
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const bool in = s + r >= 0 && s + r < n;
#pragma unroll
            for (int j = 0; j < M; ++j)
              xs[k][r * M + j] = in ? x[(s + r) * M + j] : T(0);
          }
        }
      }
    }
    // ... then the arithmetic, in the plain version's order
    T out[E];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        T acc = dg[r] * xc[r * M + j];
#pragma unroll
        for (int k = 0; k < DMAX; ++k)
          if (k < D) acc = acc + c[k][r] * xs[k][r * M + j];
        out[r * M + j] = dia_finish<T, MODE>(acc, xc[r * M + j],
                                             MODE != 0 ? bb[r * M + j] : T(0),
                                             dg[r], omega);
      }
    }
    if (xvec) {
      vstore<T, E>(y + i0 * M, out);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (i0 * M + e < n * M) y[i0 * M + e] = out[e];
    }
  }
}

template <typename T, int M, int MODE, int DMAX>
static void launch(const T* coef, long long ld, const T* diag, const T* x,
                   const T* b, T* y, long long n, const Offsets& off, int D,
                   T omega, int aligned, cudaStream_t stream) {
  constexpr int R = direct_rows<T, M>();
  const long long groups = (n + R - 1) / R;
  long long blocks = (groups + DIRECT_THREADS - 1) / DIRECT_THREADS;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  DIRECT_KERNEL<T, M, MODE, DMAX>
      <<<(unsigned)blocks, DIRECT_THREADS, 0, stream>>>(
          coef, ld, diag, x, b, y, n, off, D, omega, aligned);
}

template <typename T, int M, int MODE>
static void launch_d(const T* coef, long long ld, const T* diag, const T* x,
                     const T* b, T* y, long long n, const Offsets& off, int D,
                     T omega, int aligned, cudaStream_t stream) {
  if (D <= 4)
    launch<T, M, MODE, 4>(coef, ld, diag, x, b, y, n, off, D, omega, aligned,
                          stream);
  else
    launch<T, M, MODE, MAX_OFFSETS>(coef, ld, diag, x, b, y, n, off, D, omega,
                                    aligned, stream);
}

template <typename T, int M>
static void launch_mode(const T* coef, long long ld, const T* diag,
                        const T* x, const T* b, T* y, long long n,
                        const Offsets& off, int D, int mode, T omega,
                        int aligned, cudaStream_t stream) {
  switch (mode) {
    case 0: launch_d<T, M, 0>(coef, ld, diag, x, b, y, n, off, D, omega, aligned, stream); break;
    case 1: launch_d<T, M, 1>(coef, ld, diag, x, b, y, n, off, D, omega, aligned, stream); break;
    default: launch_d<T, M, 2>(coef, ld, diag, x, b, y, n, off, D, omega, aligned, stream); break;
  }
}

extern "C" int DIRECT_ENTRY(const void* coef, long long ld, const void* diag,
                            const void* x, const void* b, void* y,
                            long long n, int m, const int* offsets, int D,
                            int mode, double omega, void* stream) {
  int rc = dia_check_args(coef, ld, diag, n, m, D, mode, b);
  if (rc != 0) return rc;
  if (n == 0) return 0;
  const Offsets off = dia_offsets(offsets, D);
  const int aligned =
      (((uintptr_t)x | (uintptr_t)b | (uintptr_t)y) & 15) == 0;
  const real* c = (const real*)coef;
  const real* dg = (const real*)diag;
  const real* xx = (const real*)x;
  const real* bb = (const real*)b;
  real* yy = (real*)y;
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
    case 1: launch_mode<real, 1>(c, ld, dg, xx, bb, yy, n, off, D, mode, (real)omega, aligned, s); break;
    case 2: launch_mode<real, 2>(c, ld, dg, xx, bb, yy, n, off, D, mode, (real)omega, aligned, s); break;
    default: launch_mode<real, 3>(c, ld, dg, xx, bb, yy, n, off, D, mode, (real)omega, aligned, s); break;
  }
  return (int)cudaGetLastError();
}
