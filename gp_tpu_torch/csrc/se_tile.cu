// Squared-exponential covariance tiles for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of gp_tpu/ops/pallas_kernels.py,
// "se" form:
//   K1  _se_tile_kernel_diag (:89-119)  symmetric K(X, X) with the diagonal
//       overwritten by dvals (sf2 + sn2 on real rows) -- WRITE_DIAG = true;
//   K2  _se_tile_kernel      (:71-86)   rectangular K(X1, X2) -- WRITE_DIAG
//       = false.
// Both compute, from rows already scaled by 1/lengthscale,
//   sq = max(|a|^2 + |b|^2 - 2 a.b, 0),   K = sf2 * exp(-0.5 sq)
// in the quadratic-expansion form and order of gp_tpu's formula, so the
// two agree to rounding.
//
// What bounds it: at the main path's d = 24 the kernel is store-bound.
// It writes N^2 values (N = 8000, f32: 256 MB, ~76 us at 3.35 TB/s)
// against 2 N^2 d flops of cross term (3.1 GFLOP, ~46 us at 67 TFLOP/s
// f32 without tensor cores).  So the design keeps every output written
// exactly once, straight from registers, with neighbouring threads on
// neighbouring columns.  The cross term and both row norms accumulate as
// plain FMAs in T: tensor cores would mean TF32 for f32 operands, which
// breaks the full-f32 products gp_tpu insists on (pallas_kernels.py:76-81).
//
// Layout: one block computes one 64 x 64 output tile with 16 x 16
// threads, 4 x 4 outputs per thread (rows ty + 16 i, columns tx + 16 j).
// The block stages chunks of 16 features of its 64 a-rows and 64 b-rows
// in shared memory, transposed, and masks its own ragged edges: no
// padding of rows or of d is needed (the TPU wrapper's padding to the
// (8, 128) tiling is a TPU layout matter).  Output offsets are int64,
// since N^2 passes 2^31 at N >= 46341.
//
// sf2 and dvals are read from device memory, so one objective evaluation
// needs no host round trip before the factorization.
//
// Later work: wgmma/TMA are not used (no tensor-core path in full f32);
// writing only the lower triangle of K1 would halve its stores.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 64;               // output tile edge
constexpr int THREADS = 16;            // threads per tile edge
constexpr int PER = TILE / THREADS;    // outputs per thread per edge
constexpr int KC = 16;                 // features staged per chunk
constexpr int64_t MAX_GRID_Y = 65535;

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float fma_t(float x, float y, float z) {
  return __fmaf_rn(x, y, z);
}
__device__ __forceinline__ double fma_t(double x, double y, double z) {
  return __fma_rn(x, y, z);
}

template <typename T, bool WRITE_DIAG>
__global__ void __launch_bounds__(THREADS * THREADS)
se_tile(const T* __restrict__ a, const T* __restrict__ b,
        const T* __restrict__ sf2p, const T* __restrict__ dvals,
        T* __restrict__ out, int64_t m, int64_t n, int64_t d) {
  __shared__ T as[KC][TILE + 1];
  __shared__ T bs[KC][TILE + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * THREADS + tx;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * TILE;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * TILE;

  T cross[PER][PER];
  T na[PER];
  T nb[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    na[i] = T(0);
    nb[i] = T(0);
#pragma unroll
    for (int j = 0; j < PER; ++j) cross[i][j] = T(0);
  }

  for (int64_t k0 = 0; k0 < d; k0 += KC) {
    // consecutive threads read consecutive features of one row
    for (int e = tid; e < TILE * KC; e += THREADS * THREADS) {
      const int r = e / KC;
      const int k = e % KC;
      const int64_t gk = k0 + k;
      const int64_t ga = row0 + r;
      const int64_t gb = col0 + r;
      as[k][r] = (ga < m && gk < d) ? a[ga * d + gk] : T(0);
      bs[k][r] = (gb < n && gk < d) ? b[gb * d + gk] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      T av[PER];
      T bv[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        av[i] = as[k][ty + THREADS * i];
        bv[i] = bs[k][tx + THREADS * i];
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        na[i] = fma_t(av[i], av[i], na[i]);
        nb[i] = fma_t(bv[i], bv[i], nb[i]);
#pragma unroll
        for (int j = 0; j < PER; ++j)
          cross[i][j] = fma_t(av[i], bv[j], cross[i][j]);
      }
    }
    __syncthreads();
  }

  const T sf2 = *sf2p;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int64_t row = row0 + ty + THREADS * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int64_t col = col0 + tx + THREADS * j;
      if (col >= n) continue;
      T sq = na[i] + nb[j] - T(2) * cross[i][j];
      sq = sq > T(0) ? sq : T(0);
      T v = sf2 * exp_t(T(-0.5) * sq);
      if (WRITE_DIAG && row == col) v = dvals[row];
      out[row * n + col] = v;
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* sf2, const void* dvals,
           void* out, int64_t m, int64_t n, int64_t d, int write_diag,
           void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int64_t gy = (m + TILE - 1) / TILE;
  const int64_t gx = (n + TILE - 1) / TILE;
  if (gy > MAX_GRID_Y || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(THREADS, THREADS);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* ps = static_cast<const T*>(sf2);
  const T* pd = static_cast<const T*>(dvals);
  T* po = static_cast<T*>(out);
  if (write_diag)
    se_tile<T, true><<<grid, block, 0, s>>>(pa, pb, ps, pd, po, m, n, d);
  else
    se_tile<T, false><<<grid, block, 0, s>>>(pa, pb, ps, pd, po, m, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (m, d), b (n, d): row-major, pre-scaled rows.  sf2: one value.
// dvals (m,): read only when write_diag != 0 (then m == n and a == b).
// out (m, n) row-major.  Returns the cudaError_t of the launch.
extern "C" int se_tile_f32(const void* a, const void* b, const void* sf2,
                           const void* dvals, void* out, int64_t m,
                           int64_t n, int64_t d, int write_diag,
                           void* stream) {
  return launch<float>(a, b, sf2, dvals, out, m, n, d, write_diag, stream);
}

extern "C" int se_tile_f64(const void* a, const void* b, const void* sf2,
                           const void* dvals, void* out, int64_t m,
                           int64_t n, int64_t d, int write_diag,
                           void* stream) {
  return launch<double>(a, b, sf2, dvals, out, m, n, d, write_diag, stream);
}
