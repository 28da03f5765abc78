// Stationary covariance tiles for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of gp_tpu/ops/pallas_kernels.py in
// every covariance form they evaluate (`form`, `_cov_from_sq`, :58-68):
//   K1  _se_tile_kernel_diag (:89-119)  symmetric K(X, X) with the diagonal
//       overwritten by dvals (sf2 + sn2 on real rows) -- WRITE_DIAG = true;
//   K2  _se_tile_kernel      (:71-86)   rectangular K(X1, X2) -- WRITE_DIAG
//       = false.
// Both compute, from rows already scaled by 1/lengthscale,
//   sq = max(|a|^2 + |b|^2 - 2 a.b, 0)
// in the quadratic-expansion form and order of gp_tpu's formula, then map
// it, as gp_tpu writes the map, by FORM:
//   SE   sf2 exp(-sq/2)                        (SE-ARD/iso)
//   M52  sf2 (1 + ar + ar^2/3) exp(-ar)        ar = sqrt(5) sqrt(sq + 1e-32)
//   M32  sf2 (1 + ar) exp(-ar)                 ar = sqrt(3) sqrt(sq + 1e-32)
//   RQ   sf2 exp(-alpha log1p(sq / (2 alpha))) alpha = *p1
// so the kernel and its plain version agree to rounding.  Each of the 16
// instantiations (4 forms x 2 types x WRITE_DIAG) replaces that TPU kernel
// in that form: M52/M32 back gp_tpu's matern_k[_noise]_pallas, RQ its
// rq_k[_noise]_pallas (:456-660).
//
// What bounds it: at the main path's d = 24 the kernel is store-bound in
// every form.  It writes N^2 values (N = 8000, f32: 256 MB, ~76 us at
// 3.35 TB/s) against 2 N^2 d flops of cross term (3.1 GFLOP, ~46 us at
// 67 TFLOP/s f32 without tensor cores); the Matern/RQ maps add about 10
// operations per entry (one sqrt or log1p and one exp), ~0.7 GFLOP, which
// leaves the store the bound.  So the design keeps every output written
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
// sf2, alpha and dvals are read from device memory, so one objective
// evaluation needs no host round trip before the factorization.
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

// covariance forms; the numbering is the C interface's `form` argument
constexpr int SE = 0;
constexpr int M52 = 1;
constexpr int M32 = 2;
constexpr int RQ = 3;

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float sqrt_t(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_t(double v) { return sqrt(v); }
__device__ __forceinline__ float log1p_t(float v) { return log1pf(v); }
__device__ __forceinline__ double log1p_t(double v) { return log1p(v); }
__device__ __forceinline__ float fma_t(float x, float y, float z) {
  return __fmaf_rn(x, y, z);
}
__device__ __forceinline__ double fma_t(double x, double y, double z) {
  return __fma_rn(x, y, z);
}

// gp_tpu's _cov_from_sq, operation for operation
template <typename T, int FORM>
__device__ __forceinline__ T cov_from_sq(T sq, T sf2, T p1) {
  if (FORM == SE) return sf2 * exp_t(T(-0.5) * sq);
  if (FORM == RQ) return sf2 * exp_t(-p1 * log1p_t(sq / (T(2) * p1)));
  const T A = FORM == M52 ? T(2.23606797749978969641)    // sqrt(5)
                          : T(1.73205080756887729353);   // sqrt(3)
  const T ar = A * sqrt_t(sq + T(1e-32));
  T poly = T(1) + ar;
  if (FORM == M52) poly = poly + ar * ar / T(3);
  return sf2 * poly * exp_t(-ar);
}

template <typename T, int FORM, bool WRITE_DIAG>
__global__ void __launch_bounds__(THREADS * THREADS)
se_tile(const T* __restrict__ a, const T* __restrict__ b,
        const T* __restrict__ sf2p, const T* __restrict__ p1p,
        const T* __restrict__ dvals, T* __restrict__ out, int64_t m,
        int64_t n, int64_t d) {
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
  const T p1 = FORM == RQ ? *p1p : T(0);
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
      T v = cov_from_sq<T, FORM>(sq, sf2, p1);
      if (WRITE_DIAG && row == col) v = dvals[row];
      out[row * n + col] = v;
    }
  }
}

template <typename T, int FORM>
void launch_form(dim3 grid, dim3 block, cudaStream_t s, const T* pa,
                 const T* pb, const T* ps, const T* pp, const T* pd, T* po,
                 int64_t m, int64_t n, int64_t d, int write_diag) {
  if (write_diag)
    se_tile<T, FORM, true><<<grid, block, 0, s>>>(pa, pb, ps, pp, pd, po,
                                                  m, n, d);
  else
    se_tile<T, FORM, false><<<grid, block, 0, s>>>(pa, pb, ps, pp, pd, po,
                                                   m, n, d);
}

template <typename T>
int launch(const void* a, const void* b, const void* sf2, const void* p1,
           const void* dvals, void* out, int64_t m, int64_t n, int64_t d,
           int form, int write_diag, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int64_t gy = (m + TILE - 1) / TILE;
  const int64_t gx = (n + TILE - 1) / TILE;
  if (gy > MAX_GRID_Y || d < 0 || form < SE || form > RQ ||
      (form == RQ && p1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(THREADS, THREADS);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* ps = static_cast<const T*>(sf2);
  const T* pp = static_cast<const T*>(p1);
  const T* pd = static_cast<const T*>(dvals);
  T* po = static_cast<T*>(out);
  switch (form) {
    case SE:
      launch_form<T, SE>(grid, block, s, pa, pb, ps, pp, pd, po, m, n, d,
                         write_diag);
      break;
    case M52:
      launch_form<T, M52>(grid, block, s, pa, pb, ps, pp, pd, po, m, n, d,
                          write_diag);
      break;
    case M32:
      launch_form<T, M32>(grid, block, s, pa, pb, ps, pp, pd, po, m, n, d,
                          write_diag);
      break;
    default:
      launch_form<T, RQ>(grid, block, s, pa, pb, ps, pp, pd, po, m, n, d,
                         write_diag);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (m, d), b (n, d): row-major, pre-scaled rows.  sf2: one value.
// p1: one value (RQ's alpha), read only when form == 3 (RQ); may be null
// otherwise.  form: 0 SE, 1 Matern-5/2, 2 Matern-3/2, 3 RQ.
// dvals (m,): read only when write_diag != 0 (then m == n and a == b).
// out (m, n) row-major.  Returns the cudaError_t of the launch.
extern "C" int se_tile_f32(const void* a, const void* b, const void* sf2,
                           const void* p1, const void* dvals, void* out,
                           int64_t m, int64_t n, int64_t d, int form,
                           int write_diag, void* stream) {
  return launch<float>(a, b, sf2, p1, dvals, out, m, n, d, form, write_diag,
                       stream);
}

extern "C" int se_tile_f64(const void* a, const void* b, const void* sf2,
                           const void* p1, const void* dvals, void* out,
                           int64_t m, int64_t n, int64_t d, int form,
                           int write_diag, void* stream) {
  return launch<double>(a, b, sf2, p1, dvals, out, m, n, d, form,
                        write_diag, stream);
}
