// Stationary covariance tiles for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of gp_tpu/ops/pallas_kernels.py in
// every covariance form they evaluate (`form`, `_cov_from_sq`, :58-68):
//   K1  _se_tile_kernel_diag (:89-119)  symmetric K(X, X) with the diagonal
//       overwritten by dvals (sf2 + sn2 on real rows) -- SYM = true;
//   K2  _se_tile_kernel      (:71-86)   rectangular K(X1, X2) -- SYM = false.
// Both compute, from rows already scaled by 1/lengthscale,
//   sq = max(|a|^2 + |b|^2 - 2 a.b, 0)      (NaN stays NaN)
// in the quadratic-expansion form and order of gp_tpu's formula, then map
// it, as gp_tpu writes the map, by FORM:
//   SE   sf2 exp(-sq/2)                        (SE-ARD/iso)
//   M52  sf2 (1 + ar + ar^2/3) exp(-ar)        ar = sqrt(5) sqrt(sq + 1e-32)
//   M32  sf2 (1 + ar) exp(-ar)                 ar = sqrt(3) sqrt(sq + 1e-32)
//   RQ   sf2 exp(-alpha log1p(sq / (2 alpha))) alpha = *p1
// so the kernel and its plain version agree to rounding.  The norms and
// the cross term are FMAs from feature 0 up, the order of the port's first
// tile kernel, so the builds are bit for bit that kernel's.  Each of the 32
// instantiations (4 forms x 2 types x K1/K2 x vector or scalar stores)
// replaces that TPU kernel in that form: M52/M32 back gp_tpu's
// matern_k[_noise]_pallas, RQ its rq_k[_noise]_pallas (:456-660).
//
// What bounds it: at the main path's d = 24 the least time is the store of
// N^2 values (N = 8000, f32: 256 MB, 77 us at 3.35 TB/s), above 2 N^2 d
// flops of cross term (3.1 GFLOP, 46 us at 67 TFLOP/s f32 without tensor
// cores) and ~10 operations an entry of map (one sqrt or log1p, one exp).
// The FMAs, the map and the stores all issue from the same warps, so the
// design keeps the instructions per output few and leaves two blocks an SM
// to overlap one tile's stores with another's FMAs:
//  - operands: the wrapper writes the scaled rows feature-major, (d, m)
//    with each feature's row 16-byte aligned, so a tile's rows of one
//    feature are 32 aligned 16-byte chunks.  They are copied with
//    cp.async (zero-filled past m) straight into the feature-major layout
//    the FMA loop reads.  (4-byte copies of row-major rows, one a value,
//    kept a tile waiting ~4 us at the main shape.)
//  - depth: up to KC = 32 features are staged at once (d = 24 in one
//    chunk, no zero-padded steps; deeper rows in chunks of 32 with a ragged
//    last one).  Each staged row's norm is summed once, by one thread.
//  - register tile: a thread holds RM rows x one 16-byte vector of columns
//    (16 x 4 in f32, 8 x 2 in f64).  Per feature it reads its rows as
//    16-byte broadcast loads and its columns as one 16-byte load: 5 loads
//    for 64 FMAs in f32.  The staged features are padded by one vector, so
//    the loads are aligned and conflict-free.  f64 takes 8 rows a thread,
//    8 warps a tile: its Matern and RQ maps (f64 sqrt, log1p, exp, divide)
//    are latency-bound and want the warps more than the loads.
//  - stores: each thread writes 16-byte vectors, evict-first (K is far
//    larger than L2), a warp 512 contiguous bytes a row.  Interior tiles
//    store with no bounds test; only edge tiles test, and only diagonal
//    tiles compare row with column.  Rows of K that are not 16-byte aligned
//    (n not a multiple of the vector, or a misaligned base) take the same
//    kernel with scalar stores (VEC = false), chosen by the C entry.  At
//    most 128 registers a thread, so two blocks share an SM.
//  - K1 is symmetric: it computes only the tiles on and below the
//    diagonal.  An off-diagonal tile is written at (i, j) from registers,
//    then through a shared-memory buffer, XOR-swizzled by 16-byte chunk so
//    that both its writes and its reads are conflict-free, at (j, i) as
//    rows of 16-byte vectors.  A diagonal tile computes its whole square:
//    its two halves come from the same staged rows, norms and FMAs in the
//    same order, so they agree exactly, and dvals go on its diagonal.  K1
//    is therefore exactly symmetric, with half the FMAs and maps of the
//    square at the same stores.  It still writes both triangles: the
//    gradient reads all of K (G o K, K @ ...).
//  - grid: one tile a block, 1-D; K1 decodes its lower-triangle tile (I, J)
//    from the block index in integers.  Output offsets are int64, since
//    N^2 passes 2^31 at N >= 46341.
// The cross term and both row norms accumulate as plain FMAs in T: tensor
// cores would mean TF32 for f32 operands, which breaks the full-f32
// products gp_tpu insists on (pallas_kernels.py:76-81).
//
// sf2, alpha and dvals are read from device memory, so one objective
// evaluation needs no host round trip before the factorization.
//
// Built with -DSE_TILE_PHASES (scripts/se_tile_bench.py --phases), thread
// 0 of each of the first 16384 blocks records clock64() at the end of
// each phase of its tile, and its SM, for phase_clock_copy(); the marks
// after the stores add a block barrier each.  Without it they are empty.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// covariance forms; the numbering is the C interface's `form` argument
constexpr int SE = 0;
constexpr int M52 = 1;
constexpr int M32 = 2;
constexpr int RQ = 3;

constexpr int KC = 32;     // features staged at once

// per type: VN values in a 16-byte vector; the tile is BM x BM with
// BM = 32 VN (a warp's row of vectors); RM rows of it per warp and thread
template <typename T> struct Cfg;
template <> struct Cfg<float> {
  static constexpr int VN = 4;
  static constexpr int RM = 16;
  static constexpr int MIN_BLOCKS = 2;
};
template <> struct Cfg<double> {
  static constexpr int VN = 2;
  static constexpr int RM = 8;
  static constexpr int MIN_BLOCKS = 2;
};

template <typename T> struct Shape {
  static constexpr int VN = Cfg<T>::VN;
  static constexpr int RM = Cfg<T>::RM;
  static constexpr int BM = 32 * VN;          // tile edge
  static constexpr int WARPS = BM / RM;
  static constexpr int NT = 32 * WARPS;       // threads
  static constexpr int BMP = BM + VN;         // staged feature stride
  static_assert(NT >= 2 * BM, "one thread per staged row's norm");
  // shared memory: the staged rows, and over them K1's transpose buffer;
  // then the norms
  static constexpr size_t STAGE = 2 * KC * BMP * sizeof(T);
  static constexpr size_t TRANS = BM * BM * sizeof(T);
  static constexpr size_t NORMS = (TRANS > STAGE ? TRANS : STAGE);
  static constexpr size_t SMEM = NORMS + 2 * BM * sizeof(T);
};

// 16-byte asynchronous copy to shared memory of the first `bytes` bytes
// at src, zeros after them (src is not read when bytes == 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ld_vec(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld_vec(const double* p, double* v) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void st_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st_vec(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
// 16-byte store to device memory, marked evict-first: K (256 MB at the
// main shape) is far larger than L2
__device__ __forceinline__ void st_out(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void st_out(double* p, const double* v) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

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

// One VN-wide run of a row: a vector store, or (VEC = false) scalar
// stores of the entries before column `lim`.
template <typename T, bool VEC>
__device__ __forceinline__ void store_run(T* p, const T* v, int64_t col,
                                          int64_t lim, bool full) {
  constexpr int VN = Cfg<T>::VN;
  if (VEC) {
    // n % VN == 0: a run is all inside or all outside
    if (full || col < lim) st_out(p, v);
  } else {
#pragma unroll
    for (int q = 0; q < VN; ++q)
      if (full || col + q < lim) p[q] = v[q];
  }
}

// Start the copies of features k0 .. k0 + kc of the tile's a-rows and
// b-rows into the staging buffers.  The operands are feature-major with
// 16-byte aligned feature rows, so a feature's BM rows of a tile are 32
// aligned 16-byte chunks; rows past m (n) are zero.
template <typename T>
__device__ __forceinline__ int chunk_bytes(int64_t rows_left) {
  constexpr int VN = Cfg<T>::VN;
  return static_cast<int>(rows_left <= 0 ? 0 : rows_left >= VN ? VN
                                                               : rows_left) *
         static_cast<int>(sizeof(T));
}
template <typename T>
__device__ __forceinline__ void stage(T* as, T* bs, const T* a, const T* b,
                                      int64_t m, int64_t n, int64_t lda,
                                      int64_t ldb, int64_t row0,
                                      int64_t col0, int64_t k0, int kc,
                                      int tid) {
  using S = Shape<T>;
  for (int e = tid; e < 32 * kc; e += S::NT) {
    const int k = e >> 5;
    const int c = (e & 31) * S::VN;
    const int na = chunk_bytes<T>(m - row0 - c);
    const int nb = chunk_bytes<T>(n - col0 - c);
    cp_async16(as + k * S::BMP + c,
               a + (k0 + k) * lda + (na ? row0 + c : 0), na);
    cp_async16(bs + k * S::BMP + c,
               b + (k0 + k) * ldb + (nb ? col0 + c : 0), nb);
  }
}

#ifdef SE_TILE_PHASES
__device__ unsigned long long phase_clock[16384 * 8];
__device__ __forceinline__ void phase_mark(int slot) {
  if (threadIdx.x == 0 && blockIdx.x < 16384) {
    phase_clock[blockIdx.x * 8 + slot] = clock64();
    if (slot == 0) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      phase_clock[blockIdx.x * 8 + 7] = sm;
    }
  }
}
#define PHASE(p) phase_mark(p)
#define PHASE_SYNC(p) (__syncthreads(), phase_mark(p))
#else
#define PHASE(p) ((void)0)
#define PHASE_SYNC(p) ((void)0)
#endif

// One output tile a block.  K2's tile t is (t / tn, t % tn); K1's walks
// the lower triangle row by row, t = I (I + 1) / 2 + J with J <= I.
template <typename T, int FORM, bool SYM, bool VEC>
__global__ void __launch_bounds__(Shape<T>::NT, Cfg<T>::MIN_BLOCKS)
se_tile(const T* __restrict__ a, const T* __restrict__ b,
        const T* __restrict__ sf2p, const T* __restrict__ p1p,
        const T* __restrict__ dvals, T* __restrict__ out, int64_t m,
        int64_t n, int64_t d, int64_t lda, int64_t ldb) {
  using S = Shape<T>;
  constexpr int VN = S::VN, RM = S::RM, BM = S::BM, BMP = S::BMP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);      // [KC][BMP], feature-major
  T* bs = as + KC * BMP;
  T* tb = as;                                  // K1: [BM][BM], swizzled
  T* norms = reinterpret_cast<T*>(smem_raw + S::NORMS);  // a-rows, b-rows

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  PHASE(0);
  const int64_t t = blockIdx.x;
  int64_t I, J;
  if (SYM) {
    I = static_cast<int64_t>((sqrt(8.0 * static_cast<double>(t) + 1.0) -
                              1.0) / 2.0);
    while (I * (I + 1) / 2 > t) --I;
    while ((I + 1) * (I + 2) / 2 <= t) ++I;
    J = t - I * (I + 1) / 2;
  } else {
    const int64_t tn = (n + BM - 1) / BM;
    I = t / tn;
    J = t - I * tn;
  }
  const int64_t row0 = I * BM;
  const int64_t col0 = J * BM;

  T acc[RM][VN];
#pragma unroll
  for (int s = 0; s < RM; ++s)
#pragma unroll
    for (int q = 0; q < VN; ++q) acc[s][q] = T(0);
  // thread tid < BM sums the norm of a-row tid, the next BM threads that
  // of b-row tid - BM, in the order of the cross term
  T nrm = T(0);
  const T* own = tid < BM ? as + tid : bs + (tid < 2 * BM ? tid - BM : 0);
  for (int64_t k0 = 0; k0 < d; k0 += KC) {
    const int kc = static_cast<int>(d - k0 < KC ? d - k0 : KC);
    stage(as, bs, a, b, m, n, lda, ldb, row0, col0, k0, kc, tid);
    cp_async_wait_all();
    __syncthreads();
    PHASE(1);
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      T av[RM];
      T bv[VN];
#pragma unroll
      for (int s = 0; s < RM; s += VN)
        ld_vec(as + k * BMP + warp * RM + s, av + s);
      ld_vec(bs + k * BMP + lane * VN, bv);
      const T x = own[k * BMP];
      nrm = fma_t(x, x, nrm);
#pragma unroll
      for (int s = 0; s < RM; ++s)
#pragma unroll
        for (int q = 0; q < VN; ++q)
          acc[s][q] = fma_t(av[s], bv[q], acc[s][q]);
    }
    __syncthreads();
  }
  PHASE(2);
  if (tid < 2 * BM) norms[tid] = nrm;
  __syncthreads();

  // the map, in place
  const T sf2 = *sf2p;
  const T p1 = FORM == RQ ? *p1p : T(0);
  T nb[VN];
#pragma unroll
  for (int q = 0; q < VN; ++q) nb[q] = norms[BM + lane * VN + q];
#pragma unroll
  for (int s = 0; s < RM; ++s) {
    const T na = norms[warp * RM + s];
#pragma unroll
    for (int q = 0; q < VN; ++q) {
      T sq = na + nb[q] - T(2) * acc[s][q];
      // the clamp keeps a NaN, as jnp.maximum and torch.clamp do: an
      // infinite 1/lengthscale must give a NaN K (an INF objective), not
      // a finite one
      sq = sq < T(0) ? T(0) : sq;
      acc[s][q] = cov_from_sq<T, FORM>(sq, sf2, p1);
    }
  }
  if (SYM && I == J) {
#pragma unroll
    for (int s = 0; s < RM; ++s)
#pragma unroll
      for (int q = 0; q < VN; ++q) {
        const int64_t row = row0 + warp * RM + s;
        if (row == col0 + lane * VN + q && row < m) acc[s][q] = dvals[row];
      }
  }

  PHASE(3);
  // (i, j): thread row warp * RM + s, columns lane * VN ...
  const bool full = row0 + BM <= m && col0 + BM <= n;
  const int64_t col = col0 + lane * VN;
#pragma unroll
  for (int s = 0; s < RM; ++s) {
    const int64_t row = row0 + warp * RM + s;
    if (full || row < m)
      store_run<T, VEC>(out + row * n + col, acc[s], col, n, full);
  }
  PHASE_SYNC(4);
  if (!SYM || I == J) {
    PHASE(5);
    return;
  }

  // (j, i) through the buffer, which overlays the staged rows (last read
  // before the norms' barrier): element (column c, tile row i) at chunk
  // (i / VN) ^ key(c) of buffer row c, key(c) = (c / VN) & 7.  The eight
  // lanes of a 16-byte access phase write eight rows with eight keys, and
  // a warp reads one row's 32 chunks: no bank conflicts either way.
#pragma unroll
  for (int q = 0; q < VN; ++q) {
    const int c = lane * VN + q;
#pragma unroll
    for (int j = 0; j < RM / VN; ++j) {
      T v[VN];
#pragma unroll
      for (int e = 0; e < VN; ++e) v[e] = acc[j * VN + e][q];
      const int chunk = (warp * RM / VN + j) ^ (lane & 7);
      st_vec(tb + c * BM + chunk * VN, v);
    }
  }
  __syncthreads();
  const int64_t tcol = row0 + lane * VN;
#pragma unroll 4
  for (int i = 0; i < RM; ++i) {               // RM rows of (j, i) a warp
    const int c = warp * RM + i;
    const int64_t trow = col0 + c;
    if (!full && trow >= n) continue;
    T v[VN];
    ld_vec(tb + c * BM + (lane ^ ((c / VN) & 7)) * VN, v);
    store_run<T, VEC>(out + trow * n + tcol, v, tcol, m, full);
  }
  PHASE_SYNC(5);
}

template <typename T, int FORM, bool SYM, bool VEC>
int launch_one(int64_t tiles, cudaStream_t s, const T* pa, const T* pb,
               const T* ps, const T* pp, const T* pd, T* po, int64_t m,
               int64_t n, int64_t d, int64_t lda, int64_t ldb) {
  constexpr size_t bytes = Shape<T>::SMEM;
  auto kern = se_tile<T, FORM, SYM, VEC>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<static_cast<unsigned>(tiles), Shape<T>::NT, bytes, s>>>(
      pa, pb, ps, pp, pd, po, m, n, d, lda, ldb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int FORM>
int launch_form(int64_t tiles, bool sym, bool vec, cudaStream_t s,
                const T* pa, const T* pb, const T* ps, const T* pp,
                const T* pd, T* po, int64_t m, int64_t n, int64_t d,
                int64_t lda, int64_t ldb) {
  if (sym)
    return vec ? launch_one<T, FORM, true, true>(tiles, s, pa, pb, ps, pp,
                                                 pd, po, m, n, d, lda, ldb)
               : launch_one<T, FORM, true, false>(tiles, s, pa, pb, ps, pp,
                                                  pd, po, m, n, d, lda, ldb);
  return vec ? launch_one<T, FORM, false, true>(tiles, s, pa, pb, ps, pp, pd,
                                                po, m, n, d, lda, ldb)
             : launch_one<T, FORM, false, false>(tiles, s, pa, pb, ps, pp,
                                                 pd, po, m, n, d, lda, ldb);
}

template <typename T>
int launch(const void* a, const void* b, const void* sf2, const void* p1,
           const void* dvals, void* out, int64_t m, int64_t n, int64_t d,
           int64_t lda, int64_t ldb, int form, int write_diag,
           void* stream) {
  constexpr int BM = Shape<T>::BM;
  if (m <= 0 || n <= 0) return 0;
  const int64_t tm = (m + BM - 1) / BM;
  const int64_t tn = (n + BM - 1) / BM;
  // K1: the tiles on and below the diagonal
  const int64_t tiles = write_diag ? tm * (tm + 1) / 2 : tm * tn;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (d < 0 || form < SE || form > RQ || (form == RQ && p1 == nullptr) ||
      (write_diag && (m != n || a != b || dvals == nullptr)) ||
      lda < m || ldb < n || lda % Cfg<T>::VN ||
      ldb % Cfg<T>::VN || misaligned(a) || misaligned(b) ||
      tiles > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte stores need every row of K 16-byte aligned
  const bool vec = n % Cfg<T>::VN == 0 && !misaligned(out);
  const bool sym = write_diag != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* ps = static_cast<const T*>(sf2);
  const T* pp = static_cast<const T*>(p1);
  const T* pd = static_cast<const T*>(dvals);
  T* po = static_cast<T*>(out);
  switch (form) {
    case SE:
      return launch_form<T, SE>(tiles, sym, vec, s, pa, pb, ps, pp, pd, po,
                                m, n, d, lda, ldb);
    case M52:
      return launch_form<T, M52>(tiles, sym, vec, s, pa, pb, ps, pp, pd, po,
                                 m, n, d, lda, ldb);
    case M32:
      return launch_form<T, M32>(tiles, sym, vec, s, pa, pb, ps, pp, pd, po,
                                 m, n, d, lda, ldb);
    default:
      return launch_form<T, RQ>(tiles, sym, vec, s, pa, pb, ps, pp, pd, po,
                                m, n, d, lda, ldb);
  }
}

}  // namespace

// a (d, lda), b (d, ldb): the pre-scaled rows feature-major (column r of a
// is row r of X1; columns from m (n) on are not read), lda (ldb) at least
// m (n) and a multiple of 4; 16-byte aligned.  sf2: one value.  p1: one value (RQ's
// alpha), read only when form == 3 (RQ); may be null otherwise.  form: 0
// SE, 1 Matern-5/2, 2 Matern-3/2, 3 RQ.  dvals (m,): read only when
// write_diag != 0 (then m == n and a == b).  out (m, n) row-major.
// Returns the cudaError_t of the launch.
extern "C" int se_tile_f32(const void* a, const void* b, const void* sf2,
                           const void* p1, const void* dvals, void* out,
                           int64_t m, int64_t n, int64_t d, int64_t lda,
                           int64_t ldb, int form, int write_diag,
                           void* stream) {
  return launch<float>(a, b, sf2, p1, dvals, out, m, n, d, lda, ldb, form,
                       write_diag, stream);
}

extern "C" int se_tile_f64(const void* a, const void* b, const void* sf2,
                           const void* p1, const void* dvals, void* out,
                           int64_t m, int64_t n, int64_t d, int64_t lda,
                           int64_t ldb, int form, int write_diag,
                           void* stream) {
  return launch<double>(a, b, sf2, p1, dvals, out, m, n, d, lda, ldb, form,
                        write_diag, stream);
}

#ifdef SE_TILE_PHASES
extern "C" int phase_clock_copy(void* dst, size_t bytes) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, phase_clock, bytes));
}
#endif
