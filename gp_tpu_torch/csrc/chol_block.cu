// Block Cholesky kernels for Hopper (sm_90a): the base cases of the blocked
// factorization (ops/blocked.py).
//
// Replaces the three Pallas TPU kernels of gp_tpu/ops/pallas_chol.py:
//   K3  _chol_inv_kernel   (:180)  (L, T = L^-1) of one b x b block in one
//       launch: the right-looking rank-1 loop with the forward substitution
//       on the identity interleaved -- chol_inv_reg<T> for b <= 128 (the
//       blocked factorization's leaf), chol_rank1<T, PACKED, INV = true>
//       above;
//   K4  _chol_kernel       (:41)   L alone by the same loop --
//       chol_rank1<T, PACKED, INV = false>;
//   K5  _chol_panel_kernel (:87)   L by left-looking rank-w micro-panels:
//       per panel one GEMM C = K[:, p:p+w] - L L[p:p+w, :]^T, computed
//       here with shared-memory tiles, then a w-step rank-1 loop on the
//       panel -- chol_panel<T>.
//
// Step j of the rank-1 loop, as gp_tpu writes it (pallas_chol.py:199-221):
// d = A[j, j]; L[:, j] = A[:, j] / sqrt(d) below the pivot; A -= L[:, j]
// L[:, j]^T on the trailing part; row j of T is scaled by 1 / sqrt(d) and
// T[i, :] -= L[i, j] T[j, :] is pushed into the rows below.  The pivot is
// d (1 / sqrt(d)) in K3/K4 (gp_tpu's d * rsqrt(d)) and d / sqrt(d) in K5:
// a zero pivot gives NaN either way (0 inf, 0 / 0), a negative one too
// (sqrt(< 0)), and the NaN reaches every later column through the
// trailing update -- gp_tpu's failure contract (chol_ok reads a NaN
// diagonal).  Full-precision FMAs only: no tensor cores, so no TF32.
// Offsets into device memory are int64.
//
// What bounds them: neither bytes nor operations.  Each kernel is ONE
// block (one SM of 132) walking b serial steps, one barrier each (K3/K4);
// at the path's b = 128 a launch does b^3/3 (K4) or 2 b^3/3 (K3) flops,
// microseconds of work at the card's rate.  What sets the time is the
// b serial steps and what each step costs on the one SM: for chol_rank1
// its shared-memory traffic (three accesses per update); for
// chol_inv_reg, whose update is ~35 instructions a warp, the chain from
// one barrier to the next -- the shared loads, the live warps' FMAs
// sharing the SM's four schedulers, the pivot's 1 / sqrt(d) and the
// barrier itself.  The blocked factorization runs 64 K3 leaves one after
// another at N = 8192.  Measured times: PERF.md, section 6.
//
// Shared memory (chol_rank1).  The working matrix A and the inverse T are
// triangular, so each is held as its packed lower triangle, b(b+1)/2
// entries, beside one b-vector (the pivots' 1 / sqrt(d)).  At b = 128
// that is 133 KB in f64 for K3 -- the full squares, 2 x 128 KB, would not
// fit in the 227 KB a block may take.  Where even the packed triangles do
// not fit (K3 at b = 200 in f64, K4 at b = 1024), the same loop runs on
// the output buffers in device memory (PACKED = false: A in L, T in T,
// full row-major), the vector still in shared memory.  The launcher
// picks the packed form whenever it fits.
//
// K5 keeps its panel in the output buffer L (a (b, w) panel of b = 1024
// rows does not fit in shared memory in f64) and stages the GEMM's operands
// through 64 x 32 and 32 x 32 shared tiles.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int NT = 1024;     // threads per block: 32 warps
constexpr int WARPS = NT / 32;
constexpr int TM = 64;       // K5 GEMM: rows of an output tile
constexpr int TN = 32;       // K5 GEMM: columns of an output tile
constexpr int KC = 32;       // K5 GEMM: depth of a staged chunk
constexpr int RB = 128;      // K3 register kernel: the square it holds
constexpr int RT = 4;        // K3 register kernel: a thread's tile is RT x RT
constexpr int LDT = RB + RT; // row stride of its column store: 16-byte rows

__device__ __forceinline__ float sqrt_t(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_t(double v) { return sqrt(v); }
__device__ __forceinline__ float fma_t(float x, float y, float z) {
  return __fmaf_rn(x, y, z);
}
__device__ __forceinline__ double fma_t(double x, double y, double z) {
  return __fma_rn(x, y, z);
}

// offset of entry (i, k), k <= i, of a b x b lower triangle: packed in
// shared memory, where every offset is below 2^16 (int), or row-major in
// device memory (int64)
template <bool PACKED>
using Off = typename std::conditional<PACKED, int, int64_t>::type;

template <bool PACKED>
__device__ __forceinline__ Off<PACKED> at(Off<PACKED> i, Off<PACKED> k,
                                          Off<PACKED> b) {
  return PACKED ? i * (i + 1) / 2 + k : i * b + k;
}

// One barrier per step: step j reads column j of A and row j of T as they
// stand and scales them on the fly (l_k = A[k, j] / sqrt(d)), writing only
// the trailing triangle and the rows of T below j, which nobody reads in
// that step.  Column j of A and row j of T are final from step j on, so
// they stay unscaled and the scale 1 / sqrt(d_j) is kept in dinv[j]; the
// store writes L[i, k] = A[i, k] dinv[k] (L[j, j] = d dinv[j], gp_tpu's
// d * rsqrt(d)) and T[i, k] = T[i, k] dinv[i].  The products are gp_tpu's:
// (A[i, j] dinv[j]) (A[k, j] dinv[j]) and (A[i, j] dinv[j]) (T[j, k]
// dinv[j]).  On an H100 at b = 128 (f32, chip_smoke.py `chol_kernels`):
// 0.16 ms, against 0.27 ms for the same loop with a second barrier per
// step and the column and row staged through shared vectors.
template <typename T, bool PACKED, bool INV>
__global__ void __launch_bounds__(NT)
chol_rank1(const T* __restrict__ kin, int64_t ldk, T* lout, T* tout,
           int64_t b64) {
  using I = Off<PACKED>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const I b = static_cast<I>(b64);
  T* dinv = reinterpret_cast<T*>(smem_raw);
  T* a = PACKED ? dinv + b : lout;          // working lower triangle
  T* t = PACKED ? a + b * (b + 1) / 2 : tout;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // A = lower triangle of K; T = I.  Device-memory form: zero the upper
  // triangles of the outputs, which the loop never touches.
  for (int64_t e = tid; e < b64 * b64; e += NT) {
    const I i = static_cast<I>(e / b64);
    const I k = static_cast<I>(e % b64);
    if (k <= i) {
      a[at<PACKED>(i, k, b)] = kin[static_cast<int64_t>(i) * ldk + k];
      if (INV) t[at<PACKED>(i, k, b)] = i == k ? T(1) : T(0);
    } else if (!PACKED) {
      lout[e] = T(0);
      if (INV) tout[e] = T(0);
    }
  }
  __syncthreads();

  for (I j = 0; j < b; ++j) {
    const T d = a[at<PACKED>(j, j, b)];
    const T inv = T(1) / sqrt_t(d);
    if (tid == 0) dinv[j] = inv;
    const I tj = at<PACKED>(j, I(0), b);
    // rows below the pivot, one warp a row: columns <= j of T, columns
    // j+1..i of A (the trailing lower triangle)
    for (I i = j + 1 + warp; i < b; i += WARPS) {
      const I ri = at<PACKED>(i, I(0), b);
      const T li = a[ri + j] * inv;
      if (INV)
        for (I k = lane; k <= j; k += 32)
          t[ri + k] = fma_t(-li, t[tj + k] * inv, t[ri + k]);
      for (I k = j + 1 + lane; k <= i; k += 32)
        a[ri + k] = fma_t(-li, a[at<PACKED>(k, j, b)] * inv, a[ri + k]);
    }
    __syncthreads();
  }

  // scale the columns of L and the rows of T; the device-memory form
  // scales in place (each entry read and written by one thread)
  for (int64_t e = tid; e < b64 * b64; e += NT) {
    const I i = static_cast<I>(e / b64);
    const I k = static_cast<I>(e % b64);
    if (k <= i) {
      lout[e] = a[at<PACKED>(i, k, b)] * dinv[k];
      if (INV) tout[e] = t[at<PACKED>(i, k, b)] * dinv[i];
    } else if (PACKED) {
      lout[e] = T(0);
      if (INV) tout[e] = T(0);
    }
  }
}

// K3 at b <= 128, in registers.  The block's 1024 threads hold the b x b
// working square padded to 128 x 128 with the identity, one 4 x 4 tile
// each: warp w holds rows 4w..4w+3, lane l columns 4l..4l+3, so a warp is
// a band of consecutive rows.  Padded rows and columns have l = 0 and take
// no part.
//
// One square W serves A and T.  At step j the entries right of the pivot
// column are A's (the trailing matrix and the rows above it, which are
// never read), and those at or left of it are T's: column j of A is final
// at step j, so its holders save it, unscaled, to row j of `lt` in shared
// memory (for the store) and set their registers to column j of the
// identity, where T starts.  One FMA per entry and step then updates
// either:
//   W[i, k] -= l_i y_k,  i > j,   y_k = A[k, j] / sqrt(d)   (k > j)
//                                 y_k = T[j, k] / sqrt(d)   (k <= j),
// with l_i = A[i, j] / sqrt(d) -- the products and the order of
// chol_rank1, so the rounding is the same.  That halves the registers of
// two squares: 16 data registers a thread in f32, 32 in f64.
//
// One barrier per step, through one shared vector v of 128 entries:
// v[x] = A[x, j] below the pivot (x > j) and T[j, x] at or left of it,
// so l_i = v[i] / sqrt(d) and y_k = v[k] / sqrt(d).  Before the barrier
// the holders of column j write its part below the pivot, warp j / 4
// (which holds row j) the row's part, and the holder of the pivot
// dinv[j] = 1 / sqrt(d).  Two copies of v alternate by the parity of j,
// so a step's write cannot reach a copy that a slower warp still reads
// from the step before.  After it, every warp with a row below j reads
// y (one 16-byte load a lane: consecutive words, no conflicts) and, row
// by row, l_i (one broadcast word), and updates its rows below j; a warp
// whose rows are all <= j skips the step whole, so the live work shrinks
// with j and no warp diverges on it.  Steps run in fours, so the column
// and row a step selects are compile-time register indices.  In f64 the
// 32 data registers, y and l_i fit the 64 registers a thread of 1024 may
// have: ptxas reports no spills (chip_smoke.py `build` checks that).
//
// The store scales as chol_rank1 does: L[i, k] = lt[k][i] dinv[k], L[j, j]
// = d dinv[j], T[i, k] = W[i, k] dinv[i]; zeros above the diagonal.
__device__ __forceinline__ void ld4(const float* p, float& a, float& b,
                                    float& c, float& d) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a = v.x; b = v.y; c = v.z; d = v.w;
}
__device__ __forceinline__ void ld4(const double* p, double& a, double& b,
                                    double& c, double& d) {
  const double2 u = reinterpret_cast<const double2*>(p)[0];
  const double2 v = reinterpret_cast<const double2*>(p)[1];
  a = u.x; b = u.y; c = v.x; d = v.y;
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(double* p, double a, double b, double c,
                                    double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
chol_inv_reg(const T* __restrict__ kin, int64_t ldk, T* __restrict__ lout,
             T* __restrict__ tout, int b) {
  static_assert(WARPS * RT == RB && 32 * RT == RB, "one tile a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* lt = reinterpret_cast<T*>(smem_raw);   // (RB, LDT): lt[j] = A[:, j]
  T* vs = lt + RB * LDT;                    // (2, RB): v by parity of j
  T* dinv = vs + 2 * RB;                    // (RB,)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = RT * warp;                 // the tile's first row
  const int k0 = RT * lane;                 // and first column
  const bool rows_in = i0 < b;              // the warp holds a row of K

  // W = lower triangle of K, identity outside the b x b corner
  T w[RT][RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int i = i0 + r;
#pragma unroll
    for (int c = 0; c < RT; ++c) {
      const int k = k0 + c;
      w[r][c] = (i < b && k < b)
                    ? (k <= i ? kin[static_cast<int64_t>(i) * ldk + k]
                              : T(0))
                    : (i == k ? T(1) : T(0));
    }
  }

  // b rounded up to 4 steps; a padded pivot is 1 and changes nothing
  for (int j0 = 0; j0 < b; j0 += RT) {
    const int jt = j0 / RT;      // the lane with column j, the warp with row j
#pragma unroll
    for (int jj = 0; jj < RT; ++jj) {
      const int j = j0 + jj;
      T* v = vs + (jj & 1) * RB;
      // column j: saved for the store from the pivot down, v below the
      // pivot; then the identity's column j
      if (lane == jt && warp >= jt) {
        st4(lt + j * LDT + i0, w[0][jj], w[1][jj], w[2][jj], w[3][jj]);
        if (warp > jt) {
          st4(v + i0, w[0][jj], w[1][jj], w[2][jj], w[3][jj]);
        } else {
          dinv[j] = T(1) / sqrt_t(w[jj][jj]);
#pragma unroll
          for (int r = jj + 1; r < RT; ++r) v[i0 + r] = w[r][jj];
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) w[r][jj] = i0 + r == j ? T(1) : T(0);
      }
      // row j of T, at and left of the pivot
      if (warp == jt && lane <= jt) {
        if (lane < jt) {
          st4(v + k0, w[jj][0], w[jj][1], w[jj][2], w[jj][3]);
        } else {
#pragma unroll
          for (int c = 0; c <= jj; ++c) v[k0 + c] = w[jj][c];
        }
      }
      __syncthreads();
      if (rows_in && i0 + RT - 1 > j) {
        const T inv = dinv[j];
        T y[RT];
        ld4(v + k0, y[0], y[1], y[2], y[3]);
#pragma unroll
        for (int c = 0; c < RT; ++c) y[c] *= inv;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (i0 + r > j) {
            const T li = v[i0 + r] * inv;
#pragma unroll
            for (int c = 0; c < RT; ++c) w[r][c] = fma_t(-li, y[c], w[r][c]);
          }
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int i = i0 + r;
    if (i < b) {
      const T s = dinv[i];
#pragma unroll
      for (int c = 0; c < RT; ++c) {
        const int k = k0 + c;
        if (k < b)
          tout[static_cast<int64_t>(i) * b + k] = k <= i ? w[r][c] * s : T(0);
      }
    }
  }
  for (int e = threadIdx.x; e < b * b; e += NT) {
    const int i = e / b;
    const int k = e % b;
    lout[e] = k <= i ? lt[k * LDT + i] * dinv[k] : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
chol_panel(const T* __restrict__ kin, int64_t ldk, T* __restrict__ l,
           int64_t b, int64_t w) {
  __shared__ T as[TM][KC + 1];
  __shared__ T bs[TN][KC + 1];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* lv = reinterpret_cast<T*>(smem_raw);   // (b,) column c of the panel
  T* uv = lv + b;                           // (w,) pivot row of the panel
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int64_t p0 = 0; p0 < b; p0 += w) {
    // 1. C = K[p0:, p0:p0+w] - L[p0:, :p0] L[p0:p0+w, :p0]^T into the
    //    panel's columns of l; L's columns >= p0 are not factored yet and
    //    take no part.  Rows < p0 of the panel are zero (upper triangle).
    for (int64_t e = tid; e < p0 * w; e += NT)
      l[(e / w) * b + p0 + e % w] = T(0);
    for (int64_t r0 = p0; r0 < b; r0 += TM) {
      for (int64_t c0 = 0; c0 < w; c0 += TN) {
        T acc0 = T(0);
        T acc1 = T(0);
        for (int64_t k0 = 0; k0 < p0; k0 += KC) {
          for (int e = tid; e < TM * KC; e += NT) {
            const int r = e / KC;
            const int k = e % KC;
            const int64_t gr = r0 + r;
            const int64_t gk = k0 + k;
            as[r][k] = (gr < b && gk < p0) ? l[gr * b + gk] : T(0);
          }
          {
            const int c = tid / KC;
            const int k = tid % KC;
            const int64_t gc = c0 + c;
            const int64_t gk = k0 + k;
            bs[c][k] = (gc < w && gk < p0) ? l[(p0 + gc) * b + gk] : T(0);
          }
          __syncthreads();
#pragma unroll 8
          for (int k = 0; k < KC; ++k) {
            const T bv = bs[lane][k];
            acc0 = fma_t(as[warp][k], bv, acc0);
            acc1 = fma_t(as[warp + WARPS][k], bv, acc1);
          }
          __syncthreads();
        }
        const int64_t col = c0 + lane;
        if (col < w) {
          const int64_t ra = r0 + warp;
          const int64_t rb = r0 + warp + WARPS;
          if (ra < b)
            l[ra * b + p0 + col] = kin[ra * ldk + p0 + col] - acc0;
          if (rb < b)
            l[rb * b + p0 + col] = kin[rb * ldk + p0 + col] - acc1;
        }
      }
    }
    __syncthreads();

    // 2. the w-step rank-1 loop on the panel (pallas_chol.py:127-139)
    for (int64_t c = 0; c < w; ++c) {
      const int64_t pc = p0 + c;
      const T d = l[pc * b + pc];
      const T s = sqrt_t(d);
      const T inv = T(1) / s;
      for (int64_t i = p0 + tid; i < b; i += NT)
        lv[i] = i > pc ? l[i * b + pc] * inv : (i == pc ? d / s : T(0));
      for (int64_t cc = c + 1 + tid; cc < w; cc += NT)
        uv[cc] = l[pc * b + p0 + cc];
      __syncthreads();
      for (int64_t i = p0 + tid; i < b; i += NT) l[i * b + pc] = lv[i];
      for (int64_t i = pc + 1 + warp; i < b; i += WARPS) {
        const T li = lv[i] * inv;
        for (int64_t cc = c + 1 + lane; cc < w; cc += 32) {
          const int64_t o = i * b + p0 + cc;
          l[o] = fma_t(-li, uv[cc], l[o]);
        }
      }
      __syncthreads();
    }
  }
  // columns of the last panel above it were zeroed with it; nothing else
  // of the upper triangle is left: every column block was zeroed above
  // its panel's first row
}

// the shared memory a block may opt in to, read once (every card of a
// process is taken to be the same model)
int max_smem() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return bytes;
}

// raise a kernel's dynamic shared-memory limit once, to what it asks for;
// `total` adds the kernel's static shared memory
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes, size_t total,
                       size_t* allowed) {
  if (total <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <typename T, bool INV>
int launch_rank1(const void* k, int64_t ldk, void* l, void* t, int64_t b,
                 void* stream) {
  if (b <= 0) return 0;
  if (ldk < b) return static_cast<int>(cudaErrorInvalidValue);
  static size_t allowed_packed = 0;
  static size_t allowed_global = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t vec = static_cast<size_t>(b) * sizeof(T);   // dinv
  const size_t tri = static_cast<size_t>(b) * (b + 1) / 2 * sizeof(T);
  const size_t packed = vec + (INV ? 2 : 1) * tri;
  const size_t limit = static_cast<size_t>(max_smem());
  const T* pk = static_cast<const T*>(k);
  T* pl = static_cast<T*>(l);
  T* pt = static_cast<T*>(t);
  if (packed <= limit) {
    cudaError_t err =
        allow_smem(chol_rank1<T, true, INV>, packed, packed,
                   &allowed_packed);
    if (err != cudaSuccess) return static_cast<int>(err);
    chol_rank1<T, true, INV><<<1, NT, packed, s>>>(pk, ldk, pl, pt, b);
  } else {
    if (vec > limit) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err =
        allow_smem(chol_rank1<T, false, INV>, vec, vec, &allowed_global);
    if (err != cudaSuccess) return static_cast<int>(err);
    chol_rank1<T, false, INV><<<1, NT, vec, s>>>(pk, ldk, pl, pt, b);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_inv_reg(const void* k, int64_t ldk, void* l, void* t, int64_t b,
                   void* stream) {
  if (b <= 0) return 0;
  if (b > RB || ldk < b) return static_cast<int>(cudaErrorInvalidValue);
  static size_t allowed = 0;
  const size_t bytes = static_cast<size_t>(RB * LDT + 3 * RB) * sizeof(T);
  cudaError_t err = allow_smem(chol_inv_reg<T>, bytes, bytes, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_inv_reg<T><<<1, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(k), ldk, static_cast<T*>(l), static_cast<T*>(t),
      static_cast<int>(b));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_panel(const void* k, int64_t ldk, void* l, int64_t b, int64_t w,
                 void* stream) {
  if (b <= 0) return 0;
  if (w <= 0 || b % w || ldk < b)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t allowed = 0;
  const size_t bytes = static_cast<size_t>(b + w) * sizeof(T);
  const size_t total = bytes + (TM + TN) * (KC + 1) * sizeof(T);
  if (total > static_cast<size_t>(max_smem()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(chol_panel<T>, bytes, total, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_panel<T><<<1, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(k), ldk, static_cast<T*>(l), b, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k (b, b), row i at k + i * ldk (ldk >= b: a block of a larger row-major
// matrix is read in place), symmetric (K3/K4 read its lower triangle; K5
// also the upper entries inside each w x w diagonal square, as gp_tpu's
// panel GEMM does).  l, t (b, b) row-major outputs, lower triangular,
// zeros above.  w: K5's panel width, b % w == 0.  chol_inv_reg_* is K3
// for b <= 128 (chol_inv_reg), chol_inv_* K3 for any b (chol_rank1); the
// wrapper (ops/chol_block.py) picks by b.  Each returns the cudaError_t of
// the launch.
extern "C" int chol_inv_f32(const void* k, int64_t ldk, void* l, void* t,
                            int64_t b, void* stream) {
  return launch_rank1<float, true>(k, ldk, l, t, b, stream);
}

extern "C" int chol_inv_f64(const void* k, int64_t ldk, void* l, void* t,
                            int64_t b, void* stream) {
  return launch_rank1<double, true>(k, ldk, l, t, b, stream);
}

extern "C" int chol_inv_reg_f32(const void* k, int64_t ldk, void* l,
                                void* t, int64_t b, void* stream) {
  return launch_inv_reg<float>(k, ldk, l, t, b, stream);
}

extern "C" int chol_inv_reg_f64(const void* k, int64_t ldk, void* l,
                                void* t, int64_t b, void* stream) {
  return launch_inv_reg<double>(k, ldk, l, t, b, stream);
}

extern "C" int chol_f32(const void* k, int64_t ldk, void* l, int64_t b,
                        void* stream) {
  return launch_rank1<float, false>(k, ldk, l, nullptr, b, stream);
}

extern "C" int chol_f64(const void* k, int64_t ldk, void* l, int64_t b,
                        void* stream) {
  return launch_rank1<double, false>(k, ldk, l, nullptr, b, stream);
}

extern "C" int chol_panel_f32(const void* k, int64_t ldk, void* l, int64_t b,
                              int64_t w, void* stream) {
  return launch_panel<float>(k, ldk, l, b, w, stream);
}

extern "C" int chol_panel_f64(const void* k, int64_t ldk, void* l, int64_t b,
                              int64_t w, void* stream) {
  return launch_panel<double>(k, ldk, l, b, w, stream);
}
