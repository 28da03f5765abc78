// Block Cholesky kernels for Hopper (sm_90a): the base cases of the blocked
// factorization (ops/blocked.py).
//
// Replaces the three Pallas TPU kernels of gp_tpu/ops/pallas_chol.py:
//   K3  _chol_inv_kernel   (:180)  (L, T = L^-1) of one b x b block in one
//       launch: the right-looking rank-1 loop with the forward substitution
//       on the identity interleaved -- chol_inv_reg<T> for b <= 128 (the
//       blocked factorization's leaf), chol_rank1<T, PACKED> above;
//   K4  _chol_kernel       (:41)   L alone: for b <= 128 the register
//       kernel without T's store (chol_inv_reg_alias<T, false>); above it
//       a blocked right-looking factorization across the card's SMs
//       (chol_blocked<T>, below);
//   K5  _chol_panel_kernel (:87)   L by left-looking rank-w micro-panels:
//       per panel of w columns at p the update C = K[p:, p:p+w] - L[p:, :p]
//       L[p:p+w, :p]^T, then the panel's factorization -- a host loop of
//       launches across the card's SMs (chol_left<T>, below).
//
// Step j of the rank-1 loop, as gp_tpu writes it (pallas_chol.py:199-221):
// d = A[j, j]; L[:, j] = A[:, j] / sqrt(d) below the pivot; A -= L[:, j]
// L[:, j]^T on the trailing part; row j of T is scaled by 1 / sqrt(d) and
// T[i, :] -= L[i, j] T[j, :] is pushed into the rows below.  The pivot is
// d (1 / sqrt(d)) here (gp_tpu's d * rsqrt(d)); gp_tpu's K5 writes d /
// sqrt(d), one rounding away on the diagonal, well inside the tests'
// tolerance.  A zero pivot gives NaN (0 inf), a negative one too
// (sqrt(< 0)), and the NaN reaches every later column through the
// trailing update -- gp_tpu's failure contract (chol_ok reads a NaN
// diagonal).  Full-precision FMAs only: no tensor cores, so no TF32.
// Offsets into device memory are int64.
//
// What bounds them: neither bytes nor operations.  Each rank-1 kernel is
// ONE block (one SM of 132) walking b serial steps, one barrier each; at
// the path's b = 128 a launch does b^3/3 (K4) or 2 b^3/3 (K3) flops,
// microseconds of work at the card's rate.  What sets the time is the
// b serial steps and what each step costs on the one SM: for chol_rank1
// its shared-memory traffic (three accesses per update); for
// chol_inv_reg, whose update is ~35 instructions a warp, the chain from
// one barrier to the next -- the shared loads, the live warps' FMAs
// sharing the SM's four schedulers, the pivot's 1 / sqrt(d) and the
// barrier itself.  The blocked factorization runs 64 K3 leaves one after
// another at N = 8192.  K4 above 128 and K5 run their leaves in sequence
// too; their GEMMs spread over the SMs and take a smaller share of the
// time.  Measured times: PERF.md, section 6.
//
// Shared memory (chol_rank1, K3 above 128).  The working matrix A and the
// inverse T are triangular, so each is held as its packed lower triangle,
// b(b+1)/2 entries, beside one b-vector (the pivots' 1 / sqrt(d)).  Where
// the packed triangles do not fit in the 227 KB a block may take (b = 200
// in f64), the same loop runs on the output buffers in device memory
// (PACKED = false: A in L, T in T, full row-major), the vector still in
// shared memory.  The launcher picks the packed form whenever it fits.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int NT = 1024;     // threads per block: 32 warps
constexpr int WARPS = NT / 32;
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

// K3 above 128.  One barrier per step: step j reads column j of A and
// row j of T as they stand and scales them on the fly (l_k = A[k, j] /
// sqrt(d)), writing only the trailing triangle and the rows of T below j,
// which nobody reads in that step.  Column j of A and row j of T are final
// from step j on, so they stay unscaled and the scale 1 / sqrt(d_j) is kept
// in dinv[j]; the store writes L[i, k] = A[i, k] dinv[k] (L[j, j] = d
// dinv[j], gp_tpu's d * rsqrt(d)) and T[i, k] = T[i, k] dinv[i].  The
// products are gp_tpu's: (A[i, j] dinv[j]) (A[k, j] dinv[j]) and (A[i, j]
// dinv[j]) (T[j, k] dinv[j]).  What sets its time is the b serial steps on
// one SM, each a barrier and three shared-memory (or, unpacked, device-
// memory) accesses per update; times in PERF.md, section 6.
template <typename T, bool PACKED>
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
      t[at<PACKED>(i, k, b)] = i == k ? T(1) : T(0);
    } else if (!PACKED) {
      lout[e] = T(0);
      tout[e] = T(0);
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
      tout[e] = t[at<PACKED>(i, k, b)] * dinv[i];
    } else if (PACKED) {
      lout[e] = T(0);
      tout[e] = T(0);
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
//
// K4's leaf is the same kernel (chol_inv_reg_alias): L goes out with a row
// stride ldo, so the blocked form factors a diagonal block of its output
// in place, and T's store is left out where nobody reads T (STORE_T =
// false); T's column work stays, so the arithmetic is K3's.
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

template <typename T, bool STORE_T>
__device__ __forceinline__ void
inv_reg_body(const T* kin, int64_t ldk, T* lout, int64_t ldo, T* tout,
             int b) {
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

  if (STORE_T) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int i = i0 + r;
      if (i < b) {
        const T s = dinv[i];
#pragma unroll
        for (int c = 0; c < RT; ++c) {
          const int k = k0 + c;
          if (k < b)
            tout[static_cast<int64_t>(i) * b + k] =
                k <= i ? w[r][c] * s : T(0);
        }
      }
    }
  }
  for (int e = threadIdx.x; e < b * b; e += NT) {
    const int i = e / b;
    const int k = e % b;
    lout[static_cast<int64_t>(i) * ldo + k] =
        k <= i ? lt[k * LDT + i] * dinv[k] : T(0);
  }
}

// K3: the outputs are dense b x b buffers of their own.  Its pointers are
// __restrict__, which K4's in-place leaf cannot have: launching K3 through
// chol_inv_reg_alias<T, true> instead cost 0.6 us (f32) and 1.1 us (f64) a
// launch at b = 128, 1.2-1.3 % (PERF.md section 6), and K3 is launched 64
// times a factorization.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
chol_inv_reg(const T* __restrict__ kin, int64_t ldk, T* __restrict__ lout,
             T* __restrict__ tout, int b) {
  inv_reg_body<T, true>(kin, ldk, lout, b, tout, b);
}

// K4's leaf: kin and lout may be one block (in place), so neither is
// __restrict__.  Every read of kin precedes the step loop's first barrier
// and every write of lout follows its last, so the block reads K whole
// before it writes L.
template <typename T, bool STORE_T>
__global__ void __launch_bounds__(NT, 1)
chol_inv_reg_alias(const T* kin, int64_t ldk, T* lout, int64_t ldo,
                   T* __restrict__ tout, int b) {
  inv_reg_body<T, STORE_T>(kin, ldk, lout, ldo, tout, b);
}

// K4 above 128: a blocked right-looking factorization in L, the output,
// by a host loop of launches (chol_blocked below).  L starts as the lower
// triangle of K; then for each panel of NB columns at p, while rows are
// left below it:
//   (a) the leaf on the diagonal block, in place: L_pp and T_pp = L_pp^-1
//       (to a workspace), chol_inv_reg_alias<T, true>;
//   (b) the panel solve L[p+NB:, p:p+NB] = A[p+NB:, p:p+NB] T_pp^T, in
//       place, chol_panel_solve: one CTA a band of PB rows;
//   (c) the trailing update A_IJ -= L_Ip L_Jp^T on the 64 x 64 tiles with
//       I >= J, one CTA a tile, chol_trailing; on a diagonal tile only
//       entries on and below the diagonal are written, so nothing, NaN
//       included, lands above it.
// The last panel (NB rows or fewer) is the leaf alone.  A failing pivot
// makes its leaf's column and T's rows from it NaN; the panel solve and
// the trailing update carry the NaN to every later column, and the
// columns before it stay finite: the plain loop's mask.
//
// (b) and (c) are one product, C = A B^T over the panel's NB columns:
// gemm_abt stages 16-deep chunks of A and B through shared memory, k-major,
// and each of 16 x 16 threads keeps a (BM / 16) x (BN / 16) register tile
// of full-precision FMAs (no tensor cores).  Their flops are spread over
// the SMs; the b / NB leaves, one SM each and one after another, take
// most of the time.
// NB = 64 against 128, measured once on the H100 at b = 1024 (PERF.md
// section 6): a tie in float32, 64 some 11 % faster in float64; its 16
// leaves of 64 take less time than 8 of 128, and the serial leaves set
// K4's time.  ops/chol_block.K4_PANEL is its copy (the workspace's side).
constexpr int NB = 64;     // K4 above RB: the panel width
constexpr int UT = 64;     // K4 trailing update: a CTA's tile is UT x UT
constexpr int PB = 32;     // K4/K5 panel solve: rows of a CTA's band
constexpr int UKC = 16;    // gemm_abt: depth of a staged chunk
constexpr int UNT = 256;   // gemm_abt's kernels: threads per CTA, 16 x 16

// column of a BN-wide tile that entry j of thread tx's register tile
// holds: groups of 4 consecutive columns, 64 apart, so that 16 lanes read
// a group's 64 columns as one conflict-free run of 16-byte words
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j / 4) * 64 + 4 * tx + j % 4;
}

// a thread's share of one chunk of X (rows, depth) at x, row stride ld:
// columns k0..k0+UKC of its rows; rows from valid on, and columns from
// depth on, read as zero
template <typename T, int L>
__device__ __forceinline__ void fetch(const T* x, int64_t ld, int valid,
                                      int k0, int depth, T (&reg)[L]) {
#pragma unroll
  for (int q = 0; q < L; ++q) {
    const int e = threadIdx.x + q * UNT;
    const int r = e / UKC;
    const int k = k0 + e % UKC;
    reg[q] = (r < valid && k < depth) ? x[r * ld + k] : T(0);
  }
}

// acc += A B^T for a BM x BN tile: A (BM, depth) at a, row stride lda, B
// (BN, depth) at bm, row stride ldb; rows of A from ma on and of B from nb
// on read as zero.  Thread (ty, tx) owns rows RM ty.. and the columns
// tile_col(tx, 0..RN-1).  The next chunk's loads from device memory are in
// flight while the current one is multiplied.  It ends on a barrier, so
// every read the CTA makes of A and B precedes the return.
template <typename T, int BM, int BN>
__device__ __forceinline__ void gemm_abt(const T* a, int64_t lda, int ma,
                                         const T* bm, int64_t ldb, int nb,
                                         int depth,
                                         T (&acc)[BM / 16][BN / 16]) {
  constexpr int RM = BM / 16;
  constexpr int RN = BN / 16;
  constexpr int LA = BM * UKC / UNT;   // entries a thread stages per chunk
  constexpr int LB = BN * UKC / UNT;
  static_assert(RN % 4 == 0 && LA * UNT == BM * UKC && LB * UNT == BN * UKC,
                "tile shape");
  __shared__ __align__(16) T as[UKC][BM + 4];
  __shared__ __align__(16) T bs[UKC][BN + 4];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  T ra[LA];
  T rb[LB];
  fetch(a, lda, ma, 0, depth, ra);
  fetch(bm, ldb, nb, 0, depth, rb);
  for (int k0 = 0; k0 < depth; k0 += UKC) {
#pragma unroll
    for (int q = 0; q < LA; ++q) {
      const int e = threadIdx.x + q * UNT;
      as[e % UKC][e / UKC] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < LB; ++q) {
      const int e = threadIdx.x + q * UNT;
      bs[e % UKC][e / UKC] = rb[q];
    }
    __syncthreads();
    if (k0 + UKC < depth) {
      fetch(a, lda, ma, k0 + UKC, depth, ra);
      fetch(bm, ldb, nb, k0 + UKC, depth, rb);
    }
#pragma unroll
    for (int k = 0; k < UKC; ++k) {
      T x[RM];
      T y[RN];
      if constexpr (RM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < RM; i += 4)
          ld4(&as[k][RM * ty + i], x[i], x[i + 1], x[i + 2], x[i + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i) x[i] = as[k][RM * ty + i];
      }
#pragma unroll
      for (int j = 0; j < RN; j += 4)
        ld4(&bs[k][tile_col(tx, j)], y[j], y[j + 1], y[j + 2], y[j + 3]);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fma_t(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// L = lower triangle of K, zeros above; scalar loads, as K may be a
// misaligned block of a larger matrix
template <typename T>
__global__ void __launch_bounds__(UNT)
chol_copy_lower(const T* __restrict__ kin, int64_t ldk, T* __restrict__ l,
                int64_t b) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * UNT;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * UNT + threadIdx.x;
       e < b * b; e += step) {
    const int64_t i = e / b;
    const int64_t k = e % b;
    l[e] = k <= i ? kin[i * ldk + k] : T(0);
  }
}

// (b): rows r0.. of the band, the pw columns of panel p (pw <= WN, the
// compiled width; K4 runs it at NB, K5 at its panel width: the columns
// from pw on are neither read nor written).  The CTA reads only its own
// band (and T_pp, row stride pw), and all of it before it writes.
template <typename T, int WN>
__global__ void __launch_bounds__(UNT)
chol_panel_solve(T* l, int64_t b, int64_t p, int pw,
                 const T* __restrict__ tpp) {
  const int64_t r0 = p + pw + static_cast<int64_t>(PB) * blockIdx.x;
  const int rows = static_cast<int>(b - r0 < PB ? b - r0 : PB);
  T* band = l + r0 * b + p;
  T acc[PB / 16][WN / 16] = {};
  gemm_abt<T, PB, WN>(band, b, rows, tpp, pw, pw, pw, acc);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < PB / 16; ++i) {
    const int r = PB / 16 * ty + i;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {
        const int c = tile_col(tx, j);
        if (c < pw) band[r * b + c] = acc[i][j];
      }
    }
  }
}

// (c): tile (I, J) = (blockIdx.y, blockIdx.x) of the trailing matrix from
// row and column p + NB; the tiles above the diagonal return at once.  It
// reads the panel's columns, which no CTA of this launch writes.
template <typename T>
__global__ void __launch_bounds__(UNT)
chol_trailing(T* l, int64_t b, int64_t p) {
  const int ti = blockIdx.y;
  const int tj = blockIdx.x;
  if (tj > ti) return;
  const int64_t q = p + NB;
  const int64_t r0 = q + static_cast<int64_t>(UT) * ti;
  const int64_t c0 = q + static_cast<int64_t>(UT) * tj;
  const int rows = static_cast<int>(b - r0 < UT ? b - r0 : UT);
  const int cols = static_cast<int>(b - c0 < UT ? b - c0 : UT);
  T acc[UT / 16][UT / 16] = {};
  gemm_abt<T, UT, UT>(l + r0 * b + p, b, rows, l + c0 * b + p, b, cols, NB,
                      acc);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < UT / 16; ++i) {
    const int r = UT / 16 * ty + i;
#pragma unroll
    for (int j = 0; j < UT / 16; ++j) {
      const int c = tile_col(tx, j);
      if (r < rows && c < cols && (ti != tj || c <= r)) {
        T* o = l + (r0 + r) * b + c0 + c;
        *o -= acc[i][j];
      }
    }
  }
}

// K5: gp_tpu's left-looking factorization by panels of pw columns
// (pallas_chol.py:112-143), in L, the output, by a host loop of launches
// (chol_left below).  L starts as the lower triangle of K (chol_copy_lower,
// as in K4); then for each panel at p:
//   (1) the update L[r, p:p+pw] = K[r, p:p+pw] - L[r, :p] L[p:p+pw, :p]^T
//       for the rows r >= p, on and below the diagonal (the leaf reads no
//       more), in place, chol_panel_update: one CTA a band of UB rows and
//       PU of the panel's columns, depth p; nothing at p = 0;
//   (2) the leaf on the diagonal block, in place: L_pp and T_pp = L_pp^-1
//       to the workspace, chol_inv_reg_alias<T, true>;
//   (3) the panel solve L[p+pw:, p:p+pw] = C T_pp^T, in place,
//       chol_panel_solve at the panel's width.
// The last panel is (1) and the leaf without T's store; a block of one
// panel is the leaf alone, on K.  The update reads only L's columns left
// of the panel and writes only the panel's, so no CTA overwrites what
// another reads.  It is gp_tpu's GEMM transposed, acc = L[p:p+pw, :p]
// L[band, :p]^T: the panel's columns are gemm_abt's PU-row side, so a
// panel of 32 columns wastes none of the tile (the other side is 64
// wide), and a panel of 128 runs on four CTAs a band.
//
// Widths above RB: the leaf takes at most RB columns, so a panel width w
// above it runs as panels of pw, the largest divisor of w up to RB.  Every
// panel boundary of w is one of pw, so this is gp_tpu's left-looking
// factorization with the same L in exact arithmetic; only the rounding
// order inside a w-panel changes.
//
// A failing pivot makes its leaf's column and T_pp's rows from it NaN
// (T_pp's upper triangle is stored as zeros); the panel solve keeps the
// columns before it finite and the next panel's update carries the NaN to
// every later column: the plain loop's mask.
//
// The leaves, one SM each and one after another, set the time (b / pw of
// them); the updates' depth grows with p while their bands shrink, so the
// late panels' updates run on few SMs.
constexpr int UB = 64;     // K5 panel update: band rows a CTA (gemm_abt's BN)
constexpr int PU = 32;     // K5 panel update: panel columns a CTA (its BM)

// (1): band rows r0.. (blockIdx.x) and panel columns c0.. (blockIdx.y)
template <typename T>
__global__ void __launch_bounds__(UNT)
chol_panel_update(T* l, int64_t b, int64_t p, int pw) {
  const int64_t r0 = p + static_cast<int64_t>(UB) * blockIdx.x;
  const int c0 = PU * blockIdx.y;
  const int rows = static_cast<int>(b - r0 < UB ? b - r0 : UB);
  const int cols = pw - c0 < PU ? pw - c0 : PU;
  T acc[PU / 16][UB / 16] = {};
  gemm_abt<T, PU, UB>(l + (p + c0) * b, b, cols, l + r0 * b, b, rows,
                      static_cast<int>(p), acc);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < PU / 16; ++i) {
    const int c = PU / 16 * ty + i;
    const int64_t col = p + c0 + c;
#pragma unroll
    for (int j = 0; j < UB / 16; ++j) {
      const int r = tile_col(tx, j);
      const int64_t row = r0 + r;
      if (c < cols && r < rows && row >= col)
        l[row * b + col] -= acc[i][j];
    }
  }
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

template <typename T>
int launch_rank1(const void* k, int64_t ldk, void* l, void* t, int64_t b,
                 void* stream) {
  if (b <= 0) return 0;
  if (ldk < b) return static_cast<int>(cudaErrorInvalidValue);
  static size_t allowed_packed = 0;
  static size_t allowed_global = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t vec = static_cast<size_t>(b) * sizeof(T);   // dinv
  const size_t tri = static_cast<size_t>(b) * (b + 1) / 2 * sizeof(T);
  const size_t packed = vec + 2 * tri;
  const size_t limit = static_cast<size_t>(max_smem());
  const T* pk = static_cast<const T*>(k);
  T* pl = static_cast<T*>(l);
  T* pt = static_cast<T*>(t);
  if (packed <= limit) {
    cudaError_t err =
        allow_smem(chol_rank1<T, true>, packed, packed, &allowed_packed);
    if (err != cudaSuccess) return static_cast<int>(err);
    chol_rank1<T, true><<<1, NT, packed, s>>>(pk, ldk, pl, pt, b);
  } else {
    if (vec > limit) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err =
        allow_smem(chol_rank1<T, false>, vec, vec, &allowed_global);
    if (err != cudaSuccess) return static_cast<int>(err);
    chol_rank1<T, false><<<1, NT, vec, s>>>(pk, ldk, pl, pt, b);
  }
  return static_cast<int>(cudaGetLastError());
}

// the register kernel's dynamic shared memory: column store, v, dinv
template <typename T>
constexpr size_t reg_smem() {
  return static_cast<size_t>(RB * LDT + 3 * RB) * sizeof(T);
}

template <typename T>
int launch_inv_reg(const void* k, int64_t ldk, void* l, void* t, int64_t b,
                   void* stream) {
  if (b <= 0) return 0;
  if (b > RB || ldk < b) return static_cast<int>(cudaErrorInvalidValue);
  static size_t allowed = 0;
  const size_t bytes = reg_smem<T>();
  cudaError_t err = allow_smem(chol_inv_reg<T>, bytes, bytes, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_inv_reg<T><<<1, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(k), ldk, static_cast<T*>(l), static_cast<T*>(t),
      static_cast<int>(b));
  return static_cast<int>(cudaGetLastError());
}

// K4's leaf on the b x b block at k (b <= RB): L to l (row stride ldo; in
// place where l == k), and T = L^-1 to t (dense b x b) if STORE_T
template <typename T, bool STORE_T>
cudaError_t leaf(const T* k, int64_t ldk, T* l, int64_t ldo, T* t, int64_t b,
                 cudaStream_t s) {
  static size_t allowed = 0;
  const size_t bytes = reg_smem<T>();
  cudaError_t err =
      allow_smem(chol_inv_reg_alias<T, STORE_T>, bytes, bytes, &allowed);
  if (err != cudaSuccess) return err;
  chol_inv_reg_alias<T, STORE_T><<<1, NT, bytes, s>>>(
      k, ldk, l, ldo, t, static_cast<int>(b));
  return cudaGetLastError();
}

// L = lower triangle of K, zeros above: K4's and K5's first launch
template <typename T>
cudaError_t copy_lower(const T* k, int64_t ldk, T* l, int64_t b,
                       cudaStream_t s) {
  const int64_t blocks = (b * b + UNT - 1) / UNT;
  chol_copy_lower<T><<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535),
                       UNT, 0, s>>>(k, ldk, l, b);
  return cudaGetLastError();
}

// K4 above RB, panels of NB columns (see chol_panel_solve); ws holds T_pp
template <typename T>
cudaError_t chol_blocked(const T* k, int64_t ldk, T* l, T* ws, int64_t b,
                         cudaStream_t s) {
  static_assert(NB <= RB && NB % 64 == 0 && NB % UKC == 0, "panel width");
  cudaError_t err = copy_lower(k, ldk, l, b, s);
  int64_t p = 0;
  for (; err == cudaSuccess && b - p > NB; p += NB) {
    T* d = l + p * b + p;
    err = leaf<T, true>(d, b, d, b, ws, NB, s);
    if (err != cudaSuccess) break;
    const int64_t below = b - p - NB;
    const unsigned bands = static_cast<unsigned>((below + PB - 1) / PB);
    const unsigned tiles = static_cast<unsigned>((below + UT - 1) / UT);
    chol_panel_solve<T, NB><<<bands, UNT, 0, s>>>(l, b, p, NB, ws);
    chol_trailing<T><<<dim3(tiles, tiles), UNT, 0, s>>>(l, b, p);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  T* d = l + p * b + p;
  return leaf<T, false>(d, b, d, b, nullptr, b - p, s);
}

// K4: the register leaf up to RB, the blocked form above it (ws is an
// NB x NB workspace there)
template <typename T>
int launch_chol(const void* k, int64_t ldk, void* l, void* ws, int64_t b,
                void* stream) {
  if (b <= 0) return 0;
  if (ldk < b) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pk = static_cast<const T*>(k);
  T* pl = static_cast<T*>(l);
  T* pw = static_cast<T*>(ws);
  cudaError_t err = cudaErrorInvalidValue;
  if (b <= RB)
    err = leaf<T, false>(pk, ldk, pl, b, nullptr, b, s);
  else if (pw != nullptr)
    err = chol_blocked<T>(pk, ldk, pl, pw, b, s);
  return static_cast<int>(err);
}

// K5 at panel width pw <= RB, b > pw (see chol_panel_update); ws holds
// T_pp (pw x pw)
template <typename T>
cudaError_t chol_left(const T* k, int64_t ldk, T* l, T* ws, int64_t b,
                      int64_t pw, cudaStream_t s) {
  static_assert(RB == 128 && NB == 64, "the panel solve's two widths");
  cudaError_t err = copy_lower(k, ldk, l, b, s);
  const int w = static_cast<int>(pw);
  for (int64_t p = 0; err == cudaSuccess; p += pw) {
    if (p > 0) {
      const dim3 grid(static_cast<unsigned>((b - p + UB - 1) / UB),
                      static_cast<unsigned>((pw + PU - 1) / PU));
      chol_panel_update<T><<<grid, UNT, 0, s>>>(l, b, p, w);
      err = cudaGetLastError();
      if (err != cudaSuccess) break;
    }
    T* d = l + p * b + p;
    if (p + pw == b) return leaf<T, false>(d, b, d, b, nullptr, pw, s);
    err = leaf<T, true>(d, b, d, b, ws, pw, s);
    if (err != cudaSuccess) break;
    const unsigned bands = static_cast<unsigned>((b - p - pw + PB - 1) / PB);
    if (pw <= NB)
      chol_panel_solve<T, NB><<<bands, UNT, 0, s>>>(l, b, p, w, ws);
    else
      chol_panel_solve<T, RB><<<bands, UNT, 0, s>>>(l, b, p, w, ws);
    err = cudaGetLastError();
  }
  return err;
}

// K5: panels of w columns, or above RB of its largest divisor up to RB;
// ws is a workspace of at least that width squared wherever b exceeds it
template <typename T>
int launch_panel(const void* k, int64_t ldk, void* l, void* ws, int64_t b,
                 int64_t w, void* stream) {
  if (b <= 0) return 0;
  if (w <= 0 || b % w || ldk < b)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t pw = w < RB ? w : RB;
  while (w % pw) --pw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pk = static_cast<const T*>(k);
  T* pl = static_cast<T*>(l);
  T* pws = static_cast<T*>(ws);
  cudaError_t err = cudaErrorInvalidValue;
  if (pw == b)
    err = leaf<T, false>(pk, ldk, pl, b, nullptr, b, s);
  else if (pws != nullptr)
    err = chol_left<T>(pk, ldk, pl, pws, b, pw, s);
  return static_cast<int>(err);
}

}  // namespace

// k (b, b), row i at k + i * ldk (ldk >= b: a block of a larger row-major
// matrix is read in place), symmetric: each kernel reads its lower
// triangle.  l, t (b, b) row-major outputs, lower triangular, zeros above.
// chol_inv_reg_* is K3 for b <= 128 (chol_inv_reg), chol_inv_* K3 for any
// b (chol_rank1); the wrapper (ops/chol_block.py) picks by b.  chol_* is K4
// for any b: one launch up to 128, above it a loop of launches with panels
// of NB = 64 columns and ws an NB x NB workspace.  chol_panel_* is K5 at
// panel width w (b % w == 0): a loop of launches with panels of pw = w
// columns, or for w > 128 of pw, the largest divisor of w up to 128 (the
// same L in exact arithmetic), and ws a pw x pw workspace (unread where
// pw = b: one launch).  Each returns the cudaError_t of its launches (the
// first that failed).
extern "C" int chol_inv_f32(const void* k, int64_t ldk, void* l, void* t,
                            int64_t b, void* stream) {
  return launch_rank1<float>(k, ldk, l, t, b, stream);
}

extern "C" int chol_inv_f64(const void* k, int64_t ldk, void* l, void* t,
                            int64_t b, void* stream) {
  return launch_rank1<double>(k, ldk, l, t, b, stream);
}

extern "C" int chol_inv_reg_f32(const void* k, int64_t ldk, void* l,
                                void* t, int64_t b, void* stream) {
  return launch_inv_reg<float>(k, ldk, l, t, b, stream);
}

extern "C" int chol_inv_reg_f64(const void* k, int64_t ldk, void* l,
                                void* t, int64_t b, void* stream) {
  return launch_inv_reg<double>(k, ldk, l, t, b, stream);
}

extern "C" int chol_f32(const void* k, int64_t ldk, void* l, void* ws,
                        int64_t b, void* stream) {
  return launch_chol<float>(k, ldk, l, ws, b, stream);
}

extern "C" int chol_f64(const void* k, int64_t ldk, void* l, void* ws,
                        int64_t b, void* stream) {
  return launch_chol<double>(k, ldk, l, ws, b, stream);
}

extern "C" int chol_panel_f32(const void* k, int64_t ldk, void* l,
                              void* ws, int64_t b, int64_t w, void* stream) {
  return launch_panel<float>(k, ldk, l, ws, b, w, stream);
}

extern "C" int chol_panel_f64(const void* k, int64_t ldk, void* l,
                              void* ws, int64_t b, int64_t w, void* stream) {
  return launch_panel<double>(k, ldk, l, ws, b, w, stream);
}
