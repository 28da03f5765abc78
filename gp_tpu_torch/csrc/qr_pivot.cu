// Column-pivoted Householder QR for Hopper (sm_90a): gp_tpu's qr_pivot
// loop (gp_tpu/ops/qr_pivot.py:27-75), run as a host loop of launches in
// one C entry, qr_pivot_f32/f64.  gp_tpu's loop runs outside Pallas (a
// lax.fori_loop of XLA ops); this is the port's card form of it, and
// ops/qr_pivot.py's torch loop is its plain version.
//
// Step j, as gp_tpu writes it:
//   p      = the first position >= j of the largest downdated norm cn
//            (a NaN counts as the largest, as torch.argmax takes it);
//            columns j and p of R swap, and perm[j], perm[p], cn[j], cn[p]
//   v      = R[j:, j], v[0] += sign(v[0]) |v| (sign(0) = +1)
//   scale  = 2 / |v|^2, 0 for a zero column (the identity reflector)
//   R[j:, j:] -= v (scale v^T R[j:, j:])
//   Q[:, j:]  -= (scale Q[:, j:] v) v^T
//   cn[j:]     = max(cn[j:] - R[j, j:]^2, 0)
//
// Five launches a step: the pivot, swap and reflector (one block), the
// column sums v^T R in row chunks (partials, no atomics: the same sums
// every run), their total times scale with the rank-1 update of R and the
// norm downdate, the row sums Q v, and Q's rank-1 update.  R and Q are
// row-major n x n (ld n).  Full-precision FMAs, offsets int64.
//
// What bounds it: the chain of n steps.  The function's own least time
// is its 8 n^3 / 3 flops (4 n^3 / 3 for R, 4 n^3 / 3 for Q accumulated
// backward, as LAPACK's orgqr does) at the card's rate.  This loop, as
// gp_tpu's, applies each reflector to every row of Q (2 n^3 for Q,
// 10 n^3 / 3 in all), moves R's trailing block and Q's trailing columns
// three times a step (~2.5 w n^3 bytes in all, w the word size), and
// runs each of its n steps as five launches in sequence.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kPivotThreads = 1024;
constexpr int kCols = 128;          // columns of a column-sum block
constexpr int kChunk = 256;         // rows of a column-sum block
constexpr int kRowThreads = 256;    // threads of a row-sum block (8 warps)

// the argmax order: a NaN first, then the larger value, ties to the
// smaller index
template <typename T>
__device__ bool better(T a, int64_t ia, T b, int64_t ib) {
  bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

template <typename T>
__device__ T block_sum(T x, T* sh) {
  sh[threadIdx.x] = x;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  T out = sh[0];
  __syncthreads();
  return out;
}

// the pivot, the swap and the reflector of step j; v gets (n - j) values,
// sc[0] the scale
template <typename T>
__global__ void __launch_bounds__(kPivotThreads)
qrp_pivot(T* R, int64_t* perm, T* cn, T* v, T* sc, int64_t n, int64_t j) {
  __shared__ T sval[kPivotThreads];
  __shared__ int64_t sidx[kPivotThreads];
  const int t = threadIdx.x;
  T best = 0;
  int64_t bi = -1;
  for (int64_t c = j + t; c < n; c += blockDim.x) {
    T x = cn[c];
    if (bi < 0 || better(x, c, best, bi)) { best = x; bi = c; }
  }
  sval[t] = best;
  sidx[t] = bi;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s && sidx[t + s] >= 0
        && (sidx[t] < 0 || better(sval[t + s], sidx[t + s], sval[t],
                                  sidx[t]))) {
      sval[t] = sval[t + s];
      sidx[t] = sidx[t + s];
    }
    __syncthreads();
  }
  const int64_t p = sidx[0];
  __syncthreads();
  if (p != j) {
    for (int64_t i = t; i < n; i += blockDim.x) {
      T a = R[i * n + j];
      R[i * n + j] = R[i * n + p];
      R[i * n + p] = a;
    }
    if (t == 0) {
      int64_t q = perm[j]; perm[j] = perm[p]; perm[p] = q;
      T c = cn[j]; cn[j] = cn[p]; cn[p] = c;
    }
  }
  __syncthreads();
  const int64_t m = n - j;
  T s2 = 0;
  for (int64_t i = t; i < m; i += blockDim.x) {
    T x = R[(j + i) * n + j];
    v[i] = x;
    s2 += x * x;
  }
  const T normx = sqrt(block_sum(s2, sval));
  if (t == 0) {
    T x0 = v[0];
    v[0] = x0 + (x0 >= 0 ? T(1) : T(-1)) * normx;
  }
  __syncthreads();
  T s3 = 0;
  for (int64_t i = t; i < m; i += blockDim.x) s3 += v[i] * v[i];
  const T vn2 = block_sum(s3, sval);
  if (t == 0) sc[0] = vn2 > 0 ? T(2) / vn2 : T(0);
}

// part[k, c] = sum over the rows of chunk k of v[i] R[j + i, j + c]
template <typename T>
__global__ void qrp_colsum(const T* R, const T* v, T* part, int64_t n,
                           int64_t j) {
  const int64_t m = n - j;
  const int64_t c = blockIdx.x * int64_t(kCols) + threadIdx.x;
  const int64_t i0 = blockIdx.y * int64_t(kChunk);
  if (c >= m) return;
  const int64_t i1 = i0 + kChunk < m ? i0 + kChunk : m;
  T acc = 0;
  for (int64_t i = i0; i < i1; ++i) acc += v[i] * R[(j + i) * n + j + c];
  part[blockIdx.y * m + c] = acc;
}

// w[c] = scale * sum_k part[k, c]; R[j + i, j + c] -= v[i] w[c]; on row j
// the norm downdate cn[j + c] = max(cn[j + c] - R[j, j + c]^2, 0)
template <typename T>
__global__ void qrp_update_r(T* R, const T* v, const T* part, const T* sc,
                             T* cn, int64_t n, int64_t j, int64_t chunks) {
  const int64_t m = n - j;
  const int64_t c = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
  if (c >= m) return;
  T w = 0;
  for (int64_t k = 0; k < chunks; ++k) w += part[k * m + c];
  w *= sc[0];
  for (int64_t i = blockIdx.y; i < m; i += gridDim.y) {
    T* r = R + (j + i) * n + j + c;
    T x = *r - v[i] * w;
    *r = x;
    if (i == 0) {
      T d = cn[j + c] - x * x;
      cn[j + c] = d > 0 ? d : (isnan(d) ? d : T(0));
    }
  }
}

// q[r] = scale * sum_c Q[r, j + c] v[c], one warp a row
template <typename T>
__global__ void qrp_rowsum(const T* Q, const T* v, const T* sc, T* q,
                           int64_t n, int64_t j) {
  const int lane = threadIdx.x & 31;
  const int64_t r = blockIdx.x * int64_t(kRowThreads / 32)
                    + (threadIdx.x >> 5);
  if (r >= n) return;
  const int64_t m = n - j;
  T acc = 0;
  for (int64_t c = lane; c < m; c += 32) acc += Q[r * n + j + c] * v[c];
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) q[r] = acc * sc[0];
}

// Q[r, j + c] -= q[r] v[c]
template <typename T>
__global__ void qrp_update_q(T* Q, const T* v, const T* q, int64_t n,
                             int64_t j) {
  const int64_t m = n - j;
  const int64_t c = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
  if (c >= m) return;
  for (int64_t r = blockIdx.y; r < n; r += gridDim.y)
    Q[r * n + j + c] -= q[r] * v[c];
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T>
int launch(void* r, void* q, void* perm, void* cn, void* ws, int64_t n,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* R = static_cast<T*>(r);
  T* Q = static_cast<T*>(q);
  T* CN = static_cast<T*>(cn);
  int64_t* P = static_cast<int64_t*>(perm);
  // workspace: v (n), q (n), scale (1), then the column-sum partials
  // (cdiv(n, kChunk) x n)
  T* W = static_cast<T*>(ws);
  T* v = W;
  T* qv = W + n;
  T* sc = W + 2 * n;
  T* part = W + 2 * n + 1;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t m = n - j;
    const int64_t chunks = cdiv(m, kChunk);
    qrp_pivot<T><<<1, kPivotThreads, 0, s>>>(R, P, CN, v, sc, n, j);
    qrp_colsum<T><<<dim3(cdiv(m, kCols), chunks), kCols, 0, s>>>(
        R, v, part, n, j);
    const int64_t ry = std::min<int64_t>(m, 64);
    qrp_update_r<T><<<dim3(cdiv(m, 128), ry), 128, 0, s>>>(
        R, v, part, sc, CN, n, j, chunks);
    qrp_rowsum<T><<<cdiv(n, kRowThreads / 32), kRowThreads, 0, s>>>(
        Q, v, sc, qv, n, j);
    const int64_t qy = std::min<int64_t>(n, 64);
    qrp_update_q<T><<<dim3(cdiv(m, 128), qy), 128, 0, s>>>(Q, v, qv, n, j);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words of workspace qr_pivot_f32/f64 need at n
extern "C" int64_t qr_pivot_ws_words(int64_t n) {
  return 2 * n + 1 + cdiv(n, kChunk) * n;
}

extern "C" int qr_pivot_f32(void* r, void* q, void* perm, void* cn,
                            void* ws, int64_t n, void* stream) {
  return launch<float>(r, q, perm, cn, ws, n, stream);
}

extern "C" int qr_pivot_f64(void* r, void* q, void* perm, void* cn,
                            void* ws, int64_t n, void* stream) {
  return launch<double>(r, q, perm, cn, ws, n, stream);
}
