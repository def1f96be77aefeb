// Building blocks shared by the port's hand-written Hopper kernels
// (fused_gnn.cu, fused_block.cu, fused_symmetriser.cu, dropout.cu): the
// operand views (Mat, Tr) and epilogue functors of tc_gemm.cuh's
// tensor-core GEMM, on which every product of the port runs, a fixed-order
// sum of split-K slices, column sums, warp-per-row LayerNorm forward and
// backward, and a Philox4x32-10 dropout mask.
//
// Every op is a chain of these launches on the caller's stream. Each
// launcher returns cudaGetLastError() so a refused launch (too many threads,
// too much shared memory) reaches the Python wrapper instead of vanishing.
//
// Nothing here uses float atomics: a reduction across blocks writes
// per-block partial sums and a second pass adds them in a fixed order, so two
// runs on the same inputs give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kLnEps = 1e-5f;
constexpr int kThreads = 256;       // every kernel here runs 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 16;      // split-K slices of a weight gradient
constexpr int kColChunk = 64;       // rows per partial of a column sum

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

#define RETURN_IF_ERR(expr)           \
  do {                                \
    const int err_ = (expr);          \
    if (err_ != 0) return err_;       \
  } while (0)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expm1f(v);
}

// d elu(t) / dt formed from the stored activation a = elu(t): 1 where
// a > 0, else a + 1 (= exp(t)), so no backward recomputes or reloads t.
__device__ __forceinline__ float elu_grad_of(float a) {
  return a > 0.f ? 1.f : a + 1.f;
}

// ---------------------------------------------------------------- dropout
// Philox4x32-10 (Salmon et al., SC'11) with key (seed, stream) and counter
// (idx low word, idx high word, 0, 0); returns the first output word. A mask
// element is a pure function of (seed, stream, flat index), whatever the
// tiling. ops/philox.py computes the same bits with PyTorch ops.
__device__ __forceinline__ uint32_t philox_bits(uint32_t seed,
                                                uint32_t stream,
                                                unsigned long long idx) {
  uint32_t c0 = (uint32_t)idx, c1 = (uint32_t)(idx >> 32), c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = stream;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// A dropout mask over a matrix `cols` wide: element (m, n) keeps with
// factor `scale` (= 1 / (1 - rate), rounded to float32 by the wrapper) iff
// its bits >= threshold (= round(rate * 2^32)), else 0 -- the JAX
// _dropout_mask rule. on == 0 means no dropout.
//
// Built with GRAPPA_SHARDED_DROP (fused_gnn_rows.cu and fused_block_rows.cu,
// K1's and K2's files again for their `_rows` entry points) a mask is a
// shard's: the tensor's matrix is blocks of `rows` rows, each holding rows
// row0 .. row0 + rows - 1 of a block of rows_glob rows (K1: one block of a
// rank's nodes; K2: S blocks of a rank's tuples), and element (m, n) draws
// the bits of its place in the unsharded tensor: local row m = s * rows + t
// is row s * rows_glob + row0 + t. Without it Drop is the unsharded mask
// alone, so the entry points every other path calls keep their code.
#ifndef GRAPPA_SHARDED_DROP
struct Drop {
  uint32_t seed, stream, threshold;
  float scale;
  int on, cols;
  __device__ __forceinline__ float at(unsigned long long idx) const {
    return philox_bits(seed, stream, idx) >= threshold ? scale : 0.f;
  }
  __device__ __forceinline__ float operator()(int m, int n) const {
    return at((unsigned long long)m * cols + n);
  }
};
#else
struct Drop {
  uint32_t seed, stream, threshold;
  float scale;
  int on, cols;
  long long rows, rows_glob, row0;
  __device__ __forceinline__ float keep(unsigned long long idx) const {
    return philox_bits(seed, stream, idx) >= threshold ? scale : 0.f;
  }
  // the flat index of local element (m, n) in the unsharded tensor
  __device__ __forceinline__ unsigned long long index(
      unsigned long long m, unsigned long long n) const {
    const unsigned long long s = m / (unsigned long long)rows;
    m += s * (unsigned long long)(rows_glob - rows) + row0;
    return m * (unsigned long long)cols + n;
  }
  // by the local flat index
  __device__ __forceinline__ float at(unsigned long long idx) const {
    const unsigned long long m = idx / (unsigned long long)cols;
    return keep(index(m, idx - m * (unsigned long long)cols));
  }
  __device__ __forceinline__ float operator()(int m, int n) const {
    return keep(index((unsigned long long)m, (unsigned long long)n));
  }
};
#endif

inline Drop make_drop(uint32_t seed, uint32_t stream, uint32_t threshold,
                      float scale, int on, int cols) {
  Drop d;
  d.seed = seed;
  d.stream = stream;
  d.threshold = threshold;
  d.scale = scale;
  d.on = on;
  d.cols = cols;
#ifdef GRAPPA_SHARDED_DROP
  d.rows = d.rows_glob = 1;
  d.row0 = 0;
#endif
  return d;
}

// The dropout arguments of K1's and K2's C entry points and the masks they
// make: (seed, threshold, scale, on), and in the GRAPPA_SHARDED_DROP
// object the `_rows` entry points' rows_glob and row0 as well.
#ifdef GRAPPA_SHARDED_DROP
#define GRAPPA_ENTRY(name) name##_rows
#define GRAPPA_DROP_PARAMS                                               \
  uint32_t seed, uint32_t threshold, float drop_scale, int drop_on,     \
      long long rows_glob, long long row0
inline Drop shard_drop(Drop d, long long rows, long long rows_glob,
                       long long row0) {
  d.rows = rows;
  d.rows_glob = rows_glob;
  d.row0 = row0;
  return d;
}
#define GRAPPA_DROP(stream, cols, rows)                                  \
  shard_drop(make_drop(seed, stream, threshold, drop_scale, drop_on, cols), \
             rows, rows_glob, row0)
#else
#define GRAPPA_ENTRY(name) name
#define GRAPPA_DROP_PARAMS                                               \
  uint32_t seed, uint32_t threshold, float drop_scale, int drop_on
#define GRAPPA_DROP(stream, cols, rows)                                  \
  make_drop(seed, stream, threshold, drop_scale, drop_on, cols)
#endif

// ---------------------------------------------------------------- operands
// A GEMM operand is viewed as L(i, k): row i of the product's side, k along
// the reduction. A forward product A @ W^T reads a torch Linear weight W
// (out, in) as Mat{W, in}; dX = dY @ W reads it as tr(Mat{W, in}); dW =
// dY^T @ X reads both operands transposed.

// Row-major matrix: (r, k) -> a[r * ld + k].
struct Mat {
  const float* a;
  int ld;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return a[(size_t)r * ld + k];
  }
};

// Transposed view: (r, k) -> inner(k, r).
template <class L>
struct Tr {
  L in;
};

template <class L>
Tr<L> tr(const L& l) { return Tr<L>{l}; }

// ---------------------------------------------------------------- epilogues
// tc_gemm.cuh hands each sum to epi(z, m, n, v): z the split-K slice, (m, n)
// the element's place in the M x N product, v = sum_k A(m, k) B(n, k).

// The output epilogue, in this order: + bias[n], elu, x dropout mask,
// + R[m, n] (residual), store to C[m, n].
struct Out {
  const float* bias;
  int act_elu;
  Drop drop;
  const float* R;
  int ldr;
  float* C;
  int ldc;
  __device__ __forceinline__ void operator()(int, int m, int n,
                                             float v) const {
    if (bias) v += bias[n];
    if (act_elu) v = elu(v);
    if (drop.on) v *= drop(m, n);
    if (R) v += R[(size_t)m * ldr + n];
    C[(size_t)m * ldc + n] = v;
  }
};

inline Out out_to(float* C, int ldc) {
  Out o;
  o.bias = nullptr;
  o.act_elu = 0;
  o.drop = make_drop(0, 0, 0, 1.f, 0, 0);
  o.R = nullptr;
  o.ldr = 0;
  o.C = C;
  o.ldc = ldc;
  return o;
}

// The backward of an elu layer: C[m, n] = v x elu'(t[m, n]), elu' formed
// from the stored activation a = elu(t) (elu_grad_of).
struct EluGradOut {
  float* C;
  int ldc;
  const float* a;
  int lda;
  __device__ __forceinline__ void operator()(int, int m, int n,
                                             float v) const {
    C[(size_t)m * ldc + n] = v * elu_grad_of(a[(size_t)m * lda + n]);
  }
};

// Split-K partial sums: slice z of the reduction writes P[z][m][n].
struct Partial {
  float* P;
  int M, N;
  __device__ __forceinline__ void operator()(int z, int m, int n,
                                             float v) const {
    P[((size_t)z * M + m) * N + n] = v;
  }
};

// ---------------------------------------------------------------- sums
// y[i] = sum_z P[z * n + i] for z in 0..Z-1, in that order.
__global__ void __launch_bounds__(kThreads)
sum_slices_kernel(const float* __restrict__ P, float* __restrict__ y, int Z,
                  long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc = P[i];
  for (int z = 1; z < Z; ++z) acc += P[(size_t)z * n + i];
  y[i] = acc;
}

int sum_slices(const float* P, float* y, int Z, long long n,
               cudaStream_t st) {
  if (n > 0)
    sum_slices_kernel<<<cdiv(n, kThreads), kThreads, 0, st>>>(P, y, Z, n);
  return (int)cudaGetLastError();
}

// Floats of split-K scratch a weight gradient of M x N needs.
inline long long wgrad_scratch(long long M, long long N) {
  return kMaxSplits * M * N;
}

// The offset of the next n floats of a scratch layout, advancing o by n
// rounded up to 4: every piece starts 16-byte aligned, so tc_gemm.cuh's
// 16-byte copies apply to it whatever the row counts.
inline size_t carve(size_t& o, long long n) {
  const size_t at = o;
  o += (size_t)((n + 3) / 4 * 4);
  return at;
}

// ---------------------------------------------------------------- column sums
// out[n] = sum_m V(m, n): rows in chunks of 64 per block, one thread per
// column; the chunks' partials are added in chunk order.
template <class V>
__global__ void __launch_bounds__(kThreads)
colsum_partial_kernel(V v, float* __restrict__ partial, int M, int N) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int m0 = blockIdx.y * kColChunk;
  const int m1 = min(M, m0 + kColChunk);
  float acc = 0.f;
  for (int m = m0; m < m1; ++m) acc += v(m, n);
  partial[(size_t)blockIdx.y * N + n] = acc;
}

// Floats of partials a column sum over M rows of N columns needs.
inline long long colsum_scratch(long long M, long long N) {
  return (M > 0 ? cdiv(M, kColChunk) : 1) * N;
}

template <class V>
int colsum(const V& v, float* out, int M, int N, float* partial,
           cudaStream_t st) {
  if (N == 0) return (int)cudaGetLastError();
  const int chunks = M > 0 ? cdiv(M, kColChunk) : 1;
  dim3 grid(cdiv(N, kThreads), chunks);
  colsum_partial_kernel<V><<<grid, kThreads, 0, st>>>(v, partial, M, N);
  RETURN_IF_ERR((int)cudaGetLastError());
  return sum_slices(partial, out, chunks, N, st);
}

// The LayerNorm scale's gradient term: dy(m, n) * xhat(m, n).
template <class XL>
struct LnGradVal {
  Mat dy;
  XL x;
  const float* mean;
  const float* rstd;
  __device__ __forceinline__ float operator()(int m, int n) const {
    return dy(m, n) * (x(m, n) - mean[m]) * rstd[m];
  }
};

// ---------------------------------------------------------------- LayerNorm
// Row mean and 1/std of L-wide rows read through a loader, one warp per row,
// two passes (mean, then the variance of the centred row) as the JAX _ln_fwd.
template <class XL>
__device__ __forceinline__ void row_moments(const XL& x, int row, int L,
                                            int lane, float& mean,
                                            float& rstd) {
  float s = 0.f;
  for (int j = lane; j < L; j += 32) s += x(row, j);
  mean = warp_sum(s) / L;
  float v = 0.f;
  for (int j = lane; j < L; j += 32) {
    const float d = x(row, j) - mean;
    v += d * d;
  }
  rstd = rsqrtf(warp_sum(v) / L + kLnEps);
}

// y[m, :L] = LayerNorm(x[m, :L]) * g + b.
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const float* __restrict__ x, int ldx, float* __restrict__ y,
                 int ldy, const float* __restrict__ g,
                 const float* __restrict__ b, int M, int L) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  float mean, rstd;
  row_moments(Mat{x, ldx}, row, L, lane, mean, rstd);
  const float* xr = x + (size_t)row * ldx;
  float* yr = y + (size_t)row * ldy;
  for (int j = lane; j < L; j += 32)
    yr[j] = (xr[j] - mean) * rstd * g[j] + b[j];
}

int layernorm(const float* x, int ldx, float* y, int ldy, const float* g,
              const float* b, int M, int L, cudaStream_t st) {
  if (M > 0)
    layernorm_kernel<<<cdiv(M, kWarps), kThreads, 0, st>>>(x, ldx, y, ldy, g,
                                                           b, M, L);
  return (int)cudaGetLastError();
}

// LayerNorm backward, one warp per row, as the JAX _ln_bwd: with
// xhat = (x - mean) * rstd and dxhat = dy * g,
//   dx = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * rstd.
// The row's mean and rstd go to mean_out / rstd_out for the dgamma sum.
template <class XL>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const float* __restrict__ dy, int ldy, XL x,
                     const float* __restrict__ g, float* __restrict__ dx,
                     int ldx, float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, int M, int L) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  float mean, rstd;
  row_moments(x, row, L, lane, mean, rstd);
  const float* dyr = dy + (size_t)row * ldy;
  float a = 0.f, b = 0.f;
  for (int j = lane; j < L; j += 32) {
    const float dxh = dyr[j] * g[j];
    a += dxh;
    b += dxh * (x(row, j) - mean) * rstd;
  }
  a = warp_sum(a) / L;
  b = warp_sum(b) / L;
  float* dxr = dx + (size_t)row * ldx;
  for (int j = lane; j < L; j += 32) {
    const float xhat = (x(row, j) - mean) * rstd;
    dxr[j] = (dyr[j] * g[j] - a - xhat * b) * rstd;
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// dx, then dgamma and dbeta (column sums over the M rows).
template <class XL>
int layernorm_bwd(const float* dy, const XL& x, const float* g, float* dx,
                  float* dg, float* db, int M, int L, float* mean,
                  float* rstd, float* partial, cudaStream_t st) {
  if (M > 0)
    layernorm_bwd_kernel<XL><<<cdiv(M, kWarps), kThreads, 0, st>>>(
        dy, L, x, g, dx, L, mean, rstd, M, L);
  RETURN_IF_ERR((int)cudaGetLastError());
  RETURN_IF_ERR(colsum(LnGradVal<XL>{Mat{dy, L}, x, mean, rstd}, dg, M, L,
                       partial, st));
  return colsum(Mat{dy, L}, db, M, L, partial, st);
}

// ---------------------------------------------------------------- elementwise
// y[m, n] = x[m, n] * mask(m, n) * elu'(m, n) over an M x N matrix, elu'
// formed from the stored activation act (elu_grad_of); either factor is left
// out when its mask is off / act is null.
__global__ void __launch_bounds__(kThreads)
mask_grad_kernel(const float* __restrict__ x, Drop drop,
                 const float* __restrict__ act, float* __restrict__ y,
                 long long total) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  float v = x[i];
  if (drop.on) v *= drop.at((unsigned long long)i);
  if (act) v *= elu_grad_of(act[i]);
  y[i] = v;
}

int mask_grad(const float* x, const Drop& drop, const float* act, float* y,
              int M, int N, cudaStream_t st) {
  const long long total = (long long)M * N;
  if (total > 0)
    mask_grad_kernel<<<cdiv(total, kThreads), kThreads, 0, st>>>(
        x, drop, act, y, total);
  return (int)cudaGetLastError();
}

}  // namespace
