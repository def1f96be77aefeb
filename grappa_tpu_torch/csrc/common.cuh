// Building blocks shared by the port's hand-written Hopper kernels
// (fused_gnn.cu, fused_block.cu, fused_symmetriser.cu, dropout.cu): an fp32
// FFMA GEMM tiled through shared memory whose operands are read through
// loader functors and whose result goes through an epilogue functor, a
// split-K weight-gradient product with a fixed-order reduction, column sums,
// warp-per-row LayerNorm forward and backward, and a Philox4x32-10 dropout
// mask.
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

// d elu(v) / dv from the pre-activation v, as the JAX _elu_grad.
__device__ __forceinline__ float elu_grad(float v) {
  return v > 0.f ? 1.f : expf(v);
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

inline Drop make_drop(uint32_t seed, uint32_t stream, uint32_t threshold,
                      float scale, int on, int cols) {
  Drop d;
  d.seed = seed;
  d.stream = stream;
  d.threshold = threshold;
  d.scale = scale;
  d.on = on;
  d.cols = cols;
  return d;
}

// ---------------------------------------------------------------- loaders
// A GEMM operand is read as L(i, k): row i of the product's side, k along
// the reduction. kAlongK says which index is contiguous in memory, so the
// shared-memory fill lets neighbouring threads read neighbouring addresses.

// Row-major matrix: (r, k) -> a[r * ld + k].
struct Mat {
  const float* a;
  int ld;
  static constexpr bool kAlongK = true;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return a[(size_t)r * ld + k];
  }
};

// Transposed view: (r, k) -> inner(k, r).
template <class L>
struct Tr {
  L in;
  static constexpr bool kAlongK = !L::kAlongK;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return in(k, r);
  }
};

// elu applied on load: the activation formed from a stored pre-activation.
template <class L>
struct Elu {
  L in;
  static constexpr bool kAlongK = L::kAlongK;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return elu(in(r, k));
  }
};

template <class L>
Tr<L> tr(const L& l) { return Tr<L>{l}; }

// ---------------------------------------------------------------- epilogues
// The output epilogue, in this order: + bias[n], elu, x dropout mask,
// x elu'(gate[m, n]) (gate: a stored pre-activation), + R[m, n] (residual),
// store to C[m, n].
struct Out {
  const float* bias;
  int act_elu;
  Drop drop;
  const float* gate;
  int ldg;
  const float* R;
  int ldr;
  float* C;
  int ldc;
  __device__ __forceinline__ void operator()(int, int m, int n,
                                             float v) const {
    if (bias) v += bias[n];
    if (act_elu) v = elu(v);
    if (drop.on) v *= drop(m, n);
    if (gate) v *= elu_grad(gate[(size_t)m * ldg + n]);
    if (R) v += R[(size_t)m * ldr + n];
    C[(size_t)m * ldc + n] = v;
  }
};

inline Out out_to(float* C, int ldc) {
  Out o;
  o.bias = nullptr;
  o.act_elu = 0;
  o.drop = make_drop(0, 0, 0, 1.f, 0, 0);
  o.gate = nullptr;
  o.ldg = 0;
  o.R = nullptr;
  o.ldr = 0;
  o.C = C;
  o.ldc = ldc;
  return o;
}

// Split-K partial sums: slice z of the reduction writes P[z][m][n].
struct Partial {
  float* P;
  int M, N;
  __device__ __forceinline__ void operator()(int z, int m, int n,
                                             float v) const {
    P[((size_t)z * M + m) * N + n] = v;
  }
};

// ---------------------------------------------------------------- GEMM
// epi(z, m, n, sum_k A(m, k) * B(n, k)) with k over blockIdx.z's slice
// [z * k_chunk, (z + 1) * k_chunk) of [0, K). A forward product A @ W^T
// reads a torch Linear weight W (out, in) as Mat{W, in}; dX = dY @ W reads it
// as tr(Mat{W, in}); dW = dY^T @ X reads both operands transposed.
//
// Tile BM x BN per block of 256 threads, K in steps of 8 through shared
// memory (stored K-major, padded by 4 floats against bank conflicts); each
// thread owns a TM x TN micro-tile strided by 16 rows / 16 columns so its
// shared-memory reads are conflict-free. Ragged M, N and K are masked.
template <int BM, int BN, int TM, int TN, class AL, class BL, class Epi>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(AL A, BL B, Epi epi, int M, int N, int K, int k_chunk) {
  constexpr int BK = 8;
  constexpr int RT = BM / TM;
  constexpr int CT = BN / TN;
  static_assert(RT * CT == kThreads, "one micro-tile per thread");
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tr_ = tid / CT, tc = tid % CT;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
#pragma unroll
    for (int i = tid; i < BM * BK; i += kThreads) {
      int r, c;
      if constexpr (AL::kAlongK) {
        r = i / BK;
        c = i % BK;
      } else {
        c = i / BM;
        r = i % BM;
      }
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < ke) ? A(gm, gk) : 0.f;
    }
#pragma unroll
    for (int i = tid; i < BN * BK; i += kThreads) {
      int r, c;
      if constexpr (BL::kAlongK) {
        r = i / BK;
        c = i % BK;
      } else {
        c = i / BN;
        r = i % BN;
      }
      const int gn = n0 + r, gk = k0 + c;
      Bs[c][r] = (gn < N && gk < ke) ? B(gn, gk) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tr_ + i * RT];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tc + j * CT];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tr_ + i * RT;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tc + j * CT;
      if (gn < N) epi(blockIdx.z, gm, gn, acc[i][j]);
    }
  }
}

// 128x128 tiles when they alone give at least one block per SM of the H100
// (132), else 64x64 tiles for more blocks.
template <class AL, class BL, class Epi>
int launch_gemm(const AL& a, const BL& b, const Epi& epi, int M, int N, int K,
                int splits, int k_chunk, cudaStream_t st) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if ((long long)cdiv(M, 128) * cdiv(N, 128) * splits >= 132) {
    dim3 grid(cdiv(M, 128), cdiv(N, 128), splits);
    gemm_kernel<128, 128, 8, 8, AL, BL, Epi><<<grid, kThreads, 0, st>>>(
        a, b, epi, M, N, K, k_chunk);
  } else {
    dim3 grid(cdiv(M, 64), cdiv(N, 64), splits);
    gemm_kernel<64, 64, 4, 4, AL, BL, Epi><<<grid, kThreads, 0, st>>>(
        a, b, epi, M, N, K, k_chunk);
  }
  return (int)cudaGetLastError();
}

// epi(A B^T) over the whole of K in one pass.
template <class AL, class BL, class Epi>
int gemm(const AL& a, const BL& b, const Epi& epi, int M, int N, int K,
         cudaStream_t st) {
  return launch_gemm(a, b, epi, M, N, K, 1, K > 0 ? K : 1, st);
}

// The forward form: C = epilogue(A @ W^T) with W (N, K) row-major.
template <class AL>
int gemm(const AL& a, const float* W, int ldw, const float* bias,
         const float* R, int ldr, float* C, int ldc, int M, int N, int K,
         bool act_elu, cudaStream_t st,
         Drop drop = make_drop(0, 0, 0, 1.f, 0, 0)) {
  Out o = out_to(C, ldc);
  o.bias = bias;
  o.act_elu = act_elu;
  o.drop = drop;
  o.R = R;
  o.ldr = ldr;
  return gemm(a, Mat{W, ldw}, o, M, N, K, st);
}

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

// Slices of the reduction axis for a weight gradient: enough blocks for two
// waves on 132 SMs, each slice at least 256 rows long. A pure function of
// the shape, so the summation order is fixed.
inline int wgrad_splits(int M, int N, int K) {
  const long long tiles = (long long)cdiv(M, 64) * cdiv(N, 64);
  int s = cdiv(264, tiles);
  s = s < K / 256 ? s : K / 256;
  s = s < kMaxSplits ? s : kMaxSplits;
  return s > 1 ? s : 1;
}

// Floats of split-K scratch a weight gradient of M x N needs.
inline long long wgrad_scratch(long long M, long long N) {
  return kMaxSplits * M * N;
}

// dW[m, n] = sum_k A(m, k) B(n, k) over a long k (the rows of a batch):
// the slices of k run in parallel into `partial` and sum_slices adds them in
// slice order.
template <class AL, class BL>
int gemm_wgrad(const AL& a, const BL& b, float* dW, int M, int N, int K,
               float* partial, cudaStream_t st) {
  const int s = wgrad_splits(M, N, K);
  if (s == 1) return gemm(a, b, out_to(dW, N), M, N, K, st);
  const int chunk = cdiv(cdiv(K, s), 8) * 8;
  const int used = cdiv(K, chunk);
  RETURN_IF_ERR(launch_gemm(a, b, Partial{partial, M, N}, M, N, K, used,
                            chunk, st));
  return sum_slices(partial, dW, used, (long long)M * N, st);
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

// Row statistics only (mean[m], rstd[m]) of rows read through a loader.
template <class XL>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(XL x, float* __restrict__ mean, float* __restrict__ rstd,
                 int M, int L) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  float mu, rs;
  row_moments(x, row, L, lane, mu, rs);
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

template <class XL>
int row_stats(const XL& x, float* mean, float* rstd, int M, int L,
              cudaStream_t st) {
  if (M > 0)
    row_stats_kernel<XL><<<cdiv(M, kWarps), kThreads, 0, st>>>(x, mean, rstd,
                                                               M, L);
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
// y[m, n] = x[m, n] * mask(m, n) * elu'(gate[m, n]) over an M x N matrix;
// either factor is left out when its mask is off / its gate is null.
__global__ void __launch_bounds__(kThreads)
mask_grad_kernel(const float* __restrict__ x, Drop drop,
                 const float* __restrict__ gate, float* __restrict__ y,
                 long long total) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  float v = x[i];
  if (drop.on) v *= drop.at((unsigned long long)i);
  if (gate) v *= elu_grad(gate[i]);
  y[i] = v;
}

int mask_grad(const float* x, const Drop& drop, const float* gate, float* y,
              int M, int N, cudaStream_t st) {
  const long long total = (long long)M * N;
  if (total > 0)
    mask_grad_kernel<<<cdiv(total, kThreads), kThreads, 0, st>>>(
        x, drop, gate, y, total);
  return (int)cudaGetLastError();
}

}  // namespace
