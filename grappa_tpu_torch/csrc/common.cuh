// Building blocks shared by the port's hand-written Hopper kernels
// (fused_gnn.cu, fused_block.cu, fused_symmetriser.cu): an fp32 FFMA GEMM
// tiled through shared memory with a fused bias / elu / residual /
// accumulate epilogue, a warp-per-row LayerNorm, and warp reductions.
//
// Every op is a short chain of these launches on the caller's stream. Each
// launcher returns cudaGetLastError() so a refused launch (too many threads,
// too much shared memory) reaches the Python wrapper instead of vanishing.
//
// The GEMM reads its A operand through a loader functor, so a caller can
// feed it rows that are formed on the fly (fused_symmetriser.cu forms the
// permuted, layer-normalised rows this way and never stores them).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kLnEps = 1e-5f;
constexpr int kThreads = 256;       // every kernel here runs 8 warps a block
constexpr int kWarps = kThreads / 32;

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expm1f(v);
}

// A operand stored row-major with leading dimension lda.
struct PlainLoad {
  const float* a;
  int lda;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return a[(size_t)r * lda + k];
  }
};

// C[M,N] (ldc) = epilogue(A[M,K] @ W[N,K]^T): W is a torch Linear weight
// (out, in), so both operands are read along K. Epilogue, in this order:
// + bias[n], elu, + R[m,n] (residual), + C[m,n] (accumulate).
//
// Tile BM x BN per block of 256 threads, K in steps of 8 through shared
// memory (stored K-major, padded by 4 floats against bank conflicts); each
// thread owns a TM x TN micro-tile strided by 16 rows / 16 columns so its
// shared-memory reads are conflict-free and its stores coalesce. Ragged M,
// N and K are masked in the loads and in the epilogue.
template <int BM, int BN, int TM, int TN, class ALoad>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(ALoad A, const float* __restrict__ W, int ldw,
            const float* __restrict__ bias, const float* R, int ldr,
            float* C, int ldc, int M, int N, int K, int act_elu,
            int accumulate) {
  constexpr int BK = 8;
  constexpr int RT = BM / TM;
  constexpr int CT = BN / TN;
  static_assert(RT * CT == kThreads, "one micro-tile per thread");
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tr = tid / CT, tc = tid % CT;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A(gm, gk) : 0.f;
    }
#pragma unroll
    for (int i = tid; i < BN * BK; i += kThreads) {
      const int r = i / BK, c = i % BK, gn = n0 + r, gk = k0 + c;
      Bs[c][r] = (gn < N && gk < K) ? W[(size_t)gn * ldw + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tr + i * RT];
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
    const int gm = m0 + tr + i * RT;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tc + j * CT;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias) v += bias[gn];
      if (act_elu) v = elu(v);
      if (R) v += R[(size_t)gm * ldr + gn];
      float* c = C + (size_t)gm * ldc + gn;
      if (accumulate) v += *c;
      *c = v;
    }
  }
}

// Launches the GEMM above: 128x128 tiles when they alone give at least one
// block per SM of the H100 (132), else 64x64 tiles for more blocks.
template <class ALoad>
int gemm(const ALoad& a, const float* W, int ldw, const float* bias,
         const float* R, int ldr, float* C, int ldc, int M, int N, int K,
         bool act_elu, bool accumulate, cudaStream_t st) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if ((long long)cdiv(M, 128) * cdiv(N, 128) >= 132) {
    dim3 grid(cdiv(M, 128), cdiv(N, 128));
    gemm_kernel<128, 128, 8, 8, ALoad><<<grid, kThreads, 0, st>>>(
        a, W, ldw, bias, R, ldr, C, ldc, M, N, K, act_elu, accumulate);
  } else {
    dim3 grid(cdiv(M, 64), cdiv(N, 64));
    gemm_kernel<64, 64, 4, 4, ALoad><<<grid, kThreads, 0, st>>>(
        a, W, ldw, bias, R, ldr, C, ldc, M, N, K, act_elu, accumulate);
  }
  return (int)cudaGetLastError();
}

// y[m, :L] = LayerNorm(x[m, :L]) * g + b, one warp per row, two passes
// (mean, then the variance of the centred row) as the JAX _ln_fwd.
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const float* __restrict__ x, int ldx, float* __restrict__ y,
                 int ldy, const float* __restrict__ g,
                 const float* __restrict__ b, int M, int L) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + (size_t)row * ldx;
  float s = 0.f;
  for (int j = lane; j < L; j += 32) s += xr[j];
  const float mean = warp_sum(s) / L;
  float v = 0.f;
  for (int j = lane; j < L; j += 32) {
    const float d = xr[j] - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / L + kLnEps);
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

}  // namespace

#define RETURN_IF_ERR(expr)           \
  do {                                \
    const int err_ = (expr);          \
    if (err_ != 0) return err_;       \
  } while (0)
