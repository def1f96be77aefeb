// The passes that make the bf16 operands of wg_gemm.cuh's products, shared
// by the bf16 modes of K2 / K2b (fused_block.cu) and K3 / K3b
// (fused_symmetriser.cu): a LayerNorm that stores its output in float32 and
// in bf16, and a cast pass (with an optional dropout mask) from float32 to
// bf16 rows padded to a multiple of 8 elements, as TMA requires. Each
// value is rounded once, to nearest even, where it is made; the float32
// copies feed the epilogues, the column sums and the LayerNorm backward.
// Also the bf16 views of a float32 scratch buffer (offsets in floats, each
// piece carved 16-byte aligned by common.cuh's carve).
#pragma once

#include "wg_gemm.cuh"

namespace {

// Floats of n bf16 elements.
inline long long h_floats(long long n) { return (n + 1) / 2; }

bf16* as_h(float* base, size_t at) {
  return reinterpret_cast<bf16*>(base + at);
}
const bf16* as_h(const float* base, size_t at) {
  return reinterpret_cast<const bf16*>(base + at);
}

// LayerNorm (layernorm_kernel) storing y in float32 and, rounded, in bf16
// (rows ldh apart).
__global__ void __launch_bounds__(kThreads)
layernorm_h_kernel(const float* __restrict__ x, float* __restrict__ y,
                   bf16* __restrict__ yh, int ldh,
                   const float* __restrict__ g, const float* __restrict__ b,
                   int M, int L) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  float mean, rstd;
  row_moments(Mat{x, L}, row, L, lane, mean, rstd);
  const float* xr = x + (size_t)row * L;
  float* yr = y + (size_t)row * L;
  bf16* yhr = yh + (size_t)row * ldh;
  for (int j = lane; j < L; j += 32) {
    const float v = (xr[j] - mean) * rstd * g[j] + b[j];
    yr[j] = v;
    yhr[j] = __float2bfloat16_rn(v);
  }
}

int layernorm_h(const float* x, float* y, bf16* yh, int ldh, const float* g,
                const float* b, int M, int L, cudaStream_t st) {
  if (M > 0)
    layernorm_h_kernel<<<cdiv(M, kWarps), kThreads, 0, st>>>(x, y, yh, ldh,
                                                             g, b, M, L);
  return (int)cudaGetLastError();
}

// One rows x cols float32 matrix x (contiguous) to bf16: yh[m, n] (rows ldh
// apart) = bf16(x[m, n] * mask(m, n)), the masked value also to y in float32
// when y is set (mask_grad's rule: the mask counted by the flat index).
struct ToBf16 {
  const float* x;
  Drop drop;
  float* y;
  bf16* yh;
  int rows, cols, ldh;
};

constexpr int kMaxCasts = 4;
struct ToBf16Jobs {
  ToBf16 job[kMaxCasts];
};

// blockIdx.y picks the job (read in place: the jobs are a grid constant).
__global__ void __launch_bounds__(kThreads)
to_bf16_kernel(const __grid_constant__ ToBf16Jobs jobs) {
  const ToBf16& j = jobs.job[blockIdx.y];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)j.rows * j.cols) return;
  float v = j.x[i];
  if (j.drop.on) v *= j.drop.at((unsigned long long)i);
  if (j.y) j.y[i] = v;
  const long long m = i / j.cols;
  j.yh[m * j.ldh + (i - m * j.cols)] = __float2bfloat16_rn(v);
}

// The n jobs, kMaxCasts a launch.
int to_bf16(const ToBf16* jobs, int n, cudaStream_t st) {
  for (int k0 = 0; k0 < n; k0 += kMaxCasts) {
    const int m = n - k0 < kMaxCasts ? n - k0 : kMaxCasts;
    ToBf16Jobs all{};
    long long most = 0;
    for (int k = 0; k < m; ++k) {
      all.job[k] = jobs[k0 + k];
      const long long e = (long long)all.job[k].rows * all.job[k].cols;
      most = e > most ? e : most;
    }
    if (most > 0)
      to_bf16_kernel<<<dim3(cdiv(most, kThreads), m), kThreads, 0, st>>>(
          all);
    RETURN_IF_ERR((int)cudaGetLastError());
  }
  return (int)cudaGetLastError();
}

ToBf16 cast_of(const float* x, bf16* yh, int rows, int cols, int ldh,
               const Drop& drop = make_drop(0, 0, 0, 1.f, 0, 0),
               float* y = nullptr) {
  return ToBf16{x, drop, y, yh, rows, cols, ldh};
}

}  // namespace
