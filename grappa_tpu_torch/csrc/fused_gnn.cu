// K1: one GNN ResidualAttentionBlock after the neighbour gather, forward.
//
// Replaces the Pallas kernel grappa_tpu/ops/fused_gnn.py::fused_gnn_block
// (forward: _fused_fwd -> _fwd_kernel -> _forward_body / _attention):
//   scores over D <= 8 neighbour slots per head, x 1/sqrt(dh), masked
//   softmax (-1e30 fill, masked slots out of the denominator, all-masked
//   rows -> 0, denominator >= 1e-9), message sum; then head_reducer + bias
//   + hn, LayerNorm (interaction_norm), F->4F elu, 4F->F elu, + LN output.
//
// Bound on an H100 SXM: at the protein-scale shape (N=1376, F=512, D=8)
// the three dense products are 2*N*(F*F + 2*F*4F) = 6.5 GFLOP against
// ~40 MB of input, output and weights, so it is bound by operations: about
// 0.1 ms at the 67 TFLOP/s fp32 peak outside the tensor cores (memory
// alone would take ~0.012 ms at 3.35 TB/s).
//
// Design (bring-up, right before fast): a chain of five launches on the
// caller's stream -- the attention pass (one warp per node and head, the
// D slot scores reduced across the warp's lanes), then three shared-memory
// tiled fp32 FFMA GEMMs with fused epilogues around one LayerNorm pass.
// The GEMMs carry all the FLOPs and are where the bound is won or lost; a
// later PR moves them onto the tensor cores (wgmma, TF32 or bf16) and fuses
// the chain into fewer passes. The ragged node edge is masked in every
// kernel, so nothing is padded.
#include "common.cuh"

namespace {

// attn0[n, h*dh:(h+1)*dh] = sum_d alpha[d, n, h] * nbr[d, n, h*dh:(h+1)*dh]
__global__ void __launch_bounds__(kThreads)
gnn_attention_kernel(const float* __restrict__ feat,
                     const float* __restrict__ nbr,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int N, int F, int D, int H, float scale) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= N * H) return;
  const int n = w / H, h = w - n * H;
  const int dh = F / H;
  const float* fr = feat + (size_t)n * F + h * dh;

  float sc[8], m = -1e30f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    sc[d] = -1e30f;
    if (d < D) {
      const float* nr = nbr + ((size_t)d * N + n) * F + h * dh;
      float p = 0.f;
      for (int j = lane; j < dh; j += 32) p += fr[j] * nr[j];
      p = warp_sum(p);
      sc[d] = mask[(size_t)d * N + n] > 0.f ? p * scale : -1e30f;
      m = fmaxf(m, sc[d]);
    }
  }
  float e[8], denom = 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    e[d] = 0.f;
    if (d < D) {
      e[d] = expf(sc[d] - m) * mask[(size_t)d * N + n];
      denom += e[d];
    }
  }
  denom = fmaxf(denom, 1e-9f);
  for (int j = lane; j < dh; j += 32) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d)
      if (d < D)
        acc += (e[d] / denom) * nbr[((size_t)d * N + n) * F + h * dh + j];
    out[(size_t)n * F + h * dh + j] = acc;
  }
}

}  // namespace

extern "C" {

// Floats of scratch the wrapper allocates: attn0, x1, x1n (N x F each) and
// the hidden activation (N x hid).
long long grappa_fused_gnn_scratch(int n, int f, int hid) {
  return 3LL * n * f + (long long)n * hid;
}

// feat, hn, y: (N, F); nbr: (D, N, F); mask: (D, N); weights in torch
// Linear layout (out, in): wr (F, F), w1 (hid, F), w2 (F, hid).
int grappa_fused_gnn_fwd(const float* feat, const float* nbr, const float* hn,
                         const float* mask, const float* wr, const float* br,
                         const float* g2, const float* b2, const float* w1,
                         const float* c1, const float* w2, const float* c2,
                         float* scratch, float* y, int n, int f, int hid,
                         int d, int n_heads, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* attn0 = scratch;
  float* x1 = attn0 + (size_t)n * f;
  float* x1n = x1 + (size_t)n * f;
  float* e1 = x1n + (size_t)n * f;
  if (n > 0)
    gnn_attention_kernel<<<cdiv((long long)n * n_heads, kWarps), kThreads, 0,
                           st>>>(feat, nbr, mask, attn0, n, f, d, n_heads,
                                 scale);
  RETURN_IF_ERR((int)cudaGetLastError());
  // x1 = attn0 @ wr^T + br + hn
  RETURN_IF_ERR(gemm(PlainLoad{attn0, f}, wr, f, br, hn, f, x1, f, n, f, f,
                     false, false, st));
  RETURN_IF_ERR(layernorm(x1, f, x1n, f, g2, b2, n, f, st));
  // e1 = elu(x1n @ w1^T + c1)
  RETURN_IF_ERR(gemm(PlainLoad{x1n, f}, w1, f, c1, nullptr, 0, e1, hid, n,
                     hid, f, true, false, st));
  // y = elu(e1 @ w2^T + c2) + x1n
  return gemm(PlainLoad{e1, hid}, w2, hid, c2, x1n, f, y, f, n, f, hid, true,
              false, st);
}

}  // extern "C"
