// K1 / K1b: one GNN ResidualAttentionBlock after the neighbour gather,
// forward (with dropout) and backward.
//
// Replaces the Pallas kernels of grappa_tpu/ops/fused_gnn.py::
// fused_gnn_block: the forward _fused_fwd -> _fwd_kernel -> _forward_body /
// _attention, and the backward _fused_bwd -> _bwd_kernel:
//   scores over D <= 8 neighbour slots per head, x 1/sqrt(dh), masked
//   softmax (-1e30 fill, masked slots out of the denominator, all-masked
//   rows -> 0, denominator >= 1e-9), message sum; then head_reducer + bias,
//   dropout (mask 1), + hn, LayerNorm (interaction_norm), F->4F elu,
//   4F->F elu, dropout (mask 2), + LN output.
// Dropout masks are Philox bits keyed by (seed, 0) and (seed, 1), counted
// by the element's flat index in the (N, F) output (common.cuh).
//
// Bound on an H100 SXM: the forward's three dense products are
// 2*(F*F + 2*F*4F) = 4.7 MFLOP a row (F=512), against ~8 KB a row of input
// and output with D=8 slots: bound by operations at the 67 TFLOP/s fp32
// peak outside the tensor cores. The backward's own work is two products
// per forward product (dX = dY W and dW = dY^T X), 9.4 MFLOP a row; this
// design also recomputes the forward (as JAX, which saves only the op's
// inputs), so it runs 3x the forward, 14.2 MFLOP a row. At the 128-molecule
// training batch (N=3376 padded rows): 15.9 GFLOP forward, 0.24 ms at the
// peak; 31.9 GFLOP backward, 0.48 ms.
//
// Design (bring-up, right before fast): chains of launches on the caller's
// stream -- the attention pass (one warp per node and head, the D slot
// scores reduced across the warp's lanes), shared-memory tiled fp32 FFMA
// GEMMs with fused epilogues (bias, elu, dropout, residual) and LayerNorm
// passes. The backward recomputes attn0, x1, x1n and the two
// pre-activations into scratch, regenerates the masks from the seed (no mask
// is stored), and reduces the weight gradients over the N rows in split-K
// slices plus a fixed-order sum (no atomics: two runs give the same bits).
// The ragged node edge is masked in every kernel, so nothing is padded.
#include "common.cuh"

namespace {

// Scores of node n, head h over its D slots, masked softmax weights alpha.
__device__ __forceinline__ void gnn_alpha(const float* feat, const float* nbr,
                                          const float* mask, int n, int h,
                                          int N, int F, int D, int dh,
                                          float scale, int lane,
                                          float alpha[8]) {
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
  float denom = 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    alpha[d] = 0.f;
    if (d < D) {
      alpha[d] = expf(sc[d] - m) * mask[(size_t)d * N + n];
      denom += alpha[d];
    }
  }
  denom = fmaxf(denom, 1e-9f);
#pragma unroll
  for (int d = 0; d < 8; ++d) alpha[d] /= denom;
}

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
  float alpha[8];
  gnn_alpha(feat, nbr, mask, n, h, N, F, D, dh, scale, lane, alpha);
  for (int j = lane; j < dh; j += 32) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d)
      if (d < D) acc += alpha[d] * nbr[((size_t)d * N + n) * F + h * dh + j];
    out[(size_t)n * F + h * dh + j] = acc;
  }
}

// Attention backward (the JAX _bwd_kernel's neighbour-plane loop), one warp
// per node and head:
//   dalpha_d = dattn0 . nbr_d,  w = sum_d alpha_d dalpha_d,
//   dscore_d = alpha_d (dalpha_d - w) / sqrt(dh),
//   dfeat = sum_d dscore_d nbr_d,  dnbr_d = alpha_d dattn0 + dscore_d feat.
// Masked slots (alpha 0) and all-masked rows get exactly zero.
__global__ void __launch_bounds__(kThreads)
gnn_attention_bwd_kernel(const float* __restrict__ feat,
                         const float* __restrict__ nbr,
                         const float* __restrict__ mask,
                         const float* __restrict__ dattn0,
                         float* __restrict__ dfeat, float* __restrict__ dnbr,
                         int N, int F, int D, int H, float scale) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= N * H) return;
  const int n = w / H, h = w - n * H;
  const int dh = F / H;
  float alpha[8];
  gnn_alpha(feat, nbr, mask, n, h, N, F, D, dh, scale, lane, alpha);
  const size_t row = (size_t)n * F + h * dh;
  float ds[8], wsum = 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    ds[d] = 0.f;
    if (d < D) {
      const float* nr = nbr + (size_t)d * N * F + row;
      float p = 0.f;
      for (int j = lane; j < dh; j += 32) p += dattn0[row + j] * nr[j];
      ds[d] = warp_sum(p);                   // dalpha_d for now
      wsum += alpha[d] * ds[d];
    }
  }
#pragma unroll
  for (int d = 0; d < 8; ++d) ds[d] = alpha[d] * (ds[d] - wsum) * scale;
  for (int j = lane; j < dh; j += 32) {
    const float da = dattn0[row + j], fj = feat[row + j];
    float df = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      if (d < D) {
        const size_t at = (size_t)d * N * F + row + j;
        df += ds[d] * nbr[at];
        dnbr[at] = alpha[d] * da + ds[d] * fj;
      }
    }
    dfeat[row + j] = df;
  }
}

int attention(const float* feat, const float* nbr, const float* mask,
              float* attn0, int n, int f, int d, int n_heads, float scale,
              cudaStream_t st) {
  if (n > 0)
    gnn_attention_kernel<<<cdiv((long long)n * n_heads, kWarps), kThreads, 0,
                           st>>>(feat, nbr, mask, attn0, n, f, d, n_heads,
                                 scale);
  return (int)cudaGetLastError();
}

// The forward after the attention pass: x1 = (attn0 wr^T + br) * mask1 + hn,
// x1n = LN(x1); then either y = elu(elu(x1n w1^T + c1) w2^T + c2) * mask2
// + x1n (forward: e1 holds the hidden activation), or, for the backward,
// the pre-activations t1 = x1n w1^T + c1 (in e1) and t2 = elu(t1) w2^T + c2
// (in y).
int block_tail(const float* attn0, const float* hn, const float* wr,
               const float* br, const float* g2, const float* b2,
               const float* w1, const float* c1, const float* w2,
               const float* c2, const Drop& m1, const Drop& m2, float* x1,
               float* x1n, float* e1, float* y, int n, int f, int hid,
               bool for_backward, cudaStream_t st) {
  RETURN_IF_ERR(gemm(Mat{attn0, f}, wr, f, br, hn, f, x1, f, n, f, f, false,
                     st, m1));
  RETURN_IF_ERR(layernorm(x1, f, x1n, f, g2, b2, n, f, st));
  RETURN_IF_ERR(gemm(Mat{x1n, f}, w1, f, c1, nullptr, 0, e1, hid, n, hid, f,
                     !for_backward, st));
  if (for_backward)
    return gemm(Elu<Mat>{Mat{e1, hid}}, w2, hid, c2, nullptr, 0, y, f, n, f,
                hid, false, st);
  return gemm(Mat{e1, hid}, w2, hid, c2, x1n, f, y, f, n, f, hid, true,
              st, m2);
}

struct BwdLayout {
  size_t attn0, x1, x1n, t1, t2, dt2, dt1, dx1n, da1, dattn0, mean, rstd,
      wpart, cpart, total;
};

BwdLayout bwd_layout(long long n, long long f, long long hid) {
  BwdLayout l;
  size_t o = 0;
  l.attn0 = o; o += n * f;
  l.x1 = o; o += n * f;
  l.x1n = o; o += n * f;
  l.t1 = o; o += n * hid;
  l.t2 = o; o += n * f;
  l.dt2 = o; o += n * f;
  l.dt1 = o; o += n * hid;
  l.dx1n = o; o += n * f;
  l.da1 = o; o += n * f;
  l.dattn0 = o; o += n * f;
  l.mean = o; o += n;
  l.rstd = o; o += n;
  const long long wide = hid > f ? hid : f;
  l.wpart = o; o += wgrad_scratch(wide, f);
  l.cpart = o; o += colsum_scratch(n, wide);
  l.total = o;
  return l;
}

}  // namespace

extern "C" {

// Floats of scratch the forward needs: attn0, x1, x1n (N x F each) and the
// hidden activation (N x hid).
long long grappa_fused_gnn_scratch(int n, int f, int hid) {
  return 3LL * n * f + (long long)n * hid;
}

// feat, hn, y: (N, F); nbr: (D, N, F); mask: (D, N); weights in torch
// Linear layout (out, in): wr (F, F), w1 (hid, F), w2 (F, hid). Dropout:
// masks keyed by (seed, 0) and (seed, 1) when drop_on, keep iff Philox bits
// >= threshold, kept values x drop_scale.
int grappa_fused_gnn_fwd(const float* feat, const float* nbr, const float* hn,
                         const float* mask, const float* wr, const float* br,
                         const float* g2, const float* b2, const float* w1,
                         const float* c1, const float* w2, const float* c2,
                         uint32_t seed, uint32_t threshold, float drop_scale,
                         int drop_on, float* scratch, float* y, int n, int f,
                         int hid, int d, int n_heads, float scale,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* attn0 = scratch;
  float* x1 = attn0 + (size_t)n * f;
  float* x1n = x1 + (size_t)n * f;
  float* e1 = x1n + (size_t)n * f;
  const Drop m1 = make_drop(seed, 0, threshold, drop_scale, drop_on, f);
  const Drop m2 = make_drop(seed, 1, threshold, drop_scale, drop_on, f);
  RETURN_IF_ERR(attention(feat, nbr, mask, attn0, n, f, d, n_heads, scale,
                          st));
  return block_tail(attn0, hn, wr, br, g2, b2, w1, c1, w2, c2, m1, m2, x1,
                    x1n, e1, y, n, f, hid, false, st);
}

long long grappa_fused_gnn_bwd_scratch(int n, int f, int hid) {
  return (long long)bwd_layout(n, f, hid).total;
}

// Gradients of the forward above for dy (N, F): dfeat, dhn (N, F), dnbr
// (D, N, F) and the eight parameter gradients in the parameters' shapes.
int grappa_fused_gnn_bwd(const float* feat, const float* nbr, const float* hn,
                         const float* mask, const float* wr, const float* br,
                         const float* g2, const float* b2, const float* w1,
                         const float* c1, const float* w2, const float* c2,
                         const float* dy, uint32_t seed, uint32_t threshold,
                         float drop_scale, int drop_on, float* scratch,
                         float* dfeat, float* dnbr, float* dhn, float* dwr,
                         float* dbr, float* dg2, float* db2, float* dw1,
                         float* dc1, float* dw2, float* dc2, int n, int f,
                         int hid, int d, int n_heads, float scale,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const BwdLayout l = bwd_layout(n, f, hid);
  float* s = scratch;
  float *attn0 = s + l.attn0, *x1 = s + l.x1, *x1n = s + l.x1n,
        *t1 = s + l.t1, *t2 = s + l.t2, *dt2 = s + l.dt2, *dt1 = s + l.dt1,
        *dx1n = s + l.dx1n, *da1 = s + l.da1, *dattn0 = s + l.dattn0,
        *mean = s + l.mean, *rstd = s + l.rstd, *wpart = s + l.wpart,
        *cpart = s + l.cpart;
  const Drop m1 = make_drop(seed, 0, threshold, drop_scale, drop_on, f);
  const Drop m2 = make_drop(seed, 1, threshold, drop_scale, drop_on, f);

  // recompute the forward's intermediates
  RETURN_IF_ERR(attention(feat, nbr, mask, attn0, n, f, d, n_heads, scale,
                          st));
  RETURN_IF_ERR(block_tail(attn0, hn, wr, br, g2, b2, w1, c1, w2, c2, m1, m2,
                           x1, x1n, t1, t2, n, f, hid, true, st));

  // y = elu(t2) * mask2 + x1n
  RETURN_IF_ERR(mask_grad(dy, m2, t2, dt2, n, f, st));
  // t2 = elu(t1) w2^T + c2
  RETURN_IF_ERR(gemm_wgrad(tr(Mat{dt2, f}), tr(Elu<Mat>{Mat{t1, hid}}), dw2,
                           f, hid, n, wpart, st));
  RETURN_IF_ERR(colsum(Mat{dt2, f}, dc2, n, f, cpart, st));
  Out o = out_to(dt1, hid);
  o.gate = t1;
  o.ldg = hid;
  RETURN_IF_ERR(gemm(Mat{dt2, f}, tr(Mat{w2, hid}), o, n, hid, f, st));
  // t1 = x1n w1^T + c1
  RETURN_IF_ERR(gemm_wgrad(tr(Mat{dt1, hid}), tr(Mat{x1n, f}), dw1, hid, f,
                           n, wpart, st));
  RETURN_IF_ERR(colsum(Mat{dt1, hid}, dc1, n, hid, cpart, st));
  o = out_to(dx1n, f);
  o.R = dy;
  o.ldr = f;
  RETURN_IF_ERR(gemm(Mat{dt1, hid}, tr(Mat{w1, f}), o, n, f, hid, st));
  // x1n = LN(x1); x1 = a1 * mask1 + hn, so dhn = dx1
  RETURN_IF_ERR(layernorm_bwd(dx1n, Mat{x1, f}, g2, dhn, dg2, db2, n, f, mean,
                              rstd, cpart, st));
  const float* da = dhn;
  if (drop_on) {
    RETURN_IF_ERR(mask_grad(dhn, m1, nullptr, da1, n, f, st));
    da = da1;
  }
  // a1 = attn0 wr^T + br
  RETURN_IF_ERR(gemm_wgrad(tr(Mat{da, f}), tr(Mat{attn0, f}), dwr, f, f, n,
                           wpart, st));
  RETURN_IF_ERR(colsum(Mat{da, f}, dbr, n, f, cpart, st));
  RETURN_IF_ERR(gemm(Mat{da, f}, tr(Mat{wr, f}), out_to(dattn0, f), n, f, f,
                     st));
  if (n > 0)
    gnn_attention_bwd_kernel<<<cdiv((long long)n * n_heads, kWarps), kThreads,
                               0, st>>>(feat, nbr, mask, dattn0, dfeat, dnbr,
                                        n, f, d, n_heads, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
