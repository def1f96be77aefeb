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
// and output with D=8 slots: bound by operations. The backward's work is
// two products per forward product (dX = dY W and dW = dY^T X), 9.4 MFLOP
// a row. At the 128-molecule training batch (N=3376 padded rows): 15.9
// GFLOP forward and 31.9 GFLOP backward; as 3xTF32 (three TF32 products
// per float32 product) at the 495 TFLOP/s tensor-core peak, 0.097 and 0.19
// ms (0.24 and 0.48 ms at the 67 TFLOP/s fp32 peak outside them).
//
// In bf16 mode (the JAX kernel's mm_dtype=bfloat16) the three forward
// products' 4.7 MFLOP a row take 4.8 ns at the 989 TFLOP/s bf16 peak, and
// the (3 + D) F float32 values a row read and written (feat, nbr, hn, y)
// 6.7 ns at D = 8: bound by bytes. So is the backward's: its 9.4 MFLOP a
// row take 9.5 ns, its (4 + 2D) F float32 values a row (feat, nbr, dy and
// dfeat, dnbr, dhn) 12.2 ns.
//
// Design: chains of launches on the caller's stream, every product on the
// tensor cores through tc_gemm.cuh (3xTF32 mma.sync fed by a cp.async
// ring, or its bf16 policy in bf16 mode; its note gives the design). Forward -- the attention pass (one warp
// per node and head, the D slot scores reduced across the warp's lanes),
// the head_reducer GEMM with dropout and the + hn residual in its epilogue,
// LayerNorm, the two FF GEMMs (elu; then elu, dropout and the + x1n
// residual, whose epilogue also stores the activation e2 before dropout).
// Each epilogue keys its dropout mask by the element's flat index, so the
// masks do not depend on the GEMM's tiling. The forward's scratch keeps
// attn0, x1, x1n, e1 = elu(t1) and e2 = elu(t2), N x (4F + hid) floats, and
// the backward reads them instead of recomputing the forward. Backward --
// the masks regenerated from the seed (no mask is stored) with elu' formed
// from the stored activation (1 where a > 0, else a + 1) in one elementwise
// pass or in a GEMM's epilogue, dX = dY W GEMMs with the residual or elu' in
// their epilogue, split-K dW = dY^T X GEMMs whose fixed slices are summed in
// slice order (no atomics: two runs give the same bits), column sums, the
// LayerNorm backward (re-deriving the row statistics from x1 in its row
// pass) and the attention backward (one warp per node and head). The ragged
// node edge is masked in every kernel, so nothing is padded.
#include "tc_gemm.cuh"

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

// y = elu(v + c2) * mask2 + x1n for the last FF GEMM's sums v, storing the
// activation e2 = elu(v + c2) (before dropout) for the backward as well.
struct TailOut {
  const float* bias;
  Drop drop;
  const float* R;
  float* E;
  float* C;
  int ld;
  __device__ __forceinline__ void operator()(int, int m, int n,
                                             float v) const {
    const size_t at = (size_t)m * ld + n;
    v = elu(v + bias[n]);
    E[at] = v;
    if (drop.on) v *= drop(m, n);
    C[at] = v + R[at];
  }
};

// The forward's intermediates, which the backward reads: attn0, x1 =
// (attn0 wr^T + br) * mask1 + hn, x1n = LN(x1), e1 = elu(x1n w1^T + c1)
// and e2 = elu(e1 w2^T + c2).
struct FwdLayout {
  size_t attn0, x1, x1n, e1, e2, total;
};

FwdLayout fwd_layout(long long n, long long f, long long hid) {
  FwdLayout l;
  size_t o = 0;
  l.attn0 = carve(o, n * f);
  l.x1 = carve(o, n * f);
  l.x1n = carve(o, n * f);
  l.e1 = carve(o, n * hid);
  l.e2 = carve(o, n * f);
  l.total = o;
  return l;
}

struct BwdLayout {
  size_t dt2, dt1, dx1n, da1, dattn0, mean, rstd, wpart, cpart, total;
};

BwdLayout bwd_layout(long long n, long long f, long long hid) {
  BwdLayout l;
  size_t o = 0;
  l.dt2 = carve(o, n * f);
  l.dt1 = carve(o, n * hid);
  l.dx1n = carve(o, n * f);
  l.da1 = carve(o, n * f);
  l.dattn0 = carve(o, n * f);
  l.mean = carve(o, n);
  l.rstd = carve(o, n);
  const long long wide = hid > f ? hid : f;
  l.wpart = carve(o, wgrad_scratch(wide, f));
  l.cpart = carve(o, colsum_scratch(n, wide));
  l.total = o;
  return l;
}

}  // namespace

extern "C" {

// Floats of the forward's scratch: its intermediates (FwdLayout), N x (4F +
// hid). The backward reads them: keep the scratch until it has run.
long long grappa_fused_gnn_scratch(int n, int f, int hid) {
  return (long long)fwd_layout(n, f, hid).total;
}

// feat, hn, y: (N, F); nbr: (D, N, F); mask: (D, N); weights in torch
// Linear layout (out, in): wr (F, F), w1 (hid, F), w2 (F, hid). Dropout:
// masks keyed by (seed, 0) and (seed, 1) when drop_on, keep iff Philox bits
// >= threshold, kept values x drop_scale. mm_bf16: the three products in
// tc_gemm.cuh's bf16 policy (operands rounded to bf16, float32 sums), the
// JAX kernel's mm_dtype=bfloat16; the scores and the message sum stay
// float32, as there.
int grappa_fused_gnn_fwd(const float* feat, const float* nbr, const float* hn,
                         const float* mask, const float* wr, const float* br,
                         const float* g2, const float* b2, const float* w1,
                         const float* c1, const float* w2, const float* c2,
                         uint32_t seed, uint32_t threshold, float drop_scale,
                         int drop_on, float* scratch, float* y, int n, int f,
                         int hid, int d, int n_heads, float scale,
                         int mm_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const FwdLayout l = fwd_layout(n, f, hid);
  float *attn0 = scratch + l.attn0, *x1 = scratch + l.x1,
        *x1n = scratch + l.x1n, *e1 = scratch + l.e1, *e2 = scratch + l.e2;
  const Drop m1 = make_drop(seed, 0, threshold, drop_scale, drop_on, f);
  const Drop m2 = make_drop(seed, 1, threshold, drop_scale, drop_on, f);
  auto run = [&](auto policy) {
    using P = decltype(policy);
    RETURN_IF_ERR(attention(feat, nbr, mask, attn0, n, f, d, n_heads, scale,
                            st));
    RETURN_IF_ERR(tc_gemm<P>(Mat{attn0, f}, wr, f, br, hn, f, x1, f, n, f, f,
                             false, st, m1));
    RETURN_IF_ERR(layernorm(x1, f, x1n, f, g2, b2, n, f, st));
    RETURN_IF_ERR(tc_gemm<P>(Mat{x1n, f}, w1, f, c1, nullptr, 0, e1, hid, n,
                             hid, f, true, st));
    return tc_gemm<P>(Mat{e1, hid}, Mat{w2, hid},
                      TailOut{c2, m2, x1n, e2, y, f}, n, f, hid, st);
  };
  return mm_bf16 ? run(TcBf16{}) : run(TcTf32x3{});
}

long long grappa_fused_gnn_bwd_scratch(int n, int f, int hid) {
  return (long long)bwd_layout(n, f, hid).total;
}

// Gradients of the forward above for dy (N, F): dfeat, dhn (N, F), dnbr
// (D, N, F) and the eight parameter gradients in the parameters' shapes.
// `fwd` is the forward's scratch from the same inputs, read only; hn and
// the biases are not read (the intermediates hold their effect). mm_bf16:
// the six products in tc_gemm.cuh's bf16 policy, both operands rounded to
// bf16 (dy's descendants too), float32 sums, as the JAX kernel's
// _dot_tn / _dot_nt with mm_dtype=bfloat16; the column sums, the
// LayerNorm backward and the attention backward stay float32, as there.
int grappa_fused_gnn_bwd(const float* feat, const float* nbr,
                         const float* mask, const float* wr, const float* g2,
                         const float* w1, const float* w2, const float* dy,
                         uint32_t seed, uint32_t threshold, float drop_scale,
                         int drop_on, const float* fwd, float* scratch,
                         float* dfeat, float* dnbr, float* dhn, float* dwr,
                         float* dbr, float* dg2, float* db2, float* dw1,
                         float* dc1, float* dw2, float* dc2, int n, int f,
                         int hid, int d, int n_heads, float scale,
                         int mm_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const FwdLayout lf = fwd_layout(n, f, hid);
  const float *attn0 = fwd + lf.attn0, *x1 = fwd + lf.x1,
              *x1n = fwd + lf.x1n, *e1 = fwd + lf.e1, *e2 = fwd + lf.e2;
  const BwdLayout l = bwd_layout(n, f, hid);
  float* s = scratch;
  float *dt2 = s + l.dt2, *dt1 = s + l.dt1, *dx1n = s + l.dx1n,
        *da1 = s + l.da1, *dattn0 = s + l.dattn0, *mean = s + l.mean,
        *rstd = s + l.rstd, *wpart = s + l.wpart, *cpart = s + l.cpart;
  const Drop m1 = make_drop(seed, 0, threshold, drop_scale, drop_on, f);
  const Drop m2 = make_drop(seed, 1, threshold, drop_scale, drop_on, f);

  auto run = [&](auto policy) {
    using P = decltype(policy);
    // y = e2 * mask2 + x1n, e2 = elu(t2), t2 = e1 w2^T + c2
    RETURN_IF_ERR(mask_grad(dy, m2, e2, dt2, n, f, st));
    RETURN_IF_ERR(tc_gemm_wgrad<P>(tr(Mat{dt2, f}), tr(Mat{e1, hid}), dw2, f,
                                   hid, n, wpart, st));
    RETURN_IF_ERR(colsum(Mat{dt2, f}, dc2, n, f, cpart, st));
    RETURN_IF_ERR(tc_gemm<P>(Mat{dt2, f}, tr(Mat{w2, hid}),
                             EluGradOut{dt1, hid, e1, hid}, n, hid, f, st));
    // e1 = elu(t1), t1 = x1n w1^T + c1; x1n also feeds the residual
    RETURN_IF_ERR(tc_gemm_wgrad<P>(tr(Mat{dt1, hid}), tr(Mat{x1n, f}), dw1,
                                   hid, f, n, wpart, st));
    RETURN_IF_ERR(colsum(Mat{dt1, hid}, dc1, n, hid, cpart, st));
    Out o = out_to(dx1n, f);
    o.R = dy;
    o.ldr = f;
    RETURN_IF_ERR(tc_gemm<P>(Mat{dt1, hid}, tr(Mat{w1, f}), o, n, f, hid,
                             st));
    // x1n = LN(x1); x1 = a1 * mask1 + hn, so dhn = dx1
    RETURN_IF_ERR(layernorm_bwd(dx1n, Mat{x1, f}, g2, dhn, dg2, db2, n, f,
                                mean, rstd, cpart, st));
    const float* da = dhn;
    if (drop_on) {
      RETURN_IF_ERR(mask_grad(dhn, m1, nullptr, da1, n, f, st));
      da = da1;
    }
    // a1 = attn0 wr^T + br
    RETURN_IF_ERR(tc_gemm_wgrad<P>(tr(Mat{da, f}), tr(Mat{attn0, f}), dwr, f,
                                   f, n, wpart, st));
    RETURN_IF_ERR(colsum(Mat{da, f}, dbr, n, f, cpart, st));
    return tc_gemm<P>(Mat{da, f}, tr(Mat{wr, f}), out_to(dattn0, f), n, f, f,
                      st);
  };
  RETURN_IF_ERR(mm_bf16 ? run(TcBf16{}) : run(TcTf32x3{}));
  if (n > 0)
    gnn_attention_bwd_kernel<<<cdiv((long long)n * n_heads, kWarps), kThreads,
                               0, st>>>(feat, nbr, mask, dattn0, dfeat, dnbr,
                                        n, f, d, n_heads, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
