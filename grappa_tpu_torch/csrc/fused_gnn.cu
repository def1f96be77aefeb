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
// tensor cores: through tc_gemm.cuh in float32 (3xTF32 mma.sync fed by a
// cp.async ring) and through wg_gemm.cuh in bf16 mode (wgmma fed by TMA;
// their notes give the designs). Forward -- the attention pass (one warp
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
//
// bf16 mode: wg_gemm.cuh reads bf16 operands, so each is rounded once where
// it is made (to nearest even, as the products of the float32 values would
// round them) and stored beside, or instead of, its float32 value, in rows
// padded to a multiple of 8 elements (bf16_passes.cuh). Forward, five
// launches as in float32: the first casts the three weights (kept in the
// forward's scratch for the backward) in some of its blocks and runs the
// attention pass in the others, which writes attn0 in bf16 alone (only
// products read it); the LayerNorm writes x1n in both types, FF1's
// epilogue e1 in both. Backward: one pass writes dt2 = dy x mask2 x elu' in
// both types, the elu' epilogue dt1 in both and a cast pass da (dx1 x
// mask1) in bf16 (and in float32 with dropout on). The scores, the softmax,
// the message sum, the column sums, the LayerNorm backward and the
// attention backward stay float32, as in the JAX kernel. The two attention
// passes keep each slot's head row in registers (one read of nbr, all of a
// warp's loads in flight at once; the float32 passes read it two and three
// times): nbr, D F floats a row, is most of K1's and K1b's bytes, and with
// the products on wgmma the passes take a third of K1 and K1b.
#include "bf16_passes.cuh"

#include <type_traits>

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

// bf16 mode's slot rows of node n, head h: lane l holds elements l, l +
// 32, ... (J of them, dh <= 32 J) of feat's head row in fv, of each slot's
// in v (zero past dh and in slots d >= D), and the slots' mask values. Every
// load is issued before the first is used.
template <int J>
__device__ __forceinline__ void gnn_rows(const float* feat, const float* nbr,
                                         const float* mask, int n, int h,
                                         int N, int F, int D, int dh,
                                         int lane, float fv[J],
                                         float v[8][J], float msk[8]) {
  const float* fr = feat + (size_t)n * F + h * dh;
#pragma unroll
  for (int j = 0; j < J; ++j)
    fv[j] = lane + 32 * j < dh ? fr[lane + 32 * j] : 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    msk[d] = d < D ? mask[(size_t)d * N + n] : 0.f;
    const float* nr = nbr + ((size_t)d * N + n) * F + h * dh;
#pragma unroll
    for (int j = 0; j < J; ++j)
      v[d][j] = d < D && lane + 32 * j < dh ? nr[lane + 32 * j] : 0.f;
  }
}

// gnn_alpha's scores and masked softmax weights from the rows in registers,
// in its float32 order (each lane's terms by ascending element, then the
// warp's sum).
template <int J>
__device__ __forceinline__ void gnn_alpha_r(const float fv[J],
                                            const float v[8][J],
                                            const float msk[8], int D,
                                            float scale, float alpha[8]) {
  float sc[8], m = -1e30f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    sc[d] = -1e30f;
    if (d < D) {
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) p += fv[j] * v[d][j];
      p = warp_sum(p);
      sc[d] = msk[d] > 0.f ? p * scale : -1e30f;
      m = fmaxf(m, sc[d]);
    }
  }
  float denom = 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    alpha[d] = 0.f;
    if (d < D) {
      alpha[d] = expf(sc[d] - m) * msk[d];
      denom += alpha[d];
    }
  }
  denom = fmaxf(denom, 1e-9f);
#pragma unroll
  for (int d = 0; d < 8; ++d) alpha[d] /= denom;
}

// bf16 mode's first launch. Blocks below att_blocks run the attention pass
// (one warp a node and head): gnn_attention_kernel's scores, softmax and
// message sum in its float32 order, each slot's head row read once and kept
// in registers from its score to the sum (J > 0; J = 0 reads the rows as
// gnn_attention_kernel does, for dh > 128), attn0 stored in bf16 alone
// (rows ldh apart). The other blocks cast the weights to bf16 (one element
// a thread, the jobs one after another), so the forward's products start
// after one launch, not two.
template <int J>
__global__ void __launch_bounds__(kThreads)
gnn_attention_h_kernel(const float* __restrict__ feat,
                       const float* __restrict__ nbr,
                       const float* __restrict__ mask, bf16* __restrict__ out,
                       int ldh, int N, int F, int D, int H, float scale,
                       int att_blocks, const __grid_constant__ ToBf16Jobs w,
                       int n_w) {
  if ((int)blockIdx.x >= att_blocks) {
    long long i = (long long)(blockIdx.x - att_blocks) * kThreads +
                  threadIdx.x;
    for (int k = 0; k < n_w; ++k) {
      const ToBf16& c = w.job[k];
      const long long e = (long long)c.rows * c.cols;
      if (i < e) {
        const long long m = i / c.cols;
        c.yh[m * c.ldh + (i - m * c.cols)] = __float2bfloat16_rn(c.x[i]);
        return;
      }
      i -= e;
    }
    return;
  }
  const int wi = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (wi >= N * H) return;
  const int n = wi / H, h = wi - n * H;
  const int dh = F / H;
  float alpha[8];
  bf16* o = out + (size_t)n * ldh + h * dh;
  if constexpr (J > 0) {
    float fv[J], v[8][J], msk[8];
    gnn_rows<J>(feat, nbr, mask, n, h, N, F, D, dh, lane, fv, v, msk);
    gnn_alpha_r<J>(fv, v, msk, D, scale, alpha);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (lane + 32 * j >= dh) break;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < 8; ++d)
        if (d < D) acc += alpha[d] * v[d][j];
      o[lane + 32 * j] = __float2bfloat16_rn(acc);
    }
  } else {
    gnn_alpha(feat, nbr, mask, n, h, N, F, D, dh, scale, lane, alpha);
    for (int j = lane; j < dh; j += 32) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < 8; ++d)
        if (d < D)
          acc += alpha[d] * nbr[((size_t)d * N + n) * F + h * dh + j];
      o[j] = __float2bfloat16_rn(acc);
    }
  }
}

// run(std::integral_constant<int, J>) with the J that keeps a head's rows
// in registers (dh <= 32 J), or wider() for dh > 128.
template <class Run, class Wider>
void by_head_width(int dh, Run run, Wider wider) {
  if (dh <= 32)
    run(std::integral_constant<int, 1>{});
  else if (dh <= 64)
    run(std::integral_constant<int, 2>{});
  else if (dh <= 128)
    run(std::integral_constant<int, 4>{});
  else
    wider();
}

// The attention pass into attn0 (bf16, rows ldh apart) and the n_w weight
// casts, in one launch.
int attention_h(const float* feat, const float* nbr, const float* mask,
                bf16* attn0, int ldh, int n, int f, int d, int n_heads,
                float scale, const ToBf16* weights, int n_w,
                cudaStream_t st) {
  ToBf16Jobs w{};
  long long elems = 0;
  for (int k = 0; k < n_w; ++k) {
    w.job[k] = weights[k];
    elems += (long long)weights[k].rows * weights[k].cols;
  }
  const int att_blocks = cdiv((long long)n * n_heads, kWarps);
  const int blocks = att_blocks + cdiv(elems, kThreads);
  auto launch = [&](auto j) {
    gnn_attention_h_kernel<decltype(j)::value><<<blocks, kThreads, 0, st>>>(
        feat, nbr, mask, attn0, ldh, n, f, d, n_heads, scale, att_blocks, w,
        n_w);
  };
  if (blocks > 0)
    by_head_width(f / n_heads, launch,
                  [&] { launch(std::integral_constant<int, 0>{}); });
  return (int)cudaGetLastError();
}

// bf16 mode's attention backward: gnn_attention_bwd_kernel's arithmetic in
// its float32 order, each slot's head row read once (gnn_rows) and kept in
// registers through the scores, dalpha, dfeat and dnbr (the float32 kernel
// reads it three times). dh > 128 takes gnn_attention_bwd_kernel itself.
template <int J>
__global__ void __launch_bounds__(kThreads)
gnn_attention_bwd_r_kernel(const float* __restrict__ feat,
                           const float* __restrict__ nbr,
                           const float* __restrict__ mask,
                           const float* __restrict__ dattn0,
                           float* __restrict__ dfeat,
                           float* __restrict__ dnbr, int N, int F, int D,
                           int H, float scale) {
  const int wi = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (wi >= N * H) return;
  const int n = wi / H, h = wi - n * H;
  const int dh = F / H;
  const size_t row = (size_t)n * F + h * dh;
  float fv[J], v[8][J], msk[8], da[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    da[j] = lane + 32 * j < dh ? dattn0[row + lane + 32 * j] : 0.f;
  gnn_rows<J>(feat, nbr, mask, n, h, N, F, D, dh, lane, fv, v, msk);
  float alpha[8];
  gnn_alpha_r<J>(fv, v, msk, D, scale, alpha);
  float ds[8], wsum = 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    ds[d] = 0.f;
    if (d < D) {
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) p += da[j] * v[d][j];
      ds[d] = warp_sum(p);                   // dalpha_d for now
      wsum += alpha[d] * ds[d];
    }
  }
#pragma unroll
  for (int d = 0; d < 8; ++d) ds[d] = alpha[d] * (ds[d] - wsum) * scale;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (lane + 32 * j >= dh) break;
    float df = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      if (d < D) {
        df += ds[d] * v[d][j];
        dnbr[(size_t)d * N * F + row + lane + 32 * j] =
            alpha[d] * da[j] + ds[d] * fv[j];
      }
    }
    dfeat[row + lane + 32 * j] = df;
  }
}

// dt2 = dy x mask2 x elu'(e2) (mask_grad_kernel's arithmetic) in float32
// and, rounded, in bf16 rows ldh apart.
__global__ void __launch_bounds__(kThreads)
mask_grad_h_kernel(const float* __restrict__ x, Drop drop,
                   const float* __restrict__ act, float* __restrict__ y,
                   bf16* __restrict__ yh, int ldh, int cols,
                   long long total) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  float v = x[i];
  if (drop.on) v *= drop.at((unsigned long long)i);
  v *= elu_grad_of(act[i]);
  y[i] = v;
  const long long m = i / cols;
  yh[m * ldh + (i - m * cols)] = __float2bfloat16_rn(v);
}

int mask_grad_h(const float* x, const Drop& drop, const float* act, float* y,
                bf16* yh, int ldh, int M, int N, cudaStream_t st) {
  const long long total = (long long)M * N;
  if (total > 0)
    mask_grad_h_kernel<<<cdiv(total, kThreads), kThreads, 0, st>>>(
        x, drop, act, y, yh, ldh, N, total);
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
// and e2 = elu(e1 w2^T + c2). In bf16 mode attn0 in bf16 alone, and the
// bf16 copies of x1n, e1 and the three weights.
struct FwdLayout {
  size_t attn0, x1, x1n, e1, e2, total;
  size_t attn0_h, x1n_h, e1_h, wr_h, w1_h, w2_h;
};

FwdLayout fwd_layout(long long n, long long f, long long hid, bool h) {
  FwdLayout l{};
  size_t o = 0;
  if (!h) l.attn0 = carve(o, n * f);
  l.x1 = carve(o, n * f);
  l.x1n = carve(o, n * f);
  l.e1 = carve(o, n * hid);
  l.e2 = carve(o, n * f);
  if (h) {
    const long long fh = pad8(f), hh = pad8(hid);
    l.attn0_h = carve(o, h_floats(n * fh));
    l.x1n_h = carve(o, h_floats(n * fh));
    l.e1_h = carve(o, h_floats(n * hh));
    l.wr_h = carve(o, h_floats(f * fh));
    l.w1_h = carve(o, h_floats(hid * fh));
    l.w2_h = carve(o, h_floats(f * hh));
  }
  l.total = o;
  return l;
}

// In bf16 mode also the bf16 copies of dt2, dt1 and da (dx1 x mask1).
struct BwdLayout {
  size_t dt2, dt1, dx1n, da1, dattn0, mean, rstd, wpart, cpart, total;
  size_t dt2_h, dt1_h, da_h;
};

BwdLayout bwd_layout(long long n, long long f, long long hid, bool h) {
  BwdLayout l{};
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
  if (h) {
    l.dt2_h = carve(o, h_floats(n * pad8(f)));
    l.dt1_h = carve(o, h_floats(n * pad8(hid)));
    l.da_h = carve(o, h_floats(n * pad8(f)));
  }
  l.total = o;
  return l;
}

// The forward in float32: every product on tc_gemm.cuh.
int gnn_fwd_f32(const float* feat, const float* nbr, const float* hn,
                const float* mask, const float* wr, const float* br,
                const float* g2, const float* b2, const float* w1,
                const float* c1, const float* w2, const float* c2,
                const Drop& m1, const Drop& m2, float* scratch, float* y,
                int n, int f, int hid, int d, int n_heads, float scale,
                cudaStream_t st) {
  const FwdLayout l = fwd_layout(n, f, hid, false);
  float *attn0 = scratch + l.attn0, *x1 = scratch + l.x1,
        *x1n = scratch + l.x1n, *e1 = scratch + l.e1, *e2 = scratch + l.e2;
  RETURN_IF_ERR(attention(feat, nbr, mask, attn0, n, f, d, n_heads, scale,
                          st));
  RETURN_IF_ERR(tc_gemm(Mat{attn0, f}, wr, f, br, hn, f, x1, f, n, f, f,
                        false, st, m1));
  RETURN_IF_ERR(layernorm(x1, f, x1n, f, g2, b2, n, f, st));
  RETURN_IF_ERR(tc_gemm(Mat{x1n, f}, w1, f, c1, nullptr, 0, e1, hid, n, hid,
                        f, true, st));
  return tc_gemm(Mat{e1, hid}, Mat{w2, hid}, TailOut{c2, m2, x1n, e2, y, f},
                 n, f, hid, st);
}

// The forward in bf16 mode: every product on wg_gemm.cuh.
int gnn_fwd_bf16(const float* feat, const float* nbr, const float* hn,
                 const float* mask, const float* wr, const float* br,
                 const float* g2, const float* b2, const float* w1,
                 const float* c1, const float* w2, const float* c2,
                 const Drop& m1, const Drop& m2, float* scratch, float* y,
                 int n, int f, int hid, int d, int n_heads, float scale,
                 cudaStream_t st) {
  const int fh = pad8(f), hh = pad8(hid);
  const FwdLayout l = fwd_layout(n, f, hid, true);
  float *x1 = scratch + l.x1, *x1n = scratch + l.x1n, *e1 = scratch + l.e1,
        *e2 = scratch + l.e2;
  bf16 *attn0_h = as_h(scratch, l.attn0_h), *x1n_h = as_h(scratch, l.x1n_h),
       *e1_h = as_h(scratch, l.e1_h), *wr_h = as_h(scratch, l.wr_h),
       *w1_h = as_h(scratch, l.w1_h), *w2_h = as_h(scratch, l.w2_h);
  const ToBf16 weights[3] = {cast_of(wr, wr_h, f, f, fh),
                             cast_of(w1, w1_h, hid, f, fh),
                             cast_of(w2, w2_h, f, hid, hh)};
  RETURN_IF_ERR(attention_h(feat, nbr, mask, attn0_h, fh, n, f, d, n_heads,
                            scale, weights, 3, st));
  // x1 = (attn0 wr^T + br) * mask1 + hn
  Out o = out_to(x1, f);
  o.bias = br;
  o.drop = m1;
  o.R = hn;
  o.ldr = f;
  RETURN_IF_ERR(wg_gemm(MatH{attn0_h, fh}, MatH{wr_h, fh}, o, n, f, f, st));
  RETURN_IF_ERR(layernorm_h(x1, x1n, x1n_h, fh, g2, b2, n, f, st));
  RETURN_IF_ERR(wg_gemm(MatH{x1n_h, fh}, MatH{w1_h, fh},
                        EluOutH{c1, e1, hid, e1_h, hh}, n, hid, f, st));
  return wg_gemm(MatH{e1_h, hh}, MatH{w2_h, hh},
                 TailOut{c2, m2, x1n, e2, y, f}, n, f, hid, st);
}

// The backward's products in float32 (tc_gemm.cuh), up to dattn0.
int gnn_bwd_f32(const float* wr, const float* g2, const float* w1,
                const float* w2, const float* dy, const Drop& m1,
                const Drop& m2, const float* fwd, float* s, float* dhn,
                float* dwr, float* dbr, float* dg2, float* db2, float* dw1,
                float* dc1, float* dw2, float* dc2, int n, int f, int hid,
                cudaStream_t st) {
  const FwdLayout lf = fwd_layout(n, f, hid, false);
  const float *attn0 = fwd + lf.attn0, *x1 = fwd + lf.x1,
              *x1n = fwd + lf.x1n, *e1 = fwd + lf.e1, *e2 = fwd + lf.e2;
  const BwdLayout l = bwd_layout(n, f, hid, false);
  float *dt2 = s + l.dt2, *dt1 = s + l.dt1, *dx1n = s + l.dx1n,
        *da1 = s + l.da1, *dattn0 = s + l.dattn0, *mean = s + l.mean,
        *rstd = s + l.rstd, *wpart = s + l.wpart, *cpart = s + l.cpart;
  // y = e2 * mask2 + x1n, e2 = elu(t2), t2 = e1 w2^T + c2
  RETURN_IF_ERR(mask_grad(dy, m2, e2, dt2, n, f, st));
  RETURN_IF_ERR(tc_gemm_wgrad(tr(Mat{dt2, f}), tr(Mat{e1, hid}), dw2, f, hid,
                              n, wpart, st));
  RETURN_IF_ERR(colsum(Mat{dt2, f}, dc2, n, f, cpart, st));
  RETURN_IF_ERR(tc_gemm(Mat{dt2, f}, tr(Mat{w2, hid}),
                        EluGradOut{dt1, hid, e1, hid}, n, hid, f, st));
  // e1 = elu(t1), t1 = x1n w1^T + c1; x1n also feeds the residual
  RETURN_IF_ERR(tc_gemm_wgrad(tr(Mat{dt1, hid}), tr(Mat{x1n, f}), dw1, hid,
                              f, n, wpart, st));
  RETURN_IF_ERR(colsum(Mat{dt1, hid}, dc1, n, hid, cpart, st));
  Out o = out_to(dx1n, f);
  o.R = dy;
  o.ldr = f;
  RETURN_IF_ERR(tc_gemm(Mat{dt1, hid}, tr(Mat{w1, f}), o, n, f, hid, st));
  // x1n = LN(x1); x1 = a1 * mask1 + hn, so dhn = dx1
  RETURN_IF_ERR(layernorm_bwd(dx1n, Mat{x1, f}, g2, dhn, dg2, db2, n, f,
                              mean, rstd, cpart, st));
  const float* da = dhn;
  if (m1.on) {
    RETURN_IF_ERR(mask_grad(dhn, m1, nullptr, da1, n, f, st));
    da = da1;
  }
  // a1 = attn0 wr^T + br
  RETURN_IF_ERR(tc_gemm_wgrad(tr(Mat{da, f}), tr(Mat{attn0, f}), dwr, f, f,
                              n, wpart, st));
  RETURN_IF_ERR(colsum(Mat{da, f}, dbr, n, f, cpart, st));
  return tc_gemm(Mat{da, f}, tr(Mat{wr, f}), out_to(dattn0, f), n, f, f, st);
}

// The backward's products in bf16 mode (wg_gemm.cuh), up to dattn0: the
// weights' bf16 copies are the forward's.
int gnn_bwd_bf16(const float* g2, const float* dy, const Drop& m1,
                 const Drop& m2, const float* fwd, float* s, float* dhn,
                 float* dwr, float* dbr, float* dg2, float* db2, float* dw1,
                 float* dc1, float* dw2, float* dc2, int n, int f, int hid,
                 cudaStream_t st) {
  const int fh = pad8(f), hh = pad8(hid);
  const FwdLayout lf = fwd_layout(n, f, hid, true);
  const float *x1 = fwd + lf.x1, *e1 = fwd + lf.e1, *e2 = fwd + lf.e2;
  const bf16 *attn0_h = as_h(fwd, lf.attn0_h), *x1n_h = as_h(fwd, lf.x1n_h),
             *e1_h = as_h(fwd, lf.e1_h), *wr_h = as_h(fwd, lf.wr_h),
             *w1_h = as_h(fwd, lf.w1_h), *w2_h = as_h(fwd, lf.w2_h);
  const BwdLayout l = bwd_layout(n, f, hid, true);
  float *dt2 = s + l.dt2, *dt1 = s + l.dt1, *dx1n = s + l.dx1n,
        *da1 = s + l.da1, *dattn0 = s + l.dattn0, *mean = s + l.mean,
        *rstd = s + l.rstd, *wpart = s + l.wpart, *cpart = s + l.cpart;
  bf16 *dt2_h = as_h(s, l.dt2_h), *dt1_h = as_h(s, l.dt1_h),
       *da_h = as_h(s, l.da_h);
  // y = e2 * mask2 + x1n, e2 = elu(t2), t2 = e1 w2^T + c2
  RETURN_IF_ERR(mask_grad_h(dy, m2, e2, dt2, dt2_h, fh, n, f, st));
  RETURN_IF_ERR(wg_gemm_wgrad(tr(MatH{dt2_h, fh}), tr(MatH{e1_h, hh}), dw2, f,
                              hid, n, wpart, st));
  RETURN_IF_ERR(colsum(Mat{dt2, f}, dc2, n, f, cpart, st));
  RETURN_IF_ERR(wg_gemm(MatH{dt2_h, fh}, tr(MatH{w2_h, hh}),
                        EluGradOutH{dt1, hid, e1, hid, dt1_h, hh}, n, hid, f,
                        st));
  // e1 = elu(t1), t1 = x1n w1^T + c1; x1n also feeds the residual
  RETURN_IF_ERR(wg_gemm_wgrad(tr(MatH{dt1_h, hh}), tr(MatH{x1n_h, fh}), dw1,
                              hid, f, n, wpart, st));
  RETURN_IF_ERR(colsum(Mat{dt1, hid}, dc1, n, hid, cpart, st));
  Out o = out_to(dx1n, f);
  o.R = dy;
  o.ldr = f;
  RETURN_IF_ERR(wg_gemm(MatH{dt1_h, hh}, tr(MatH{w1_h, fh}), o, n, f, hid,
                        st));
  // x1n = LN(x1); x1 = a1 * mask1 + hn, so dhn = dx1
  RETURN_IF_ERR(layernorm_bwd(dx1n, Mat{x1, f}, g2, dhn, dg2, db2, n, f,
                              mean, rstd, cpart, st));
  const float* da = m1.on ? da1 : dhn;
  const ToBf16 da_cast =
      cast_of(dhn, da_h, n, f, fh, m1, m1.on ? da1 : nullptr);
  RETURN_IF_ERR(to_bf16(&da_cast, 1, st));
  // a1 = attn0 wr^T + br
  RETURN_IF_ERR(wg_gemm_wgrad(tr(MatH{da_h, fh}), tr(MatH{attn0_h, fh}), dwr,
                              f, f, n, wpart, st));
  RETURN_IF_ERR(colsum(Mat{da, f}, dbr, n, f, cpart, st));
  return wg_gemm(MatH{da_h, fh}, tr(MatH{wr_h, fh}), out_to(dattn0, f), n, f,
                 f, st);
}

}  // namespace

extern "C" {

#ifndef GRAPPA_SHARDED_DROP
// Floats of the forward's scratch: its intermediates (FwdLayout), N x (4F +
// hid); in bf16 mode N x (3F + hid) and the bf16 copies, N x (2F + hid) / 2
// and the weights. The backward reads them: keep the scratch until it has
// run.
long long grappa_fused_gnn_scratch(int n, int f, int hid, int mm_bf16) {
  return (long long)fwd_layout(n, f, hid, mm_bf16).total;
}
#endif

// feat, hn, y: (N, F); nbr: (D, N, F); mask: (D, N); weights in torch
// Linear layout (out, in): wr (F, F), w1 (hid, F), w2 (F, hid). Dropout:
// masks keyed by (seed, 0) and (seed, 1) when drop_on, keep iff Philox bits
// >= threshold, kept values x drop_scale. mm_bf16: the three products on
// wg_gemm.cuh (operands rounded to bf16, float32 sums), the JAX kernel's
// mm_dtype=bfloat16; the scores and the message sum stay float32, as
// there. grappa_fused_gnn_fwd_rows (GRAPPA_SHARDED_DROP) takes a rank's N
// rows of rows_glob nodes, from row0 on: its masks are the unsharded ones'
// rows.
int GRAPPA_ENTRY(grappa_fused_gnn_fwd)(
    const float* feat, const float* nbr, const float* hn, const float* mask,
    const float* wr, const float* br, const float* g2, const float* b2,
    const float* w1, const float* c1, const float* w2, const float* c2,
    GRAPPA_DROP_PARAMS, float* scratch, float* y, int n, int f, int hid,
    int d, int n_heads, float scale, int mm_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Drop m1 = GRAPPA_DROP(0, f, n);
  const Drop m2 = GRAPPA_DROP(1, f, n);
  return (mm_bf16 ? gnn_fwd_bf16 : gnn_fwd_f32)(
      feat, nbr, hn, mask, wr, br, g2, b2, w1, c1, w2, c2, m1, m2, scratch,
      y, n, f, hid, d, n_heads, scale, st);
}

#ifndef GRAPPA_SHARDED_DROP
long long grappa_fused_gnn_bwd_scratch(int n, int f, int hid, int mm_bf16) {
  return (long long)bwd_layout(n, f, hid, mm_bf16).total;
}
#endif

// Gradients of the forward above for dy (N, F): dfeat, dhn (N, F), dnbr
// (D, N, F) and the eight parameter gradients in the parameters' shapes.
// `fwd` is the forward's scratch from the same inputs and mode, read only;
// hn and the biases are not read (the intermediates hold their effect).
// mm_bf16: the six products on wg_gemm.cuh, both operands rounded to bf16
// (dy's descendants too), float32 sums, as the JAX kernel's _dot_tn /
// _dot_nt with mm_dtype=bfloat16; the column sums, the LayerNorm backward
// and the attention backward stay float32, as there.
int GRAPPA_ENTRY(grappa_fused_gnn_bwd)(
    const float* feat, const float* nbr, const float* mask, const float* wr,
    const float* g2, const float* w1, const float* w2, const float* dy,
    GRAPPA_DROP_PARAMS, const float* fwd, float* scratch, float* dfeat,
    float* dnbr, float* dhn, float* dwr, float* dbr, float* dg2, float* db2,
    float* dw1, float* dc1, float* dw2, float* dc2, int n, int f, int hid,
    int d, int n_heads, float scale, int mm_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Drop m1 = GRAPPA_DROP(0, f, n);
  const Drop m2 = GRAPPA_DROP(1, f, n);
  RETURN_IF_ERR(
      mm_bf16 ? gnn_bwd_bf16(g2, dy, m1, m2, fwd, scratch, dhn, dwr, dbr, dg2,
                             db2, dw1, dc1, dw2, dc2, n, f, hid, st)
              : gnn_bwd_f32(wr, g2, w1, w2, dy, m1, m2, fwd, scratch, dhn,
                            dwr, dbr, dg2, db2, dw1, dc1, dw2, dc2, n, f, hid,
                            st));
  if (n == 0) return (int)cudaGetLastError();
  const float* dattn0 = scratch + bwd_layout(n, f, hid, mm_bf16).dattn0;
  const int blocks = cdiv((long long)n * n_heads, kWarps);
  auto f32 = [&] {
    gnn_attention_bwd_kernel<<<blocks, kThreads, 0, st>>>(
        feat, nbr, mask, dattn0, dfeat, dnbr, n, f, d, n_heads, scale);
  };
  if (mm_bf16)
    by_head_width(f / n_heads, [&](auto j) {
      gnn_attention_bwd_r_kernel<decltype(j)::value>
          <<<blocks, kThreads, 0, st>>>(feat, nbr, mask, dattn0, dfeat, dnbr,
                                        n, f, d, n_heads, scale);
    }, f32);
  else
    f32();
  return (int)cudaGetLastError();
}

}  // extern "C"
