// K2 / K2b: one tuple-head TransformerBlock on x (S, T, F), forward (with
// dropout) and backward.
//
// Replaces the Pallas kernels of grappa_tpu/ops/fused_block.py::
// fused_transformer_block: the forward _fused_fwd -> _fwd_kernel ->
// _forward_body / _attention, and the backward _fused_bwd -> _bwd_kernel:
// LN1, packed QKV (F -> 3F), per-tuple S x S softmax attention per head,
// out_proj, dropout (mask 1), + LN1 output; LN2, F -> hid elu, hid -> F,
// dropout (mask 2), + LN2 output (both residual bases are the normalised
// tensors). Dropout masks are Philox bits keyed by (seed, 0) and (seed, 1),
// counted by the element's flat index in the (S, T, F) layout (common.cuh).
//
// Bound on an H100 SXM: the four dense products are 2*(3F*F + F*F +
// 2*F*hid) = 3.1 MFLOP a row (F = hid = 512) against ~4 KB a row of input
// and output: bound by operations at the 67 TFLOP/s fp32 peak outside the
// tensor cores. The backward's own work is twice that, 6.3 MFLOP a row;
// this design also recomputes the forward, 9.4 MFLOP a row. At the
// 128-molecule training batch the four heads give 66,456 rows per block
// depth: 209 GFLOP forward (3.1 ms at the peak) and 418 GFLOP backward
// (6.2 ms) for one block of each head.
//
// Design (bring-up, right before fast): forward -- LN1, the QKV GEMM, the
// attention pass (one warp per tuple and head; all S slots of the tuple are
// read by that warp, so the S x S softmax never leaves registers), the
// out_proj GEMM with dropout and the + LN1 residual in its epilogue, LN2,
// and the two FF GEMMs (elu, then dropout and + LN2 residual, in their
// epilogues). Backward -- recompute those intermediates into scratch
// (pre-activation of the FF kept, its elu formed on load), regenerate the
// masks from the seed, then dX = dY W GEMMs with the elu' factor or the
// residual in their epilogue, split-K dW = dY^T X GEMMs with a fixed-order
// reduction (no atomics), column sums for biases and LN parameters, a
// warp-per-row LayerNorm backward and an attention-backward pass (one warp
// per tuple and head, the S x S softmax backward in registers). Rows are
// the S planes of T tuples one after another; the ragged T edge is masked,
// nothing is padded.
#include "common.cuh"

namespace {

// Softmax weights of tuple t, head h: wgt[s1][s2] over the S slots.
template <int S>
__device__ __forceinline__ void tuple_weights(const float* base, size_t plane,
                                              int F, int dh, float scale,
                                              int lane, float wgt[S][S]) {
#pragma unroll
  for (int s1 = 0; s1 < S; ++s1) {
    const float* q = base + s1 * plane;
#pragma unroll
    for (int s2 = 0; s2 < S; ++s2) {
      const float* k = base + s2 * plane + F;
      float p = 0.f;
      for (int j = lane; j < dh; j += 32) p += q[j] * k[j];
      wgt[s1][s2] = warp_sum(p) * scale;
    }
    float m = wgt[s1][0];
#pragma unroll
    for (int s2 = 1; s2 < S; ++s2) m = fmaxf(m, wgt[s1][s2]);
    float denom = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < S; ++s2) {
      wgt[s1][s2] = expf(wgt[s1][s2] - m);
      denom += wgt[s1][s2];
    }
#pragma unroll
    for (int s2 = 0; s2 < S; ++s2) wgt[s1][s2] /= denom;
  }
}

// attn0[s1*T + t, h*dh + j] = sum_s2 softmax_s2(q_s1 . k_s2 * scale) v_s2[j]
template <int S>
__global__ void __launch_bounds__(kThreads)
tuple_attention_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                       int T, int F, int H, float scale) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= T * H) return;
  const int t = w / H, h = w - t * H;
  const int dh = F / H;
  const float* base = qkv + (size_t)t * 3 * F + h * dh;
  const size_t plane = (size_t)T * 3 * F;
  float wgt[S][S];
  tuple_weights<S>(base, plane, F, dh, scale, lane, wgt);
  for (int j = lane; j < dh; j += 32) {
    float v[S];
#pragma unroll
    for (int s2 = 0; s2 < S; ++s2) v[s2] = base[s2 * plane + 2 * F + j];
#pragma unroll
    for (int s1 = 0; s1 < S; ++s1) {
      float acc = 0.f;
#pragma unroll
      for (int s2 = 0; s2 < S; ++s2) acc += wgt[s1][s2] * v[s2];
      out[((size_t)s1 * T + t) * F + h * dh + j] = acc;
    }
  }
}

// Attention backward (the JAX _bwd_kernel's unrolled loop), one warp per
// tuple and head: with dw[s1][s2] = dattn0_s1 . v_s2 and
// ds[s1][s2] = w[s1][s2] (dw[s1][s2] - sum_u w[s1][u] dw[s1][u]) * scale,
//   dq_s1 = sum_s2 ds[s1][s2] k_s2,  dk_s2 = sum_s1 ds[s1][s2] q_s1,
//   dv_s2 = sum_s1 w[s1][s2] dattn0_s1,
// written into dqkv (rows x 3F) in the packed [q | k | v] layout.
template <int S>
__global__ void __launch_bounds__(kThreads)
tuple_attention_bwd_kernel(const float* __restrict__ qkv,
                           const float* __restrict__ dattn0,
                           float* __restrict__ dqkv, int T, int F, int H,
                           float scale) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= T * H) return;
  const int t = w / H, h = w - t * H;
  const int dh = F / H;
  const size_t off = (size_t)t * 3 * F + h * dh;
  const size_t plane = (size_t)T * 3 * F;
  const float* base = qkv + off;
  float wgt[S][S];
  tuple_weights<S>(base, plane, F, dh, scale, lane, wgt);
  // dattn0 rows: s*T + t, F wide
  const float* da = dattn0 + (size_t)t * F + h * dh;
  const size_t dplane = (size_t)T * F;
  float ds[S][S];
#pragma unroll
  for (int s1 = 0; s1 < S; ++s1) {
    float wdot = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < S; ++s2) {
      const float* v = base + s2 * plane + 2 * F;
      float p = 0.f;
      for (int j = lane; j < dh; j += 32) p += da[s1 * dplane + j] * v[j];
      ds[s1][s2] = warp_sum(p);
      wdot += wgt[s1][s2] * ds[s1][s2];
    }
#pragma unroll
    for (int s2 = 0; s2 < S; ++s2)
      ds[s1][s2] = wgt[s1][s2] * (ds[s1][s2] - wdot) * scale;
  }
  float* out = dqkv + off;
  for (int j = lane; j < dh; j += 32) {
    float q[S], k[S], a[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      q[s] = base[s * plane + j];
      k[s] = base[s * plane + F + j];
      a[s] = da[s * dplane + j];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float dq = 0.f, dk = 0.f, dv = 0.f;
#pragma unroll
      for (int u = 0; u < S; ++u) {
        dq += ds[s][u] * k[u];
        dk += ds[u][s] * q[u];
        dv += wgt[u][s] * a[u];
      }
      out[s * plane + j] = dq;
      out[s * plane + F + j] = dk;
      out[s * plane + 2 * F + j] = dv;
    }
  }
}

int attention(const float* qkv, float* attn0, int s, int t, int f,
              int n_heads, float scale, cudaStream_t st) {
  if (t == 0) return (int)cudaGetLastError();
  const int blocks = cdiv((long long)t * n_heads, kWarps);
  switch (s) {
    case 2:
      tuple_attention_kernel<2><<<blocks, kThreads, 0, st>>>(
          qkv, attn0, t, f, n_heads, scale);
      break;
    case 3:
      tuple_attention_kernel<3><<<blocks, kThreads, 0, st>>>(
          qkv, attn0, t, f, n_heads, scale);
      break;
    case 4:
      tuple_attention_kernel<4><<<blocks, kThreads, 0, st>>>(
          qkv, attn0, t, f, n_heads, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int attention_bwd(const float* qkv, const float* dattn0, float* dqkv, int s,
                  int t, int f, int n_heads, float scale, cudaStream_t st) {
  if (t == 0) return (int)cudaGetLastError();
  const int blocks = cdiv((long long)t * n_heads, kWarps);
  switch (s) {
    case 2:
      tuple_attention_bwd_kernel<2><<<blocks, kThreads, 0, st>>>(
          qkv, dattn0, dqkv, t, f, n_heads, scale);
      break;
    case 3:
      tuple_attention_bwd_kernel<3><<<blocks, kThreads, 0, st>>>(
          qkv, dattn0, dqkv, t, f, n_heads, scale);
      break;
    case 4:
      tuple_attention_bwd_kernel<4><<<blocks, kThreads, 0, st>>>(
          qkv, dattn0, dqkv, t, f, n_heads, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The forward up to the FF: xn = LN1(x), qkv, attn0,
// x1 = (attn0 wo^T + bo) * mask1 + xn, x1n = LN2(x1).
int block_head(const float* x, const float* g1, const float* b1,
               const float* wq, const float* bq, const float* wo,
               const float* bo, const float* g2, const float* b2,
               const Drop& m1, float* xn, float* qkv, float* attn0, float* x1,
               float* x1n, int s, int t, int f, int n_heads, float scale,
               cudaStream_t st) {
  const int r = s * t;
  RETURN_IF_ERR(layernorm(x, f, xn, f, g1, b1, r, f, st));
  RETURN_IF_ERR(gemm(Mat{xn, f}, wq, f, bq, nullptr, 0, qkv, 3 * f, r, 3 * f,
                     f, false, st));
  RETURN_IF_ERR(attention(qkv, attn0, s, t, f, n_heads, scale, st));
  RETURN_IF_ERR(gemm(Mat{attn0, f}, wo, f, bo, xn, f, x1, f, r, f, f, false,
                     st, m1));
  return layernorm(x1, f, x1n, f, g2, b2, r, f, st);
}

struct BwdLayout {
  size_t xn, qkv, attn0, x1, x1n, tt, dh, dt, dx1n, dx1, da1, datt, dqkv, dxn,
      mean, rstd, wpart, cpart, total;
};

BwdLayout bwd_layout(long long r, long long f, long long hid) {
  BwdLayout l;
  size_t o = 0;
  l.xn = o; o += r * f;
  l.qkv = o; o += r * 3 * f;
  l.attn0 = o; o += r * f;
  l.x1 = o; o += r * f;
  l.x1n = o; o += r * f;
  l.tt = o; o += r * hid;
  l.dh = o; o += r * f;
  l.dt = o; o += r * hid;
  l.dx1n = o; o += r * f;
  l.dx1 = o; o += r * f;
  l.da1 = o; o += r * f;
  l.datt = o; o += r * f;
  l.dqkv = o; o += r * 3 * f;
  l.dxn = o; o += r * f;
  l.mean = o; o += r;
  l.rstd = o; o += r;
  const long long wide = 3 * f > hid ? 3 * f : hid;
  l.wpart = o; o += wgrad_scratch(wide, f);
  l.cpart = o; o += colsum_scratch(r, wide);
  l.total = o;
  return l;
}

}  // namespace

extern "C" {

// Floats of scratch: xn, attn0, x1, x1n (R x F each), qkv (R x 3F) and the
// hidden activation (R x hid), with R = S*T rows.
long long grappa_fused_block_scratch(int s, int t, int f, int hid) {
  const long long r = (long long)s * t;
  return r * (7LL * f + hid);
}

// x, y: (S, T, F); weights in torch layout: wq (3F, F), wo (F, F),
// w1 (hid, F), w2 (F, hid). S must be 2, 3 or 4. Dropout: masks keyed by
// (seed, 0) and (seed, 1) when drop_on, keep iff Philox bits >= threshold,
// kept values x drop_scale.
int grappa_fused_block_fwd(const float* x, const float* g1, const float* b1,
                           const float* wq, const float* bq, const float* wo,
                           const float* bo, const float* g2, const float* b2,
                           const float* w1, const float* c1, const float* w2,
                           const float* c2, uint32_t seed, uint32_t threshold,
                           float drop_scale, int drop_on, float* scratch,
                           float* y, int s, int t, int f, int hid,
                           int n_heads, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int r = s * t;
  float* xn = scratch;
  float* qkv = xn + (size_t)r * f;
  float* attn0 = qkv + (size_t)r * 3 * f;
  float* x1 = attn0 + (size_t)r * f;
  float* x1n = x1 + (size_t)r * f;
  float* a = x1n + (size_t)r * f;
  const Drop m1 = make_drop(seed, 0, threshold, drop_scale, drop_on, f);
  const Drop m2 = make_drop(seed, 1, threshold, drop_scale, drop_on, f);
  RETURN_IF_ERR(block_head(x, g1, b1, wq, bq, wo, bo, g2, b2, m1, xn, qkv,
                           attn0, x1, x1n, s, t, f, n_heads, scale, st));
  // a = elu(x1n @ w1^T + c1)
  RETURN_IF_ERR(gemm(Mat{x1n, f}, w1, f, c1, nullptr, 0, a, hid, r, hid, f,
                     true, st));
  // y = (a @ w2^T + c2) * mask2 + x1n
  return gemm(Mat{a, hid}, w2, hid, c2, x1n, f, y, f, r, f, hid, false,
              st, m2);
}

long long grappa_fused_block_bwd_scratch(int s, int t, int f, int hid) {
  return (long long)bwd_layout((long long)s * t, f, hid).total;
}

// Gradients of the forward above for dy (S, T, F): dx (S, T, F) and the
// twelve parameter gradients in the parameters' shapes.
int grappa_fused_block_bwd(
    const float* x, const float* g1, const float* b1, const float* wq,
    const float* bq, const float* wo, const float* bo, const float* g2,
    const float* b2, const float* w1, const float* c1, const float* w2,
    const float* c2, const float* dy, uint32_t seed, uint32_t threshold,
    float drop_scale, int drop_on, float* scratch, float* dx, float* dg1,
    float* db1, float* dwq, float* dbq, float* dwo, float* dbo, float* dg2,
    float* db2, float* dw1, float* dc1, float* dw2, float* dc2, int s, int t,
    int f, int hid, int n_heads, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int r = s * t;
  const BwdLayout l = bwd_layout(r, f, hid);
  float* p = scratch;
  float *xn = p + l.xn, *qkv = p + l.qkv, *attn0 = p + l.attn0,
        *x1 = p + l.x1, *x1n = p + l.x1n, *tt = p + l.tt, *dh = p + l.dh,
        *dt = p + l.dt, *dx1n = p + l.dx1n, *dx1 = p + l.dx1,
        *da1 = p + l.da1, *datt = p + l.datt, *dqkv = p + l.dqkv,
        *dxn = p + l.dxn, *mean = p + l.mean, *rstd = p + l.rstd,
        *wpart = p + l.wpart, *cpart = p + l.cpart;
  const Drop m1 = make_drop(seed, 0, threshold, drop_scale, drop_on, f);
  const Drop m2 = make_drop(seed, 1, threshold, drop_scale, drop_on, f);

  // recompute the forward's intermediates; tt = x1n w1^T + c1
  RETURN_IF_ERR(block_head(x, g1, b1, wq, bq, wo, bo, g2, b2, m1, xn, qkv,
                           attn0, x1, x1n, s, t, f, n_heads, scale, st));
  RETURN_IF_ERR(gemm(Mat{x1n, f}, w1, f, c1, nullptr, 0, tt, hid, r, hid, f,
                     false, st));

  // y = h * mask2 + x1n, h = elu(tt) w2^T + c2
  const float* dhm = dy;
  if (drop_on) {
    RETURN_IF_ERR(mask_grad(dy, m2, nullptr, dh, r, f, st));
    dhm = dh;
  }
  RETURN_IF_ERR(gemm_wgrad(tr(Mat{dhm, f}), tr(Elu<Mat>{Mat{tt, hid}}), dw2,
                           f, hid, r, wpart, st));
  RETURN_IF_ERR(colsum(Mat{dhm, f}, dc2, r, f, cpart, st));
  Out o = out_to(dt, hid);
  o.gate = tt;
  o.ldg = hid;
  RETURN_IF_ERR(gemm(Mat{dhm, f}, tr(Mat{w2, hid}), o, r, hid, f, st));
  RETURN_IF_ERR(gemm_wgrad(tr(Mat{dt, hid}), tr(Mat{x1n, f}), dw1, hid, f, r,
                           wpart, st));
  RETURN_IF_ERR(colsum(Mat{dt, hid}, dc1, r, hid, cpart, st));
  o = out_to(dx1n, f);
  o.R = dy;
  o.ldr = f;
  RETURN_IF_ERR(gemm(Mat{dt, hid}, tr(Mat{w1, f}), o, r, f, hid, st));
  // x1n = LN2(x1); x1 = attn1 * mask1 + xn
  RETURN_IF_ERR(layernorm_bwd(dx1n, Mat{x1, f}, g2, dx1, dg2, db2, r, f, mean,
                              rstd, cpart, st));
  const float* da = dx1;
  if (drop_on) {
    RETURN_IF_ERR(mask_grad(dx1, m1, nullptr, da1, r, f, st));
    da = da1;
  }
  // attn1 = attn0 wo^T + bo
  RETURN_IF_ERR(gemm_wgrad(tr(Mat{da, f}), tr(Mat{attn0, f}), dwo, f, f, r,
                           wpart, st));
  RETURN_IF_ERR(colsum(Mat{da, f}, dbo, r, f, cpart, st));
  RETURN_IF_ERR(gemm(Mat{da, f}, tr(Mat{wo, f}), out_to(datt, f), r, f, f,
                     st));
  RETURN_IF_ERR(attention_bwd(qkv, datt, dqkv, s, t, f, n_heads, scale, st));
  // qkv = xn wq^T + bq; xn also feeds the residual: dxn = dx1 + dqkv wq
  RETURN_IF_ERR(gemm_wgrad(tr(Mat{dqkv, 3 * f}), tr(Mat{xn, f}), dwq, 3 * f,
                           f, r, wpart, st));
  RETURN_IF_ERR(colsum(Mat{dqkv, 3 * f}, dbq, r, 3 * f, cpart, st));
  o = out_to(dxn, f);
  o.R = dx1;
  o.ldr = f;
  RETURN_IF_ERR(gemm(Mat{dqkv, 3 * f}, tr(Mat{wq, f}), o, r, f, 3 * f, st));
  // xn = LN1(x)
  return layernorm_bwd(dxn, Mat{x, f}, g1, dx, dg1, db1, r, f, mean, rstd,
                       cpart, st);
}

}  // extern "C"
