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
// and output: bound by operations. The backward's work is twice that, 6.3
// MFLOP a row. At the 128-molecule training batch the four heads give
// 66,456 rows per block depth: 209 GFLOP forward and 418 GFLOP backward for
// one block of each head; 3.1 / 6.2 ms at the 67 TFLOP/s fp32 peak outside
// the tensor cores, 1.27 / 2.54 ms as 3xTF32 (three TF32 products per
// float32 product) at the 495 TFLOP/s tensor-core peak.
//
// In bf16 mode (the JAX kernel's mm_dtype=bfloat16) the forward's 3.1 MFLOP
// a row run at the 989 TFLOP/s bf16 peak: 3.2 ns a row against 1.2 ns for
// its ~4 KB of float32 input and output, still bound by operations; the
// backward's 6.3 MFLOP a row 6.4 ns against 1.8 ns for x, dy and dx.
//
// Design: every product runs on the tensor cores, through tc_gemm.cuh in
// float32 (3xTF32 mma.sync fed by a cp.async ring) and through wg_gemm.cuh in
// bf16 mode (wgmma fed by TMA; their notes give the designs), with bias,
// dropout, the elu' factor, a residual or a split-K partial store in its
// epilogue. Forward -- LN1, the QKV GEMM, the attention pass (one warp per
// tuple and head; all S slots of the tuple are read by that warp, so the S x S
// softmax never leaves registers), the out_proj GEMM with dropout and the + LN1
// residual in its epilogue, LN2, and the two FF GEMMs (elu, then dropout and +
// LN2 residual, in their epilogues). The forward's scratch keeps those
// intermediates, R x (7F + hid) floats, and the backward reads them instead of
// recomputing the forward (a third of its products). Backward -- regenerate the
// masks from the seed, then dX = dY W GEMMs with the elu' factor (from the
// stored activation) or the residual in their epilogue, split-K dW = dY^T X
// GEMMs with a fixed-order reduction (no atomics), column sums for biases and
// LN parameters, a warp-per-row LayerNorm backward and an attention-backward
// pass (one warp per tuple and head, the S x S softmax backward in registers).
// Rows are the S planes of T tuples one after another; the ragged T edge is
// masked, nothing is padded.
//
// bf16 mode: wg_gemm.cuh reads bf16 operands, so each is rounded once where
// it is made and stored beside (or instead of) its float32 value, in rows
// padded to a multiple of 8 elements. Forward: the weights are cast once a
// call (one launch for the four) and kept in the forward's scratch for the
// backward; LN1 and LN2 write xn and x1n in both types, FF1's epilogue a in
// both, and the attention pass attn0 in bf16 alone (only products read
// it). Backward: the dropout-mask pass writes dhm and da in both types (a
// cast pass writes the bf16 copy of dy, or of dx1, when dropout is off), the
// elu' epilogue dt in both and the attention backward dqkv in both. The
// float32 copies feed the column sums, the LayerNorm backward and the
// epilogues, as in float32 mode.
#include "bf16_passes.cuh"

#include <type_traits>

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

// launch(std::integral_constant<int, S>) for S = s in 2..4.
template <class Launch>
int by_arity(int s, Launch launch) {
  switch (s) {
    case 2: launch(std::integral_constant<int, 2>{}); break;
    case 3: launch(std::integral_constant<int, 3>{}); break;
    case 4: launch(std::integral_constant<int, 4>{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int attention(const float* qkv, float* attn0, int s, int t, int f,
              int n_heads, float scale, cudaStream_t st) {
  if (t == 0) return (int)cudaGetLastError();
  return by_arity(s, [&](auto arity) {
    tuple_attention_kernel<decltype(arity)::value>
        <<<cdiv((long long)t * n_heads, kWarps), kThreads, 0, st>>>(
            qkv, attn0, t, f, n_heads, scale);
  });
}

int attention_bwd(const float* qkv, const float* dattn0, float* dqkv, int s,
                  int t, int f, int n_heads, float scale, cudaStream_t st) {
  if (t == 0) return (int)cudaGetLastError();
  return by_arity(s, [&](auto arity) {
    tuple_attention_bwd_kernel<decltype(arity)::value>
        <<<cdiv((long long)t * n_heads, kWarps), kThreads, 0, st>>>(
            qkv, dattn0, dqkv, t, f, n_heads, scale);
  });
}

// ---------------------------------------------------------------- bf16 mode
// The attention pass of tuple_attention_kernel with attn0 stored in bf16
// alone, rows ld apart (its only readers are products).
template <int S>
__global__ void __launch_bounds__(kThreads)
tuple_attention_h_kernel(const float* __restrict__ qkv, bf16* __restrict__ out,
                         int ld, int T, int F, int H, float scale) {
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
      out[((size_t)s1 * T + t) * ld + h * dh + j] = __float2bfloat16_rn(acc);
    }
  }
}

// tuple_attention_bwd_kernel, also storing dqkv rounded to bf16 into dqkvh
// (rows ld apart).
template <int S>
__global__ void __launch_bounds__(kThreads)
tuple_attention_bwd_h_kernel(const float* __restrict__ qkv,
                             const float* __restrict__ dattn0,
                             float* __restrict__ dqkv,
                             bf16* __restrict__ dqkvh, int ld, int T, int F,
                             int H, float scale) {
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
  bf16* outh = dqkvh + (size_t)t * ld + h * dh;
  const size_t hplane = (size_t)T * ld;
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
      outh[s * hplane + j] = __float2bfloat16_rn(dq);
      outh[s * hplane + F + j] = __float2bfloat16_rn(dk);
      outh[s * hplane + 2 * F + j] = __float2bfloat16_rn(dv);
    }
  }
}

// The forward's intermediates, which the backward reads: xn = LN1(x),
// qkv, attn0, x1 = (attn0 wo^T + bo) * mask1 + xn, x1n = LN2(x1) and the
// FF's activation a = elu(x1n w1^T + c1), R = S*T rows each. In bf16 mode
// also the bf16 copies of xn, x1n and a, attn0 in bf16 alone, and the four
// weights in bf16 (rows padded to 8 elements; offsets in floats, 16-byte
// aligned).
struct FwdLayout {
  size_t xn, qkv, attn0, x1, x1n, a, total;
  size_t xn_h, attn0_h, x1n_h, a_h, wq_h, wo_h, w1_h, w2_h;
};

FwdLayout fwd_layout(long long r, long long f, long long hid, bool h) {
  FwdLayout l{};
  size_t o = 0;
  l.xn = o; o += r * f;
  l.qkv = o; o += r * 3 * f;
  if (!h) { l.attn0 = o; o += r * f; }
  l.x1 = o; o += r * f;
  l.x1n = o; o += r * f;
  l.a = o; o += r * hid;
  if (h) {
    const long long fh = pad8(f), hh = pad8(hid);
    o = (o + 3) / 4 * 4;
    l.xn_h = carve(o, h_floats(r * fh));
    l.attn0_h = carve(o, h_floats(r * fh));
    l.x1n_h = carve(o, h_floats(r * fh));
    l.a_h = carve(o, h_floats(r * hh));
    l.wq_h = carve(o, h_floats(3 * f * fh));
    l.wo_h = carve(o, h_floats(f * fh));
    l.w1_h = carve(o, h_floats(hid * fh));
    l.w2_h = carve(o, h_floats(f * hh));
  }
  l.total = o;
  return l;
}

// In bf16 mode also the bf16 copies of dhm (dy x mask2), dt, da (dx1 x
// mask1) and dqkv.
struct BwdLayout {
  size_t dh, dt, dx1n, dx1, da1, datt, dqkv, dxn, mean, rstd, wpart, cpart,
      total;
  size_t dhm_h, dt_h, da_h, dqkv_h;
};

BwdLayout bwd_layout(long long r, long long f, long long hid, bool h) {
  BwdLayout l{};
  size_t o = 0;
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
  if (h) {
    o = (o + 3) / 4 * 4;
    l.dhm_h = carve(o, h_floats(r * pad8(f)));
    l.dt_h = carve(o, h_floats(r * pad8(hid)));
    l.da_h = carve(o, h_floats(r * pad8(f)));
    l.dqkv_h = carve(o, h_floats(r * pad8(3 * f)));
  }
  l.total = o;
  return l;
}

// The forward in bf16 mode: every product on wg_gemm.cuh.
int block_fwd_bf16(const float* x, const float* g1, const float* b1,
                   const float* wq, const float* bq, const float* wo,
                   const float* bo, const float* g2, const float* b2,
                   const float* w1, const float* c1, const float* w2,
                   const float* c2, const Drop& m1, const Drop& m2,
                   float* scratch, float* y, int s, int t, int f, int hid,
                   int n_heads, float scale, cudaStream_t st) {
  const int r = s * t, fh = pad8(f), hh = pad8(hid);
  const FwdLayout l = fwd_layout(r, f, hid, true);
  float *xn = scratch + l.xn, *qkv = scratch + l.qkv, *x1 = scratch + l.x1,
        *x1n = scratch + l.x1n, *a = scratch + l.a;
  bf16 *xn_h = as_h(scratch, l.xn_h), *attn0_h = as_h(scratch, l.attn0_h),
       *x1n_h = as_h(scratch, l.x1n_h), *a_h = as_h(scratch, l.a_h),
       *wq_h = as_h(scratch, l.wq_h), *wo_h = as_h(scratch, l.wo_h),
       *w1_h = as_h(scratch, l.w1_h), *w2_h = as_h(scratch, l.w2_h);
  const ToBf16 weights[4] = {cast_of(wq, wq_h, 3 * f, f, fh),
                             cast_of(wo, wo_h, f, f, fh),
                             cast_of(w1, w1_h, hid, f, fh),
                             cast_of(w2, w2_h, f, hid, hh)};
  RETURN_IF_ERR(to_bf16(weights, 4, st));
  RETURN_IF_ERR(layernorm_h(x, xn, xn_h, fh, g1, b1, r, f, st));
  Out o = out_to(qkv, 3 * f);
  o.bias = bq;
  RETURN_IF_ERR(wg_gemm(MatH{xn_h, fh}, MatH{wq_h, fh}, o, r, 3 * f, f, st));
  if (t > 0)
    RETURN_IF_ERR(by_arity(s, [&](auto arity) {
      tuple_attention_h_kernel<decltype(arity)::value>
          <<<cdiv((long long)t * n_heads, kWarps), kThreads, 0, st>>>(
              qkv, attn0_h, fh, t, f, n_heads, scale);
    }));
  // x1 = (attn0 wo^T + bo) * mask1 + xn
  o = out_to(x1, f);
  o.bias = bo;
  o.drop = m1;
  o.R = xn;
  o.ldr = f;
  RETURN_IF_ERR(wg_gemm(MatH{attn0_h, fh}, MatH{wo_h, fh}, o, r, f, f, st));
  RETURN_IF_ERR(layernorm_h(x1, x1n, x1n_h, fh, g2, b2, r, f, st));
  RETURN_IF_ERR(wg_gemm(MatH{x1n_h, fh}, MatH{w1_h, fh},
                        EluOutH{c1, a, hid, a_h, hh}, r, hid, f, st));
  // y = (a @ w2^T + c2) * mask2 + x1n
  o = out_to(y, f);
  o.bias = c2;
  o.drop = m2;
  o.R = x1n;
  o.ldr = f;
  return wg_gemm(MatH{a_h, hh}, MatH{w2_h, hh}, o, r, f, hid, st);
}

// The backward's products in bf16 mode (wg_gemm.cuh), up to dxn.
int block_bwd_bf16(const float* g2, const float* dy, const Drop& m1,
                   const Drop& m2, const float* fwd, float* p, float* dg2,
                   float* db2, float* dbq, float* dwq, float* dwo, float* dbo,
                   float* dw1, float* dc1, float* dw2, float* dc2, int s,
                   int t, int f, int hid, int n_heads, float scale,
                   cudaStream_t st) {
  const int r = s * t, fh = pad8(f), hh = pad8(hid), qh = pad8(3 * f);
  const FwdLayout lf = fwd_layout(r, f, hid, true);
  const float *qkv = fwd + lf.qkv, *x1 = fwd + lf.x1, *a = fwd + lf.a;
  const bf16 *xn_h = as_h(fwd, lf.xn_h), *attn0_h = as_h(fwd, lf.attn0_h),
             *x1n_h = as_h(fwd, lf.x1n_h), *a_h = as_h(fwd, lf.a_h),
             *wq_h = as_h(fwd, lf.wq_h), *wo_h = as_h(fwd, lf.wo_h),
             *w1_h = as_h(fwd, lf.w1_h), *w2_h = as_h(fwd, lf.w2_h);
  const BwdLayout l = bwd_layout(r, f, hid, true);
  float *dh = p + l.dh, *dt = p + l.dt, *dx1n = p + l.dx1n, *dx1 = p + l.dx1,
        *da1 = p + l.da1, *datt = p + l.datt, *dqkv = p + l.dqkv,
        *dxn = p + l.dxn, *mean = p + l.mean, *rstd = p + l.rstd,
        *wpart = p + l.wpart, *cpart = p + l.cpart;
  bf16 *dhm_h = as_h(p, l.dhm_h), *dt_h = as_h(p, l.dt_h),
       *da_h = as_h(p, l.da_h), *dqkv_h = as_h(p, l.dqkv_h);

  // y = h * mask2 + x1n, h = a w2^T + c2, a = elu(x1n w1^T + c1)
  const float* dhm = m2.on ? dh : dy;
  const ToBf16 dhm_cast =
      cast_of(dy, dhm_h, r, f, fh, m2, m2.on ? dh : nullptr);
  RETURN_IF_ERR(to_bf16(&dhm_cast, 1, st));
  RETURN_IF_ERR(wg_gemm_wgrad(tr(MatH{dhm_h, fh}), tr(MatH{a_h, hh}), dw2, f,
                              hid, r, wpart, st));
  RETURN_IF_ERR(colsum(Mat{dhm, f}, dc2, r, f, cpart, st));
  RETURN_IF_ERR(wg_gemm(MatH{dhm_h, fh}, tr(MatH{w2_h, hh}),
                        EluGradOutH{dt, hid, a, hid, dt_h, hh}, r, hid, f,
                        st));
  RETURN_IF_ERR(wg_gemm_wgrad(tr(MatH{dt_h, hh}), tr(MatH{x1n_h, fh}), dw1,
                              hid, f, r, wpart, st));
  RETURN_IF_ERR(colsum(Mat{dt, hid}, dc1, r, hid, cpart, st));
  Out o = out_to(dx1n, f);
  o.R = dy;
  o.ldr = f;
  RETURN_IF_ERR(wg_gemm(MatH{dt_h, hh}, tr(MatH{w1_h, fh}), o, r, f, hid,
                        st));
  // x1n = LN2(x1); x1 = attn1 * mask1 + xn
  RETURN_IF_ERR(layernorm_bwd(dx1n, Mat{x1, f}, g2, dx1, dg2, db2, r, f,
                              mean, rstd, cpart, st));
  const float* da = m1.on ? da1 : dx1;
  const ToBf16 da_cast =
      cast_of(dx1, da_h, r, f, fh, m1, m1.on ? da1 : nullptr);
  RETURN_IF_ERR(to_bf16(&da_cast, 1, st));
  // attn1 = attn0 wo^T + bo
  RETURN_IF_ERR(wg_gemm_wgrad(tr(MatH{da_h, fh}), tr(MatH{attn0_h, fh}), dwo,
                              f, f, r, wpart, st));
  RETURN_IF_ERR(colsum(Mat{da, f}, dbo, r, f, cpart, st));
  RETURN_IF_ERR(wg_gemm(MatH{da_h, fh}, tr(MatH{wo_h, fh}), out_to(datt, f),
                        r, f, f, st));
  if (t > 0)
    RETURN_IF_ERR(by_arity(s, [&](auto arity) {
      tuple_attention_bwd_h_kernel<decltype(arity)::value>
          <<<cdiv((long long)t * n_heads, kWarps), kThreads, 0, st>>>(
              qkv, datt, dqkv, dqkv_h, qh, t, f, n_heads, scale);
    }));
  // qkv = xn wq^T + bq; xn also feeds the residual: dxn = dx1 + dqkv wq
  RETURN_IF_ERR(wg_gemm_wgrad(tr(MatH{dqkv_h, qh}), tr(MatH{xn_h, fh}), dwq,
                              3 * f, f, r, wpart, st));
  RETURN_IF_ERR(colsum(Mat{dqkv, 3 * f}, dbq, r, 3 * f, cpart, st));
  o = out_to(dxn, f);
  o.R = dx1;
  o.ldr = f;
  return wg_gemm(MatH{dqkv_h, qh}, tr(MatH{wq_h, fh}), o, r, f, 3 * f, st);
}

}  // namespace

extern "C" {

#ifndef GRAPPA_SHARDED_DROP
// Floats of the forward's scratch: its intermediates (FwdLayout), R x (7F +
// hid); in bf16 mode R x (6F + hid) and the bf16 copies, R x (3F + hid) / 2
// and the weights. The backward reads them: keep the scratch until it has
// run.
long long grappa_fused_block_scratch(int s, int t, int f, int hid,
                                     int mm_bf16) {
  return (long long)fwd_layout((long long)s * t, f, hid, mm_bf16).total;
}
#endif

// x, y: (S, T, F); weights in torch layout: wq (3F, F), wo (F, F),
// w1 (hid, F), w2 (F, hid). S must be 2, 3 or 4. Dropout: masks keyed by
// (seed, 0) and (seed, 1) when drop_on, keep iff Philox bits >= threshold,
// kept values x drop_scale. mm_bf16: the four products on wg_gemm.cuh's
// bf16 wgmma (operands rounded to bf16, float32 sums), the JAX kernel's
// mm_dtype=bfloat16; LayerNorms and attention stay float32, as there.
// grappa_fused_block_fwd_rows (GRAPPA_SHARDED_DROP) takes a rank's T tuples
// of rows_glob, from row0 on: mask element (s, t, f) is the unsharded
// mask's (s, row0 + t, f).
int GRAPPA_ENTRY(grappa_fused_block_fwd)(
    const float* x, const float* g1, const float* b1, const float* wq,
    const float* bq, const float* wo, const float* bo, const float* g2,
    const float* b2, const float* w1, const float* c1, const float* w2,
    const float* c2, GRAPPA_DROP_PARAMS, float* scratch, float* y, int s,
    int t, int f, int hid, int n_heads, float scale, int mm_bf16,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int r = s * t;
  const Drop m1 = GRAPPA_DROP(0, f, t);
  const Drop m2 = GRAPPA_DROP(1, f, t);
  if (mm_bf16)
    return block_fwd_bf16(x, g1, b1, wq, bq, wo, bo, g2, b2, w1, c1, w2, c2,
                          m1, m2, scratch, y, s, t, f, hid, n_heads, scale,
                          st);
  const FwdLayout l = fwd_layout(r, f, hid, false);
  float *xn = scratch + l.xn, *qkv = scratch + l.qkv,
        *attn0 = scratch + l.attn0, *x1 = scratch + l.x1,
        *x1n = scratch + l.x1n, *a = scratch + l.a;
  RETURN_IF_ERR(layernorm(x, f, xn, f, g1, b1, r, f, st));
  RETURN_IF_ERR(tc_gemm(Mat{xn, f}, wq, f, bq, nullptr, 0, qkv, 3 * f, r,
                        3 * f, f, false, st));
  RETURN_IF_ERR(attention(qkv, attn0, s, t, f, n_heads, scale, st));
  RETURN_IF_ERR(tc_gemm(Mat{attn0, f}, wo, f, bo, xn, f, x1, f, r, f, f,
                        false, st, m1));
  RETURN_IF_ERR(layernorm(x1, f, x1n, f, g2, b2, r, f, st));
  RETURN_IF_ERR(tc_gemm(Mat{x1n, f}, w1, f, c1, nullptr, 0, a, hid, r, hid,
                        f, true, st));
  // y = (a @ w2^T + c2) * mask2 + x1n
  return tc_gemm(Mat{a, hid}, w2, hid, c2, x1n, f, y, f, r, f, hid, false,
                 st, m2);
}

#ifndef GRAPPA_SHARDED_DROP
long long grappa_fused_block_bwd_scratch(int s, int t, int f, int hid,
                                         int mm_bf16) {
  return (long long)bwd_layout((long long)s * t, f, hid, mm_bf16).total;
}
#endif

// Gradients of the forward above for dy (S, T, F): dx (S, T, F) and the
// twelve parameter gradients in the parameters' shapes. `fwd` is the
// forward's scratch from the same inputs and mode, read only; b1, b2 and the
// biases are not read (the forward's intermediates hold their effect).
// mm_bf16: the eight products on wg_gemm.cuh's bf16 wgmma, both operands
// rounded to bf16 (dy's descendants too), float32 sums, as the JAX kernel's
// _dot_tn / _dot_nt with mm_dtype=bfloat16; column sums, LayerNorm and
// attention backward stay float32, as there.
int GRAPPA_ENTRY(grappa_fused_block_bwd)(
    const float* x, const float* g1, const float* b1, const float* wq,
    const float* bq, const float* wo, const float* bo, const float* g2,
    const float* b2, const float* w1, const float* c1, const float* w2,
    const float* c2, const float* dy, GRAPPA_DROP_PARAMS, const float* fwd,
    float* scratch, float* dx, float* dg1, float* db1, float* dwq,
    float* dbq, float* dwo, float* dbo, float* dg2, float* db2, float* dw1,
    float* dc1, float* dw2, float* dc2, int s, int t, int f, int hid,
    int n_heads, float scale, int mm_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int r = s * t;
  const Drop m1 = GRAPPA_DROP(0, f, t);
  const Drop m2 = GRAPPA_DROP(1, f, t);
  const BwdLayout l = bwd_layout(r, f, hid, mm_bf16);
  float* p = scratch;
  float *dxn = p + l.dxn, *mean = p + l.mean, *rstd = p + l.rstd,
        *cpart = p + l.cpart;
  if (mm_bf16) {
    RETURN_IF_ERR(block_bwd_bf16(g2, dy, m1, m2, fwd, p, dg2, db2, dbq, dwq,
                                 dwo, dbo, dw1, dc1, dw2, dc2, s, t, f, hid,
                                 n_heads, scale, st));
  } else {
    const FwdLayout lf = fwd_layout(r, f, hid, false);
    const float *xn = fwd + lf.xn, *qkv = fwd + lf.qkv,
                *attn0 = fwd + lf.attn0, *x1 = fwd + lf.x1,
                *x1n = fwd + lf.x1n, *a = fwd + lf.a;
    float *dh = p + l.dh, *dt = p + l.dt, *dx1n = p + l.dx1n,
          *dx1 = p + l.dx1, *da1 = p + l.da1, *datt = p + l.datt,
          *dqkv = p + l.dqkv, *wpart = p + l.wpart;
    // y = h * mask2 + x1n, h = a w2^T + c2, a = elu(x1n w1^T + c1)
    const float* dhm = dy;
    if (drop_on) {
      RETURN_IF_ERR(mask_grad(dy, m2, nullptr, dh, r, f, st));
      dhm = dh;
    }
    RETURN_IF_ERR(tc_gemm_wgrad(tr(Mat{dhm, f}), tr(Mat{a, hid}), dw2, f,
                                hid, r, wpart, st));
    RETURN_IF_ERR(colsum(Mat{dhm, f}, dc2, r, f, cpart, st));
    RETURN_IF_ERR(tc_gemm(Mat{dhm, f}, tr(Mat{w2, hid}),
                          EluGradOut{dt, hid, a, hid}, r, hid, f, st));
    RETURN_IF_ERR(tc_gemm_wgrad(tr(Mat{dt, hid}), tr(Mat{x1n, f}), dw1, hid,
                                f, r, wpart, st));
    RETURN_IF_ERR(colsum(Mat{dt, hid}, dc1, r, hid, cpart, st));
    Out o = out_to(dx1n, f);
    o.R = dy;
    o.ldr = f;
    RETURN_IF_ERR(tc_gemm(Mat{dt, hid}, tr(Mat{w1, f}), o, r, f, hid, st));
    // x1n = LN2(x1); x1 = attn1 * mask1 + xn
    RETURN_IF_ERR(layernorm_bwd(dx1n, Mat{x1, f}, g2, dx1, dg2, db2, r, f,
                                mean, rstd, cpart, st));
    const float* da = dx1;
    if (drop_on) {
      RETURN_IF_ERR(mask_grad(dx1, m1, nullptr, da1, r, f, st));
      da = da1;
    }
    // attn1 = attn0 wo^T + bo
    RETURN_IF_ERR(tc_gemm_wgrad(tr(Mat{da, f}), tr(Mat{attn0, f}), dwo, f,
                                f, r, wpart, st));
    RETURN_IF_ERR(colsum(Mat{da, f}, dbo, r, f, cpart, st));
    RETURN_IF_ERR(tc_gemm(Mat{da, f}, tr(Mat{wo, f}), out_to(datt, f), r, f,
                          f, st));
    RETURN_IF_ERR(attention_bwd(qkv, datt, dqkv, s, t, f, n_heads, scale,
                                st));
    // qkv = xn wq^T + bq; xn also feeds the residual: dxn = dx1 + dqkv wq
    RETURN_IF_ERR(tc_gemm_wgrad(tr(Mat{dqkv, 3 * f}), tr(Mat{xn, f}), dwq,
                                3 * f, f, r, wpart, st));
    RETURN_IF_ERR(colsum(Mat{dqkv, 3 * f}, dbq, r, 3 * f, cpart, st));
    o = out_to(dxn, f);
    o.R = dx1;
    o.ldr = f;
    RETURN_IF_ERR(tc_gemm(Mat{dqkv, 3 * f}, tr(Mat{wq, f}), o, r, f, 3 * f,
                          st));
  }
  // xn = LN1(x)
  return layernorm_bwd(dxn, Mat{x, f}, g1, dx, dg1, db1, r, f, mean, rstd,
                       cpart, st);
}

}  // extern "C"
