// K2: one tuple-head TransformerBlock on x (S, T, F), forward.
//
// Replaces the Pallas kernel grappa_tpu/ops/fused_block.py::
// fused_transformer_block (forward: _fused_fwd -> _fwd_kernel ->
// _forward_body / _attention): LN1, packed QKV (F -> 3F), per-tuple S x S
// softmax attention per head, out_proj, + LN1 output; LN2, F -> hid elu,
// hid -> F, + LN2 output (both residual bases are the normalised tensors).
//
// Bound on an H100 SXM: at the largest serving shape (S=4, T=2152, F=512,
// hid=512) the four dense products are 2*S*T*(3F*F + F*F + 2*F*hid)
// = 27 GFLOP against ~42 MB of input, output and weights: bound by
// operations, about 0.4 ms at the 67 TFLOP/s fp32 peak outside the tensor
// cores (memory alone ~0.015 ms).
//
// Design (bring-up, right before fast): seven launches on the caller's
// stream -- LN1, the QKV GEMM, the attention pass (one warp per tuple and
// head; all S slots of the tuple are read by that warp, so the S x S
// softmax never leaves registers), the out_proj GEMM with the + LN1
// residual in its epilogue, LN2, and the two FF GEMMs (elu, then + LN2
// residual, in their epilogues). The GEMMs are the shared-memory tiled fp32
// FFMA kernel of common.cuh; moving them onto the tensor cores is later
// work. Rows are the S planes of T tuples one after another, as the (S, T,
// F) layout stores them; the ragged T edge is masked, nothing is padded.
#include "common.cuh"

namespace {

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
  const int ld = 3 * F;
  const float* base = qkv + (size_t)t * ld + h * dh;
  const size_t plane = (size_t)T * ld;

  float wgt[S][S];
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

}  // namespace

extern "C" {

// Floats of scratch: xn, attn0, x1, x1n (R x F each), qkv (R x 3F) and the
// hidden activation (R x hid), with R = S*T rows.
long long grappa_fused_block_scratch(int s, int t, int f, int hid) {
  const long long r = (long long)s * t;
  return r * (7LL * f + hid);
}

// x, y: (S, T, F); weights in torch layout: wq (3F, F), wo (F, F),
// w1 (hid, F), w2 (F, hid). S must be 2, 3 or 4.
int grappa_fused_block_fwd(const float* x, const float* g1, const float* b1,
                           const float* wq, const float* bq, const float* wo,
                           const float* bo, const float* g2, const float* b2,
                           const float* w1, const float* c1, const float* w2,
                           const float* c2, float* scratch, float* y, int s,
                           int t, int f, int hid, int n_heads, float scale,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int r = s * t;
  float* xn = scratch;
  float* qkv = xn + (size_t)r * f;
  float* attn0 = qkv + (size_t)r * 3 * f;
  float* x1 = attn0 + (size_t)r * f;
  float* x1n = x1 + (size_t)r * f;
  float* a = x1n + (size_t)r * f;

  RETURN_IF_ERR(layernorm(x, f, xn, f, g1, b1, r, f, st));
  RETURN_IF_ERR(gemm(PlainLoad{xn, f}, wq, f, bq, nullptr, 0, qkv, 3 * f, r,
                     3 * f, f, false, false, st));
  if (t > 0) {
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
  }
  RETURN_IF_ERR((int)cudaGetLastError());
  // x1 = attn0 @ wo^T + bo + xn
  RETURN_IF_ERR(gemm(PlainLoad{attn0, f}, wo, f, bo, xn, f, x1, f, r, f, f,
                     false, false, st));
  RETURN_IF_ERR(layernorm(x1, f, x1n, f, g2, b2, r, f, st));
  // a = elu(x1n @ w1^T + c1)
  RETURN_IF_ERR(gemm(PlainLoad{x1n, f}, w1, f, c1, nullptr, 0, a, hid, r, hid,
                     f, true, false, st));
  // y = a @ w2^T + c2 + x1n
  return gemm(PlainLoad{a, hid}, w2, hid, c2, x1n, f, y, f, r, f, hid, false,
              false, st);
}

}  // extern "C"
