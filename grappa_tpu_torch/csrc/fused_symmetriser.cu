// K3 / K3b: the Symmetriser on x (S, T, F) -> (T, out), forward and
// backward.
//
// Replaces the Pallas kernels of grappa_tpu/ops/fused_symmetriser.py::
// fused_symmetriser: the forward _fwd -> _fwd_kernel -> _ff_chain_fwd and
// the backward _bwd -> _bwd_kernel -> _ff_chain_bwd: for each symmetry
// permutation, the permuted flattening (T, S*F) of the tuple features, then
// an n-layer FeedForward chain (pre-LN, elu hidden layer, skip adding the
// normalised input on the middle layers only); the outputs are summed over
// the permutations. No dropout (it would break permutation invariance).
//
// Bound on an H100 SXM: with P permutations, width W=256 and 3 layers the
// products are 2*P*(S*F*W + 4*W*W + W*out) FLOP a tuple: 3.2 MFLOP for a
// (4, 512) tuple and 2 permutations, bound by operations. The backward's
// work is twice that. At the 128-molecule training batch the four heads'
// calls are 56 GFLOP forward and 111 GFLOP backward: 0.34 and 0.68 ms as
// 3xTF32 (three TF32 products per float32 product) at the 495 TFLOP/s
// tensor-core peak (0.83 and 1.67 ms at the 67 TFLOP/s fp32 peak outside
// them).
//
// In bf16 mode (the JAX kernel's mm_dtype=bfloat16) the forward's products
// run at the 989 TFLOP/s bf16 peak, 3.2 ns a (4, 512) tuple against 2.4 ns
// for its 8 KB of float32 input: still bound by operations, barely; the
// backward's twice the products 6.5 ns against 4.9 ns for x and dx. Layer
// 0's normalised permuted rows hn_0 (P x S*F values a tuple) are the
// largest stream the kernels make themselves, so bf16 mode stores them in
// bf16 alone.
//
// Design: all P permutations run as one batch of P*T rows, and every product
// runs on the tensor cores: in float32 through tc_gemm.cuh (3xTF32 mma.sync
// fed by a cp.async ring, which takes stored operands only), in bf16 mode
// through wg_gemm.cuh (bf16 wgmma fed by TMA; its note gives the design).
// Forward -- one row pass
// (a warp a tuple, addressing the S planes of x slot by slot, with no
// division per element) computes the row mean and 1/std that the tuple's P
// permuted rows share and writes layer 0's normalised input hn_0 (P*T x S*F),
// reading x once; later layers start with a LayerNorm pass; each layer is two
// GEMMs (elu, then the skip residual on the middle layers, in the GEMM
// epilogues); a last pass sums the P row blocks in permutation order. The
// forward's scratch keeps what the backward reads: layer 0's row mean and
// 1/std, and per layer its normalised input hn_i, its activation elu(t_i)
// and, from layer 1 on, its input h_i. Backward -- per layer, last first, dW
// = dY^T X over all P*T rows in fixed split-K slices summed in slice order
// (so the sum over permutations is part of the product, in a fixed order), dX
// = dY W with elu' (formed from the stored activation) or the skip in the
// epilogue, column sums and a LayerNorm backward. Layer 0's LayerNorm
// backward reads x through the permutation with the forward's statistics
// (those hn_0 was built from), in two passes: the row means, then one thread
// a column of x that adds each permutation's gradient at that element into dx
// in permutation order (no permuted gradient is stored) and keeps the dg / db
// partial sums. The element passes address x slot by slot, with no division
// per element. No atomics: two runs give the same bits.
//
// bf16 mode: wg_gemm.cuh reads bf16 operands, so each is rounded once where
// it is made (bf16_passes.cuh), in rows padded to a multiple of 8 elements.
// Forward: the 2 x n_layers weights are cast once a call and kept in the
// forward's scratch for the backward; the row pass writes hn_0 in bf16 alone
// (no float32 hn_0: layer 0 has no skip, and the backward's LayerNorm
// backward reads x and the row statistics); later layers' LayerNorms write
// hn_i in both types (float32 for the skip) and the elu epilogue e_i in both
// (float32 for the backward's elu'). Backward: the output gradient is tiled
// in both types, the elu' epilogue writes dt in both and a cast pass the
// bf16 copy of each LayerNorm backward's output; the float32 copies feed the
// column sums, the epilogues and the LayerNorm backward, as in float32 mode.
#include "bf16_passes.cuh"

namespace {

constexpr int kMaxPerm = 6;
constexpr int kMaxS = 4;

// Row r = p*T + t of the permuted flattening: element s*F + f is
// x[perm[p][s], t, f].
struct PermRows {
  const float* x;
  int T, F;
  int perm[kMaxPerm][kMaxS];
  // slot s of permutation p's row for tuple t: x[perm[p][s], t, :]
  __device__ __forceinline__ const float* slot(int p, int s, int t) const {
    return x + ((size_t)perm[p][s] * T + t) * F;
  }
};

// pos[p][s]: the place of slot s in permutation p (perm[p][pos[p][s]] = s).
struct PermPos {
  int pos[kMaxPerm][kMaxS];
};

// dz[r, o] = dy[r % T, o]: the output gradient of every permutation's row.
__global__ void __launch_bounds__(kThreads)
tile_rows_kernel(const float* __restrict__ dy, float* __restrict__ dz,
                 long long total, long long per_perm) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < total) dz[i] = dy[i % per_perm];
}

// tile_rows_kernel, also storing dz rounded to bf16 into dzh (rows of
// `cols` elements, ldh apart).
__global__ void __launch_bounds__(kThreads)
tile_rows_h_kernel(const float* __restrict__ dy, float* __restrict__ dz,
                   bf16* __restrict__ dzh, int ldh, int cols,
                   long long total, long long per_perm) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const float v = dy[i % per_perm];
  dz[i] = v;
  const long long m = i / cols;
  dzh[m * ldh + (i - m * cols)] = __float2bfloat16_rn(v);
}

PermRows perm_rows(const float* x, int s, int t, int f, const int* perms,
                   int n_perm) {
  PermRows pr;
  pr.x = x;
  pr.T = t;
  pr.F = f;
  for (int p = 0; p < kMaxPerm; ++p)
    for (int j = 0; j < kMaxS; ++j)
      pr.perm[p][j] = (p < n_perm && j < s) ? perms[p * s + j] : 0;
  return pr;
}

constexpr int kMaxLayers = 16;

bool bad_shape(int s, int n_perm, int n_layers) {
  return s < 1 || s > kMaxS || n_perm < 1 || n_perm > kMaxPerm ||
         n_layers < 1 || n_layers > kMaxLayers;
}

// Layer 0's LayerNorm of the permuted rows, one warp a tuple t. Its P
// permuted rows hold the same S*F elements, so they share the row mean and
// 1/std, computed once from x[:, t, :] (two passes, the mean and then the
// variance of the centred row, as row_moments) and written at each row
// r = p*T + t; then hn_0[r, :] = (row - mean) rstd g + b for every p, x
// addressed slot by slot (no division per element). x is read once from
// device memory, and hn_0 is stored once: layer 0's A operand in the
// forward and in the backward's dW1.
__global__ void __launch_bounds__(kThreads)
perm_ln_kernel(PermRows pr, int P, int S, const float* __restrict__ g,
               const float* __restrict__ b, float* __restrict__ mean,
               float* __restrict__ rstd, float* __restrict__ hn0) {
  const int t = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int T = pr.T, F = pr.F, L = S * F;
  if (t >= T) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* xr = pr.x + ((size_t)s * T + t) * F;
#pragma unroll 4
    for (int f = lane; f < F; f += 32) acc += xr[f];
  }
  const float mu = warp_sum(acc) / L;
  acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* xr = pr.x + ((size_t)s * T + t) * F;
#pragma unroll 4
    for (int f = lane; f < F; f += 32) {
      const float d = xr[f] - mu;
      acc += d * d;
    }
  }
  const float rs = rsqrtf(warp_sum(acc) / L + kLnEps);
  for (int p = 0; p < P; ++p) {
    const size_t r = (size_t)p * T + t;
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
    float* out = hn0 + r * L;
    for (int s = 0; s < S; ++s) {
      const float* xr = pr.slot(p, s, t);
#pragma unroll 4
      for (int f = lane; f < F; f += 32) {
        const int k = s * F + f;
        out[k] = (xr[f] - mu) * rs * g[k] + b[k];
      }
    }
  }
}

// perm_ln_kernel storing hn_0 rounded to bf16 alone, rows ldh apart.
__global__ void __launch_bounds__(kThreads)
perm_ln_h_kernel(PermRows pr, int P, int S, const float* __restrict__ g,
                 const float* __restrict__ b, float* __restrict__ mean,
                 float* __restrict__ rstd, bf16* __restrict__ hn0, int ldh) {
  const int t = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int T = pr.T, F = pr.F, L = S * F;
  if (t >= T) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* xr = pr.x + ((size_t)s * T + t) * F;
#pragma unroll 4
    for (int f = lane; f < F; f += 32) acc += xr[f];
  }
  const float mu = warp_sum(acc) / L;
  acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* xr = pr.x + ((size_t)s * T + t) * F;
#pragma unroll 4
    for (int f = lane; f < F; f += 32) {
      const float d = xr[f] - mu;
      acc += d * d;
    }
  }
  const float rs = rsqrtf(warp_sum(acc) / L + kLnEps);
  for (int p = 0; p < P; ++p) {
    const size_t r = (size_t)p * T + t;
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
    bf16* out = hn0 + r * ldh;
    for (int s = 0; s < S; ++s) {
      const float* xr = pr.slot(p, s, t);
#pragma unroll 4
      for (int f = lane; f < F; f += 32) {
        const int k = s * F + f;
        out[k] = __float2bfloat16_rn((xr[f] - mu) * rs * g[k] + b[k]);
      }
    }
  }
}

// Layer 0's LayerNorm backward through the permutation, with the forward's
// row statistics (L = S*F, xhat = (x - mean) rstd, dxhat = dy g):
//   dx = (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) rstd,
//   dg = sum over rows of dy xhat, db = sum over rows of dy.
// Pass 1, one warp a permuted row: its two means into ma, mb.
__global__ void __launch_bounds__(kThreads)
perm_ln_bwd_rows_kernel(const float* __restrict__ dy, PermRows pr,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ g, float* __restrict__ ma,
                        float* __restrict__ mb, int M, int S) {
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= M) return;
  const int F = pr.F, L = S * F;
  const int p = r / pr.T, t = r - p * pr.T;
  const float mu = mean[r], rs = rstd[r];
  const float* dyr = dy + (size_t)r * L;
  float a = 0.f, b = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* xr = pr.slot(p, s, t);
    for (int f = lane; f < F; f += 32) {
      const float dxh = dyr[s * F + f] * g[s * F + f];
      a += dxh;
      b += dxh * (xr[f] - mu) * rs;
    }
  }
  a = warp_sum(a) / L;
  b = warp_sum(b) / L;
  if (lane == 0) {
    ma[r] = a;
    mb[r] = b;
  }
}

// Pass 2, one thread a column (s, f) of x over chunks of 64 tuples: for
// each permutation p, the gradient at x[s, t, f]'s place in p's row, col[p]
// = pos[p][s]*F + f, summed over p into dx in permutation order (the
// permuted rows' gradient is never stored); and per p the chunk's partial
// sums of dy xhat (pg) and dy (pb) at col[p], slice chunk*P + p, added in
// slice order by sum_slices.
__global__ void __launch_bounds__(kThreads)
perm_ln_bwd_cols_kernel(const float* __restrict__ dy,
                        const float* __restrict__ x, PermPos pp,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ g,
                        const float* __restrict__ ma,
                        const float* __restrict__ mb, float* __restrict__ dx,
                        float* __restrict__ pg, float* __restrict__ pb, int P,
                        int S, int T, int F) {
  const int L = S * F;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= L) return;
  const int s = c / F, f = c - s * F;
  int col[kMaxPerm];
  float gk[kMaxPerm], sg[kMaxPerm], sb[kMaxPerm];
#pragma unroll
  for (int p = 0; p < kMaxPerm; ++p) {
    col[p] = p < P ? pp.pos[p][s] * F + f : 0;
    gk[p] = p < P ? g[col[p]] : 0.f;
    sg[p] = sb[p] = 0.f;
  }
  const int t0 = blockIdx.y * kColChunk, t1 = min(T, t0 + kColChunk);
  for (int t = t0; t < t1; ++t) {
    const size_t at = ((size_t)s * T + t) * F + f;
    const float xv = x[at];
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxPerm; ++p) {
      if (p < P) {
        const int r = p * T + t;
        const float rs = rstd[r];
        const float xhat = (xv - mean[r]) * rs;
        const float d = dy[(size_t)r * L + col[p]];
        acc += (d * gk[p] - ma[r] - xhat * mb[r]) * rs;
        sg[p] += d * xhat;
        sb[p] += d;
      }
    }
    dx[at] = acc;
  }
#pragma unroll
  for (int p = 0; p < kMaxPerm; ++p) {
    if (p < P) {
      const size_t at = ((size_t)blockIdx.y * P + p) * L + col[p];
      pg[at] = sg[p];
      pb[at] = sb[p];
    }
  }
}

int tuple_chunks(int t) { return t > 0 ? cdiv(t, kColChunk) : 1; }

// The two passes, then dg and db from their partials (2 x tuple_chunks(T)
// x P x L floats of `partial`): dx (S, T, F) directly.
int perm_layernorm_bwd(const float* dy, const PermRows& pr, const PermPos& pp,
                       int P, int S, const float* mean, const float* rstd,
                       const float* g, float* dx, float* dg, float* db,
                       float* ma, float* mb, float* partial,
                       cudaStream_t st) {
  const int T = pr.T, F = pr.F, L = S * F, M = P * T;
  if (M > 0)
    perm_ln_bwd_rows_kernel<<<cdiv(M, kWarps), kThreads, 0, st>>>(
        dy, pr, mean, rstd, g, ma, mb, M, S);
  RETURN_IF_ERR((int)cudaGetLastError());
  if (L == 0) return (int)cudaGetLastError();
  const int slices = tuple_chunks(T) * P;
  float* pb = partial + (size_t)slices * L;
  perm_ln_bwd_cols_kernel<<<dim3(cdiv(L, kThreads), tuple_chunks(T)),
                            kThreads, 0, st>>>(dy, pr.x, pp, mean, rstd, g,
                                               ma, mb, dx, partial, pb, P, S,
                                               T, F);
  RETURN_IF_ERR((int)cudaGetLastError());
  RETURN_IF_ERR(sum_slices(partial, dg, slices, L, st));
  return sum_slices(pb, db, slices, L, st);
}

// The forward's scratch, which the backward reads: layer 0's row mean and
// 1/std, then per layer i its input h_i (i >= 1; layer i-1's output), its
// normalised input hn_i (for layer 0 the permuted rows of x, normalised)
// and its activation e_i = elu(hn_i w1^T + c1); z, the last layer's output
// per permutation before their sum. In bf16 mode (h) also the bf16 copies
// of hn_i and e_i, and the weights w1, w2 in bf16, rows padded to 8
// elements; hn_0 in bf16 alone.
struct FwdLayout {
  size_t mean0, rstd0, h[kMaxLayers], hn[kMaxLayers], e[kMaxLayers], z,
      total;
  size_t hn_h[kMaxLayers], e_h[kMaxLayers], w1_h[kMaxLayers],
      w2_h[kMaxLayers];
};

// dims[3*i .. 3*i+2] = (in, hid, out) of layer i; n_layers <= kMaxLayers.
FwdLayout fwd_layout(long long rows, int n_layers, const int* dims, bool h) {
  FwdLayout l{};
  size_t o = 0;
  l.mean0 = carve(o, rows);
  l.rstd0 = carve(o, rows);
  for (int i = 0; i < n_layers; ++i) {
    const long long in = dims[3 * i], hid = dims[3 * i + 1];
    l.h[i] = i > 0 ? carve(o, rows * in) : 0;
    l.hn[i] = i > 0 || !h ? carve(o, rows * in) : 0;
    l.e[i] = carve(o, rows * hid);
  }
  l.z = carve(o, rows * dims[3 * (n_layers - 1) + 2]);
  for (int i = 0; h && i < n_layers; ++i) {
    const long long in = dims[3 * i], hid = dims[3 * i + 1],
                    out = dims[3 * i + 2];
    l.hn_h[i] = carve(o, h_floats(rows * pad8(in)));
    l.e_h[i] = carve(o, h_floats(rows * pad8(hid)));
    l.w1_h[i] = carve(o, h_floats(hid * pad8(in)));
    l.w2_h[i] = carve(o, h_floats(out * pad8(hid)));
  }
  l.total = o;
  return l;
}

// The backward's own scratch: the output and input gradients of the layer
// being walked; row statistics and reduction partials (column sums, or
// layer 0's LayerNorm backward's two at once). In bf16 mode also the bf16
// copies of the output gradient and of dt.
struct BwdLayout {
  size_t dout, dt, dhn, mean, rstd, wpart, cpart, total;
  size_t dout_h, dt_h;
};

BwdLayout bwd_layout(int n_perm, int t, int n_layers, const int* dims,
                     bool h) {
  const long long rows = (long long)n_perm * t;
  long long in_max = 0, hid = 0, out_max = 0, wmax = 0;
  for (int i = 0; i < n_layers; ++i) {
    const long long in = dims[3 * i], hd = dims[3 * i + 1],
                    out = dims[3 * i + 2];
    in_max = in > in_max ? in : in_max;
    hid = hd > hid ? hd : hid;
    out_max = out > out_max ? out : out_max;
    const long long w = (in > out ? in : out) * hd;
    wmax = w > wmax ? w : wmax;
  }
  const long long wide = in_max > out_max ? in_max : out_max;
  const long long sums = colsum_scratch(rows, wide > hid ? wide : hid),
                  ln0 = 2LL * tuple_chunks(t) * n_perm * dims[0];
  BwdLayout l{};
  size_t o = 0;
  l.dout = carve(o, rows * out_max);   // in_i = out_{i-1} for i >= 1
  l.dt = carve(o, rows * hid);
  l.dhn = carve(o, rows * in_max);
  l.mean = carve(o, rows);
  l.rstd = carve(o, rows);
  l.wpart = carve(o, kMaxSplits * wmax);
  l.cpart = carve(o, sums > ln0 ? sums : ln0);
  if (h) {
    l.dout_h = carve(o, h_floats(rows * pad8(out_max)));
    l.dt_h = carve(o, h_floats(rows * pad8(hid)));
  }
  l.total = o;
  return l;
}

// The forward in bf16 mode: every product on wg_gemm.cuh, into the scratch
// (z last); the caller sums z over the permutations.
int sym_fwd_bf16(const float* x, int s, int t, int f, const int* perms,
                 int n_perm, const float* const* params, const int* dims,
                 int n_layers, float* scratch, cudaStream_t st) {
  const int rows = n_perm * t;
  const FwdLayout l = fwd_layout(rows, n_layers, dims, true);
  ToBf16 casts[2 * kMaxLayers];
  for (int i = 0; i < n_layers; ++i) {
    const int in = dims[3 * i], hid = dims[3 * i + 1], out = dims[3 * i + 2];
    casts[2 * i] = cast_of(params[6 * i + 2], as_h(scratch, l.w1_h[i]), hid,
                           in, pad8(in));
    casts[2 * i + 1] = cast_of(params[6 * i + 4], as_h(scratch, l.w2_h[i]),
                               out, hid, pad8(hid));
  }
  RETURN_IF_ERR(to_bf16(casts, 2 * n_layers, st));
  if (t > 0)
    perm_ln_h_kernel<<<cdiv(t, kWarps), kThreads, 0, st>>>(
        perm_rows(x, s, t, f, perms, n_perm), n_perm, s, params[0],
        params[1], scratch + l.mean0, scratch + l.rstd0,
        as_h(scratch, l.hn_h[0]), pad8(s * f));
  RETURN_IF_ERR((int)cudaGetLastError());
  for (int i = 0; i < n_layers; ++i) {
    const float* const* p = params + 6 * i;
    const int in = dims[3 * i], hid = dims[3 * i + 1], out = dims[3 * i + 2];
    const int ih = pad8(in), hh = pad8(hid);
    const bool last = i == n_layers - 1;
    bf16 *hn_h = as_h(scratch, l.hn_h[i]), *e_h = as_h(scratch, l.e_h[i]);
    Out o = out_to(scratch + (last ? l.z : l.h[i + 1]), out);
    o.bias = p[5];
    if (i > 0) {
      float* hn = scratch + l.hn[i];
      RETURN_IF_ERR(layernorm_h(scratch + l.h[i], hn, hn_h, ih, p[0], p[1],
                                rows, in, st));
      if (!last) {
        o.R = hn;
        o.ldr = in;
      }
    }
    RETURN_IF_ERR(wg_gemm(MatH{hn_h, ih}, MatH{as_h(scratch, l.w1_h[i]), ih},
                          EluOutH{p[3], scratch + l.e[i], hid, e_h, hh}, rows,
                          hid, in, st));
    RETURN_IF_ERR(wg_gemm(MatH{e_h, hh}, MatH{as_h(scratch, l.w2_h[i]), hh},
                          o, rows, out, hid, st));
  }
  return 0;
}

}  // namespace

extern "C" {

// Floats of the forward's scratch (FwdLayout) in the mode mm_bf16; -1
// above kMaxLayers. The backward reads it: keep the scratch until it has
// run.
long long grappa_fused_symmetriser_scratch(int n_perm, int t, int n_layers,
                                           const int* dims, int mm_bf16) {
  if (n_layers < 1 || n_layers > kMaxLayers) return -1;
  return (long long)fwd_layout((long long)n_perm * t, n_layers, dims,
                               mm_bf16)
      .total;
}

// x: (S, T, F); perms: n_perm x S host ints; params: host array of
// 6 * n_layers device pointers (g, b, w1, c1, w2, c2 per layer, weights in
// torch layout (out, in)); dims: host (in, hid, out) per layer; y: (T, out).
// mm_bf16: the 2 x n_layers products on wg_gemm.cuh's bf16 wgmma (operands
// rounded to bf16, float32 sums), the JAX kernel's mm_dtype=bfloat16;
// LayerNorms, elu, the skips and the sum over permutations stay float32.
int grappa_fused_symmetriser_fwd(const float* x, int s, int t, int f,
                                 const int* perms, int n_perm,
                                 const float* const* params, const int* dims,
                                 int n_layers, float* scratch, float* y,
                                 int mm_bf16, void* stream) {
  if (bad_shape(s, n_perm, n_layers)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = n_perm * t;
  const FwdLayout l = fwd_layout(rows, n_layers, dims, mm_bf16);
  const long long z_cols = (long long)t * dims[3 * (n_layers - 1) + 2];
  if (mm_bf16) {
    RETURN_IF_ERR(sym_fwd_bf16(x, s, t, f, perms, n_perm, params, dims,
                               n_layers, scratch, st));
    return sum_slices(scratch + l.z, y, n_perm, z_cols, st);
  }
  if (t > 0)
    perm_ln_kernel<<<cdiv(t, kWarps), kThreads, 0, st>>>(
        perm_rows(x, s, t, f, perms, n_perm), n_perm, s, params[0],
        params[1], scratch + l.mean0, scratch + l.rstd0, scratch + l.hn[0]);
  RETURN_IF_ERR((int)cudaGetLastError());

  for (int i = 0; i < n_layers; ++i) {
    const float* const* p = params + 6 * i;
    const int in = dims[3 * i], hid = dims[3 * i + 1], out = dims[3 * i + 2];
    const bool last = i == n_layers - 1;
    const bool skip = i > 0 && !last;
    float* e = scratch + l.e[i];
    float* hn = scratch + l.hn[i];
    if (i > 0)
      RETURN_IF_ERR(layernorm(scratch + l.h[i], in, hn, in, p[0], p[1], rows,
                              in, st));
    RETURN_IF_ERR(tc_gemm(Mat{hn, in}, p[2], in, p[3], nullptr, 0, e, hid,
                          rows, hid, in, true, st));
    float* dst = scratch + (last ? l.z : l.h[i + 1]);
    RETURN_IF_ERR(tc_gemm(Mat{e, hid}, p[4], hid, p[5], skip ? hn : nullptr,
                          in, dst, out, rows, out, hid, false, st));
  }
  return sum_slices(scratch + l.z, y, n_perm, z_cols, st);
}

long long grappa_fused_symmetriser_bwd_scratch(int n_perm, int t,
                                               int n_layers,
                                               const int* dims,
                                               int mm_bf16) {
  if (n_layers < 1 || n_layers > kMaxLayers) return -1;
  return (long long)bwd_layout(n_perm, t, n_layers, dims, mm_bf16).total;
}

// Gradients of the forward above for dy (T, out): dx (S, T, F) and, in
// grads (6 * n_layers device pointers, the order of params), every
// parameter gradient summed over the permutations. `fwd` is the forward's
// scratch from the same inputs and mode, read only; the linear biases are
// not read. mm_bf16: every layer's four products on wg_gemm.cuh's bf16
// wgmma, both operands rounded to bf16 (dy's descendants too), float32
// sums, as the JAX kernel's _dot_tn / _dot_nt with mm_dtype=bfloat16;
// column sums and LayerNorm backward stay float32, as there.
int grappa_fused_symmetriser_bwd(const float* x, int s, int t, int f,
                                 const int* perms, int n_perm,
                                 const float* const* params, const int* dims,
                                 int n_layers, const float* dy,
                                 const float* fwd, float* scratch, float* dx,
                                 float* const* grads, int mm_bf16,
                                 void* stream) {
  if (bad_shape(s, n_perm, n_layers)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = n_perm * t;
  const FwdLayout lf = fwd_layout(rows, n_layers, dims, mm_bf16);
  const BwdLayout l = bwd_layout(n_perm, t, n_layers, dims, mm_bf16);
  float* q = scratch;
  float *dout = q + l.dout, *dt = q + l.dt, *dhn = q + l.dhn,
        *mean = q + l.mean, *rstd = q + l.rstd, *wpart = q + l.wpart,
        *cpart = q + l.cpart;
  bf16 *dout_h = as_h(q, l.dout_h), *dt_h = as_h(q, l.dt_h);
  const PermRows pr = perm_rows(x, s, t, f, perms, n_perm);
  PermPos pp;
  for (int p = 0; p < kMaxPerm; ++p)
    for (int j = 0; j < kMaxS; ++j) pp.pos[p][j] = 0;
  for (int p = 0; p < n_perm; ++p)
    for (int j = 0; j < s; ++j) pp.pos[p][perms[p * s + j]] = j;

  const float *mean0 = fwd + lf.mean0, *rstd0 = fwd + lf.rstd0;
  // every permutation's output row gets dy
  const int out_last = dims[3 * (n_layers - 1) + 2];
  const long long total = (long long)rows * out_last;
  if (total > 0 && mm_bf16)
    tile_rows_h_kernel<<<cdiv(total, kThreads), kThreads, 0, st>>>(
        dy, dout, dout_h, pad8(out_last), out_last, total,
        (long long)t * out_last);
  else if (total > 0)
    tile_rows_kernel<<<cdiv(total, kThreads), kThreads, 0, st>>>(
        dy, dout, total, (long long)t * out_last);
  RETURN_IF_ERR((int)cudaGetLastError());

  // layer i's products, from dout (its output's gradient) to dhn (its
  // normalised input's), its weight and bias gradients on the way
  auto products = [&](int i) {
    const float* const* p = params + 6 * i;
    float* const* g = grads + 6 * i;
    const int in = dims[3 * i], hid = dims[3 * i + 1], out = dims[3 * i + 2];
    const bool skip = i > 0 && i < n_layers - 1;
    const float* e = fwd + lf.e[i];
    const float* hn = fwd + lf.hn[i];
    // out = e_i w2^T + c2 (+ hn_i), e_i = elu(t_i)
    RETURN_IF_ERR(tc_gemm_wgrad(tr(Mat{dout, out}), tr(Mat{e, hid}), g[4],
                                out, hid, rows, wpart, st));
    RETURN_IF_ERR(colsum(Mat{dout, out}, g[5], rows, out, cpart, st));
    RETURN_IF_ERR(tc_gemm(Mat{dout, out}, tr(Mat{p[4], hid}),
                          EluGradOut{dt, hid, e, hid}, rows, hid, out, st));
    // t_i = hn_i w1^T + c1
    RETURN_IF_ERR(tc_gemm_wgrad(tr(Mat{dt, hid}), tr(Mat{hn, in}), g[2], hid,
                                in, rows, wpart, st));
    RETURN_IF_ERR(colsum(Mat{dt, hid}, g[3], rows, hid, cpart, st));
    Out o = out_to(dhn, in);
    if (skip) {
      o.R = dout;
      o.ldr = out;
    }
    return tc_gemm(Mat{dt, hid}, tr(Mat{p[2], in}), o, rows, in, hid, st);
  };
  // the same on wg_gemm.cuh from the bf16 copies: dout_h, the forward's
  // e_h, hn_h and weights; the elu' epilogue writes dt in both types
  auto products_h = [&](int i) {
    float* const* g = grads + 6 * i;
    const int in = dims[3 * i], hid = dims[3 * i + 1], out = dims[3 * i + 2];
    const int ih = pad8(in), hh = pad8(hid), oh = pad8(out);
    const bool skip = i > 0 && i < n_layers - 1;
    const bf16 *e_h = as_h(fwd, lf.e_h[i]), *hn_h = as_h(fwd, lf.hn_h[i]),
               *w1_h = as_h(fwd, lf.w1_h[i]), *w2_h = as_h(fwd, lf.w2_h[i]);
    RETURN_IF_ERR(wg_gemm_wgrad(tr(MatH{dout_h, oh}), tr(MatH{e_h, hh}), g[4],
                                out, hid, rows, wpart, st));
    RETURN_IF_ERR(colsum(Mat{dout, out}, g[5], rows, out, cpart, st));
    RETURN_IF_ERR(wg_gemm(MatH{dout_h, oh}, tr(MatH{w2_h, hh}),
                          EluGradOutH{dt, hid, fwd + lf.e[i], hid, dt_h, hh},
                          rows, hid, out, st));
    RETURN_IF_ERR(wg_gemm_wgrad(tr(MatH{dt_h, hh}), tr(MatH{hn_h, ih}), g[2],
                                hid, in, rows, wpart, st));
    RETURN_IF_ERR(colsum(Mat{dt, hid}, g[3], rows, hid, cpart, st));
    Out o = out_to(dhn, in);
    if (skip) {
      o.R = dout;
      o.ldr = out;
    }
    return wg_gemm(MatH{dt_h, hh}, tr(MatH{w1_h, ih}), o, rows, in, hid, st);
  };
  for (int i = n_layers - 1; i >= 0; --i) {
    const float* const* p = params + 6 * i;
    float* const* g = grads + 6 * i;
    const int in = dims[3 * i];
    RETURN_IF_ERR(mm_bf16 ? products_h(i) : products(i));
    // hn_i = LN(h_i); h_i is the previous layer's output (for layer 0, the
    // permuted row of x, whose gradient goes straight into dx)
    if (i == 0)
      return perm_layernorm_bwd(dhn, pr, pp, n_perm, s, mean0, rstd0, p[0],
                                dx, g[0], g[1], mean, rstd, cpart, st);
    RETURN_IF_ERR(layernorm_bwd(dhn, Mat{fwd + lf.h[i], in}, p[0], dout, g[0],
                                g[1], rows, in, mean, rstd, cpart, st));
    if (mm_bf16) {
      const ToBf16 cast = cast_of(dout, dout_h, rows, in, pad8(in));
      RETURN_IF_ERR(to_bf16(&cast, 1, st));
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
