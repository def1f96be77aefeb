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
// (4, 512) tuple and 2 permutations, bound by operations at the 67 TFLOP/s
// fp32 peak outside the tensor cores. The backward's own work is twice
// that; this design also recomputes the chain, 3x. At the 128-molecule
// training batch the four heads' calls are 56 GFLOP forward (0.83 ms at
// the peak) and 111 GFLOP backward (1.67 ms).
//
// Design (bring-up, right before fast): all P permutations run as one batch
// of P*T rows. The first layer's rows are never stored permuted: a
// statistics pass computes each permuted row's mean and 1/std by addressing
// the S planes of x through the permutation, and the first GEMM's A loader
// forms the normalised row element by element from those planes. Later
// layers are LayerNorm + two GEMMs each (elu and the skip residual in the
// GEMM epilogues); a last pass sums the P row blocks in permutation order.
// The backward recomputes each layer's input, normalised input and
// pre-activation, then walks the chain back: dW = dY^T X over all P*T rows
// in split-K slices (so the sum over permutations is part of the product,
// in a fixed order), dX = dY W with elu' or the skip in the epilogue, a
// LayerNorm backward per layer (the first one reads x through the
// permutation), and a last pass that adds each permuted row's gradient back
// into the S planes of dx in permutation order -- no permuted copy, no
// atomics.
#include "common.cuh"

namespace {

constexpr int kMaxPerm = 6;
constexpr int kMaxS = 4;

// Row r = p*T + t of the permuted flattening: element k is
// x[perm[p][k / F], t, k % F].
struct PermRows {
  const float* x;
  int T, F;
  int perm[kMaxPerm][kMaxS];
  static constexpr bool kAlongK = true;
  __device__ __forceinline__ float operator()(int r, int k) const {
    const int p = r / T, t = r - p * T;
    const int s = k / F, f = k - s * F;
    return x[((size_t)perm[p][s] * T + t) * F + f];
  }
};

// The first layer's A operand: LayerNorm of the permuted row, formed on load.
struct PermLNLoad {
  PermRows rows;
  const float* mean;
  const float* rstd;
  const float* g;
  const float* b;
  static constexpr bool kAlongK = true;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return (rows(r, k) - mean[r]) * rstd[r] * g[k] + b[k];
  }
};

// dx[s, t, f] = sum_p dflat[p*T + t, pos[p][s]*F + f] in permutation order,
// pos[p][s] being the place of slot s in permutation p.
struct PermPos {
  int pos[kMaxPerm][kMaxS];
};

__global__ void __launch_bounds__(kThreads)
perm_scatter_kernel(const float* __restrict__ dflat, float* __restrict__ dx,
                    PermPos pp, int P, int S, int T, int F) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long total = (long long)S * T * F;
  if (i >= total) return;
  const int f = (int)(i % F);
  const int t = (int)((i / F) % T);
  const int s = (int)(i / ((long long)F * T));
  const size_t width = (size_t)S * F;
  float acc = 0.f;
  for (int p = 0; p < P; ++p)
    acc += dflat[((size_t)p * T + t) * width + pp.pos[p][s] * F + f];
  dx[i] = acc;
}

// dz[r, o] = dy[r % T, o]: the output gradient of every permutation's row.
__global__ void __launch_bounds__(kThreads)
tile_rows_kernel(const float* __restrict__ dy, float* __restrict__ dz,
                 long long total, long long per_perm) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < total) dz[i] = dy[i % per_perm];
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

bool bad_shape(int s, int n_perm, int n_layers) {
  return s < 1 || s > kMaxS || n_perm < 1 || n_perm > kMaxPerm ||
         n_layers < 1;
}

struct Layout {
  size_t mean, rstd, e, h, hn, z, total;
};

// dims[3*i .. 3*i+2] = (in, hid, out) of layer i.
Layout layout(long long rows, int n_layers, const int* dims) {
  long long hid = 0, mid = 0, in_later = 0;
  for (int i = 0; i < n_layers; ++i) {
    hid = dims[3 * i + 1] > hid ? dims[3 * i + 1] : hid;
    if (i < n_layers - 1 && dims[3 * i + 2] > mid) mid = dims[3 * i + 2];
    if (i > 0 && dims[3 * i] > in_later) in_later = dims[3 * i];
  }
  Layout l;
  l.mean = 0;
  l.rstd = l.mean + rows;
  l.e = l.rstd + rows;
  l.h = l.e + rows * hid;
  l.hn = l.h + rows * mid;
  l.z = l.hn + rows * in_later;
  l.total = l.z + rows * dims[3 * (n_layers - 1) + 2];
  return l;
}

// Backward scratch: the forward's per-layer input h_i, normalised input
// hn_i (layers >= 1) and pre-activation t_i (every layer), then the
// gradient buffers, row statistics and reduction partials.
struct BwdLayout {
  size_t layer[16][3];      // offsets of h_i, hn_i, t_i (layers < 16)
  size_t mean0, rstd0, mean, rstd, dout, dt, dhn, dflat, wpart, cpart, total;
};

constexpr int kMaxLayers = 16;

BwdLayout bwd_layout(long long rows, int s, int f, int n_layers,
                     const int* dims) {
  BwdLayout l;
  size_t o = 0;
  long long wide = (long long)s * f, hid = 0, wmax = 0;
  for (int i = 0; i < n_layers; ++i) {
    const long long in = dims[3 * i], hd = dims[3 * i + 1],
                    out = dims[3 * i + 2];
    l.layer[i][0] = o;
    l.layer[i][1] = o;
    if (i > 0) {
      o += rows * in;
      l.layer[i][1] = o;
      o += rows * in;
    }
    l.layer[i][2] = o;
    o += rows * hd;
    hid = hd > hid ? hd : hid;
    wide = in > wide ? in : wide;
    wide = out > wide ? out : wide;
    const long long w = (in > out ? in : out) * hd;
    wmax = w > wmax ? w : wmax;
  }
  l.mean0 = o; o += rows;
  l.rstd0 = o; o += rows;
  l.mean = o; o += rows;
  l.rstd = o; o += rows;
  l.dout = o; o += rows * wide;
  l.dt = o; o += rows * hid;
  l.dhn = o; o += rows * wide;
  l.dflat = o; o += rows * (long long)s * f;
  l.wpart = o; o += kMaxSplits * wmax;
  l.cpart = o; o += colsum_scratch(rows, wide > hid ? wide : hid);
  l.total = o;
  return l;
}

}  // namespace

extern "C" {

long long grappa_fused_symmetriser_scratch(int n_perm, int t, int n_layers,
                                           const int* dims) {
  return (long long)layout((long long)n_perm * t, n_layers, dims).total;
}

// x: (S, T, F); perms: n_perm x S host ints; params: host array of
// 6 * n_layers device pointers (g, b, w1, c1, w2, c2 per layer, weights in
// torch layout (out, in)); dims: host (in, hid, out) per layer; y: (T, out).
int grappa_fused_symmetriser_fwd(const float* x, int s, int t, int f,
                                 const int* perms, int n_perm,
                                 const float* const* params, const int* dims,
                                 int n_layers, float* scratch, float* y,
                                 void* stream) {
  if (bad_shape(s, n_perm, n_layers)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = n_perm * t;
  const Layout l = layout(rows, n_layers, dims);
  float* mean = scratch + l.mean;
  float* rstd = scratch + l.rstd;
  float* e = scratch + l.e;
  float* h = scratch + l.h;
  float* hn = scratch + l.hn;
  float* z = scratch + l.z;
  const PermRows pr = perm_rows(x, s, t, f, perms, n_perm);
  RETURN_IF_ERR(row_stats(pr, mean, rstd, rows, s * f, st));

  for (int i = 0; i < n_layers; ++i) {
    const float* const* p = params + 6 * i;
    const int in = dims[3 * i], hid = dims[3 * i + 1], out = dims[3 * i + 2];
    const bool last = i == n_layers - 1;
    const bool skip = i > 0 && !last;
    float* dst = last ? z : h;
    if (i == 0) {
      PermLNLoad a{pr, mean, rstd, p[0], p[1]};
      RETURN_IF_ERR(gemm(a, p[2], in, p[3], nullptr, 0, e, hid, rows, hid,
                         in, true, st));
    } else {
      // h is consumed here, so the second GEMM may overwrite it below
      RETURN_IF_ERR(layernorm(h, in, hn, in, p[0], p[1], rows, in, st));
      RETURN_IF_ERR(gemm(Mat{hn, in}, p[2], in, p[3], nullptr, 0, e, hid,
                         rows, hid, in, true, st));
    }
    RETURN_IF_ERR(gemm(Mat{e, hid}, p[4], hid, p[5], skip ? hn : nullptr, in,
                       dst, out, rows, out, hid, false, st));
  }
  return sum_slices(z, y, n_perm, (long long)t * dims[3 * (n_layers - 1) + 2],
                    st);
}

long long grappa_fused_symmetriser_bwd_scratch(int s, int f, int n_perm,
                                               int t, int n_layers,
                                               const int* dims) {
  if (n_layers > kMaxLayers) return -1;
  return (long long)bwd_layout((long long)n_perm * t, s, f, n_layers, dims)
      .total;
}

// Gradients of the forward above for dy (T, out): dx (S, T, F) and, in
// grads (6 * n_layers device pointers, the order of params), every
// parameter gradient summed over the permutations.
int grappa_fused_symmetriser_bwd(const float* x, int s, int t, int f,
                                 const int* perms, int n_perm,
                                 const float* const* params, const int* dims,
                                 int n_layers, const float* dy,
                                 float* scratch, float* dx,
                                 float* const* grads, void* stream) {
  if (bad_shape(s, n_perm, n_layers) || n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = n_perm * t;
  const BwdLayout l = bwd_layout(rows, s, f, n_layers, dims);
  float* q = scratch;
  float *mean0 = q + l.mean0, *rstd0 = q + l.rstd0, *mean = q + l.mean,
        *rstd = q + l.rstd, *dout = q + l.dout, *dt = q + l.dt,
        *dhn = q + l.dhn, *dflat = q + l.dflat, *wpart = q + l.wpart,
        *cpart = q + l.cpart;
  const PermRows pr = perm_rows(x, s, t, f, perms, n_perm);
  const PermLNLoad ln0{pr, mean0, rstd0, params[0], params[1]};

  // recompute: h_i (i >= 1), hn_i (i >= 1) and t_i
  RETURN_IF_ERR(row_stats(pr, mean0, rstd0, rows, s * f, st));
  for (int i = 0; i < n_layers; ++i) {
    const float* const* p = params + 6 * i;
    const int in = dims[3 * i], hid = dims[3 * i + 1], out = dims[3 * i + 2];
    float* hn = q + l.layer[i][1];
    float* ti = q + l.layer[i][2];
    if (i == 0) {
      RETURN_IF_ERR(gemm(ln0, p[2], in, p[3], nullptr, 0, ti, hid, rows, hid,
                         in, false, st));
    } else {
      RETURN_IF_ERR(gemm(Mat{hn, in}, p[2], in, p[3], nullptr, 0, ti, hid,
                         rows, hid, in, false, st));
    }
    if (i == n_layers - 1) break;
    // h_{i+1} = elu(t_i) w2^T + c2 (+ hn_i on the middle layers), then LN
    const bool skip = i > 0;
    float* hnext = q + l.layer[i + 1][0];
    RETURN_IF_ERR(gemm(Elu<Mat>{Mat{ti, hid}}, p[4], hid, p[5],
                       skip ? hn : nullptr, in, hnext, out, rows, out, hid,
                       false, st));
    const float* const* pn = params + 6 * (i + 1);
    RETURN_IF_ERR(layernorm(hnext, out, q + l.layer[i + 1][1], out, pn[0],
                            pn[1], rows, out, st));
  }

  // every permutation's output row gets dy
  const int out_last = dims[3 * (n_layers - 1) + 2];
  const long long total = (long long)rows * out_last;
  if (total > 0)
    tile_rows_kernel<<<cdiv(total, kThreads), kThreads, 0, st>>>(
        dy, dout, total, (long long)t * out_last);
  RETURN_IF_ERR((int)cudaGetLastError());

  for (int i = n_layers - 1; i >= 0; --i) {
    const float* const* p = params + 6 * i;
    float* const* g = grads + 6 * i;
    const int in = dims[3 * i], hid = dims[3 * i + 1], out = dims[3 * i + 2];
    const bool skip = i > 0 && i < n_layers - 1;
    const float* ti = q + l.layer[i][2];
    // out = elu(t_i) w2^T + c2 (+ hn_i)
    RETURN_IF_ERR(gemm_wgrad(tr(Mat{dout, out}), tr(Elu<Mat>{Mat{ti, hid}}),
                             g[4], out, hid, rows, wpart, st));
    RETURN_IF_ERR(colsum(Mat{dout, out}, g[5], rows, out, cpart, st));
    Out o = out_to(dt, hid);
    o.gate = ti;
    o.ldg = hid;
    RETURN_IF_ERR(gemm(Mat{dout, out}, tr(Mat{p[4], hid}), o, rows, hid, out,
                       st));
    // t_i = hn_i w1^T + c1
    if (i == 0)
      RETURN_IF_ERR(gemm_wgrad(tr(Mat{dt, hid}), tr(ln0), g[2], hid, in, rows,
                               wpart, st));
    else
      RETURN_IF_ERR(gemm_wgrad(tr(Mat{dt, hid}), tr(Mat{q + l.layer[i][1],
                                                          in}),
                               g[2], hid, in, rows, wpart, st));
    RETURN_IF_ERR(colsum(Mat{dt, hid}, g[3], rows, hid, cpart, st));
    o = out_to(dhn, in);
    if (skip) {
      o.R = dout;
      o.ldr = out;
    }
    RETURN_IF_ERR(gemm(Mat{dt, hid}, tr(Mat{p[2], in}), o, rows, in, hid,
                       st));
    // hn_i = LN(h_i); h_i is the previous layer's output (or, for layer 0,
    // the permuted row of x)
    if (i > 0)
      RETURN_IF_ERR(layernorm_bwd(dhn, Mat{q + l.layer[i][0], in}, p[0], dout,
                                  g[0], g[1], rows, in, mean, rstd, cpart,
                                  st));
    else
      RETURN_IF_ERR(layernorm_bwd(dhn, pr, p[0], dflat, g[0], g[1], rows, in,
                                  mean, rstd, cpart, st));
  }

  PermPos pp;
  for (int p = 0; p < kMaxPerm; ++p)
    for (int j = 0; j < kMaxS; ++j) pp.pos[p][j] = 0;
  for (int p = 0; p < n_perm; ++p)
    for (int j = 0; j < s; ++j) pp.pos[p][perms[p * s + j]] = j;
  const long long n = (long long)s * t * f;
  if (n > 0)
    perm_scatter_kernel<<<cdiv(n, kThreads), kThreads, 0, st>>>(
        dflat, dx, pp, n_perm, s, t, f);
  return (int)cudaGetLastError();
}

}  // extern "C"
