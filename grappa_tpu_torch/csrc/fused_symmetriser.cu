// K3: the Symmetriser on x (S, T, F) -> (T, out), forward.
//
// Replaces the Pallas kernel grappa_tpu/ops/fused_symmetriser.py::
// fused_symmetriser (forward: _fwd -> _fwd_kernel -> _ff_chain_fwd): for
// each symmetry permutation, the permuted flattening (T, S*F) of the tuple
// features, then an n-layer FeedForward chain (pre-LN, elu hidden layer,
// skip adding the normalised input on the middle layers only); the outputs
// are summed over the permutations.
//
// Bound on an H100 SXM: at the proper-torsion serving shape (S=4, T=2152,
// F=512, width 256, 3 layers, 2 permutations) the products are
// 2*P*T*(S*F*256 + 256*256 + 2*256*256 + 256*256 + 256*12) = 10 GFLOP
// against ~20 MB of input and weights: bound by operations, about 0.15 ms
// at the 67 TFLOP/s fp32 peak outside the tensor cores.
//
// Design (bring-up, right before fast): all P permutations run as one
// batch of P*T rows. The first layer's rows are never stored permuted: a
// statistics pass computes each permuted row's mean and 1/std by addressing
// the S planes of x through the permutation, and the first GEMM's A loader
// forms the normalised row element by element from those planes. Later
// layers are LayerNorm + two GEMMs each (elu and the skip residual in the
// GEMM epilogues); a last pass sums the P row blocks in permutation order.
// 3 * n_layers + 1 launches; the ragged T edge is masked, nothing padded.
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
  __device__ __forceinline__ float operator()(int r, int k) const {
    return (rows(r, k) - mean[r]) * rstd[r] * g[k] + b[k];
  }
};

__global__ void __launch_bounds__(kThreads)
perm_row_stats_kernel(PermRows rows, float* __restrict__ mean,
                      float* __restrict__ rstd, int M, int L) {
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= M) return;
  float s = 0.f;
  for (int j = lane; j < L; j += 32) s += rows(r, j);
  const float mu = warp_sum(s) / L;
  float v = 0.f;
  for (int j = lane; j < L; j += 32) {
    const float d = rows(r, j) - mu;
    v += d * d;
  }
  v = warp_sum(v) / L;
  if (lane == 0) {
    mean[r] = mu;
    rstd[r] = rsqrtf(v + kLnEps);
  }
}

// y[t, o] = sum_p z[p*T + t, o], in permutation order.
__global__ void __launch_bounds__(kThreads)
perm_sum_kernel(const float* __restrict__ z, float* __restrict__ y, int P,
                int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc = z[i];
  for (int p = 1; p < P; ++p) acc += z[(size_t)p * n + i];
  y[i] = acc;
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
  if (s < 1 || s > kMaxS || n_perm < 1 || n_perm > kMaxPerm || n_layers < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = n_perm * t;
  const Layout l = layout(rows, n_layers, dims);
  float* mean = scratch + l.mean;
  float* rstd = scratch + l.rstd;
  float* e = scratch + l.e;
  float* h = scratch + l.h;
  float* hn = scratch + l.hn;
  float* z = scratch + l.z;

  PermRows pr;
  pr.x = x;
  pr.T = t;
  pr.F = f;
  for (int p = 0; p < kMaxPerm; ++p)
    for (int j = 0; j < kMaxS; ++j)
      pr.perm[p][j] = (p < n_perm && j < s) ? perms[p * s + j] : 0;

  if (rows > 0)
    perm_row_stats_kernel<<<cdiv(rows, kWarps), kThreads, 0, st>>>(
        pr, mean, rstd, rows, s * f);
  RETURN_IF_ERR((int)cudaGetLastError());

  for (int i = 0; i < n_layers; ++i) {
    const float* const* p = params + 6 * i;
    const int in = dims[3 * i], hid = dims[3 * i + 1], out = dims[3 * i + 2];
    const bool last = i == n_layers - 1;
    const bool skip = i > 0 && !last;
    float* dst = last ? z : h;
    if (i == 0) {
      PermLNLoad a{pr, mean, rstd, p[0], p[1]};
      RETURN_IF_ERR(gemm(a, p[2], in, p[3], nullptr, 0, e, hid, rows, hid,
                         in, true, false, st));
    } else {
      // h is consumed here, so the second GEMM may overwrite it below
      RETURN_IF_ERR(layernorm(h, in, hn, in, p[0], p[1], rows, in, st));
      RETURN_IF_ERR(gemm(PlainLoad{hn, in}, p[2], in, p[3], nullptr, 0, e,
                         hid, rows, hid, in, true, false, st));
    }
    RETURN_IF_ERR(gemm(PlainLoad{e, hid}, p[4], hid, p[5],
                       skip ? hn : nullptr, in, dst, out, rows, out, hid,
                       false, false, st));
  }

  const int n = t * dims[3 * (n_layers - 1) + 2];
  if (n > 0)
    perm_sum_kernel<<<cdiv(n, kThreads), kThreads, 0, st>>>(z, y, n_perm, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
