// K5: fused dihedral + periodic-torsion energy, pos (T, 4, 3, C) and signed
// k (T, P) -> energy (T, C); K5b: its backward, (pos, k, g) -> dpos
// (T, 4, 3, C) and, when asked, dk (T, P).
//
// K5 replaces the Pallas kernel grappa_tpu/ops/torsion_kernel.py::
// _forward_pallas (_torsion_tile_kernel): for each tuple and conformer the
// dihedral of the four gathered positions around the x1-x2 axis, then
// sum_n k_n cos(n phi), n = 1..P. Trig-free: cos phi = x rsqrt(x^2 + y^2)
// with x = n1.n2 and y = (n1 x n2).r21 / sqrt(|r21|^2 + 1e-12), and
// cos(n phi) from the Chebyshev recurrence T_(n+1) = 2 cos phi T_n -
// T_(n-1). A degenerate tuple (x^2 + y^2 < 1e-12, e.g. all four atoms at
// one point) takes cos phi = 1, as atan2's guard in the plain version gives
// phi = 0. Masked or padded tuples carry zeroed k rows, so they come out as
// 0.
//
// K5b replaces the JAX package's backward of the same op (_bwd, the vjp of
// _energy_jnp run as one XLA program): the gradient of the expression K5
// evaluates, differentiated by hand through the same steps, so its epsilon
// and its degenerate guard are those of the plain vjp:
//   dE/dphi = -sum_n n k_n sin(n phi), sin(n phi) = sin phi U_(n-1)(cos phi)
//   (U the Chebyshev polynomials of the second kind, a recurrence in
//   registers beside T's: no trig), sin phi = y / sqrt(r2);
//   atan2: dphi/dx = -y / r2, dphi/dy = x / r2;
//   then back through y = m.u (u = r21 / sqrt(|r21|^2 + 1e-12), m = n1 x n2),
//   x = n1.n2 and the cross products n1 = r01 x r21, n2 = r21 x r23 to the
//   12 coordinates. A degenerate tuple gets a zero gradient (the guard
//   selects constants, as _safe_atan2 does). dk[t, n] = sum_c g[t, c]
//   cos((n+1) phi[t, c]), summed in a fixed order with no atomics.
//
// Bounds on an H100 SXM (3.35 TB/s; about 70 FLOP an element forward and
// 250 backward never set them: 250 x 772,352 elements is 0.2 GFLOP, 3 us at
// the 67 TFLOP/s fp32 rate):
// - K5: each position read once and each energy written once, 4 (12 T C +
//   T P + T C) bytes: 13.9 MB and 4.2 us for the 128-molecule training
//   batch's propers (T=8256, C=32, P=6), 4.7 MB and 1.4 us for a
//   12,000-atom protein's propers (T=20096, C=4).
// - K5b: pos, k and g read once, dpos written once, 4 (25 T C + T P)
//   bytes (+ 4 T P with dk): 28 MB and 8.3 us for the 40,000-atom
//   propers (T=66304, C=4), 80 MB and 24 us summed over the six main-path
//   shapes.
// At the smaller shapes the launch itself dominates.
//
// Design: memory-bound elementwise passes. K5: one thread per (tuple,
// conformer), conformer index fastest, so a warp's loads of one coordinate
// are neighbouring addresses in the (T, 4, 3, C) layout; the thread reads
// its tuple's k row once (the same address across the warp, a broadcast),
// keeps the geometry and the recurrence in registers and writes its energy
// once. K5b keeps that layout but splits each warp into segments of
// L = min(C, 32) lanes, one tuple a segment (32 / C tuples a warp at C <= 32;
// at C > 32 a lane walks conformers c, c + 32, ...): then dk's sum over C is
// a per-lane sum in conformer order followed by a segmented shuffle tree of
// fixed shape, so no lane idles at C = 4 and two runs give the same bits.
// dk is summed in chunks of kChunk periodicities held in registers; P above
// that recomputes the angle per chunk. Any T and C: the TPU's padding of T
// to 256-row tiles and of C to 128 lanes came from VMEM and does not apply.
#include "common.cuh"

namespace {

constexpr float kDegenerateEps = 1e-12f;
constexpr int kChunk = 8;          // dk periodicities summed per pass

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// The dihedral's intermediates for one (tuple, conformer); p points at
// pos[t, 0, 0, c], component d of atom a at p[(3 a + d) C].
struct Dihedral {
  float r01[3], r21[3], r23[3], n1[3], n2[3], m[3];
  float norm21, x, y, r2, cos_phi;
  bool degenerate;

  __device__ __forceinline__ void load(const float* p, int c_count) {
    float q[4][3];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int d = 0; d < 3; ++d) q[a][d] = p[(a * 3 + d) * c_count];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      r01[d] = q[1][d] - q[0][d];
      r21[d] = q[1][d] - q[2][d];
      r23[d] = q[3][d] - q[2][d];
    }
    cross3(r01, r21, n1);
    cross3(r21, r23, n2);
    cross3(n1, n2, m);
    norm21 = sqrtf(dot3(r21, r21) + kDegenerateEps);
    y = dot3(m, r21) / norm21;
    x = dot3(n1, n2);
    r2 = x * x + y * y;
    degenerate = r2 < kDegenerateEps;
    cos_phi = degenerate ? 1.f : x * rsqrtf(r2);
  }
};

__global__ void __launch_bounds__(kThreads)
torsion_energy_kernel(const float* __restrict__ pos,
                      const float* __restrict__ k, float* __restrict__ out,
                      long long total, int c_count, int n_per) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long t = i / c_count;
  const int c = (int)(i - t * c_count);
  Dihedral h;
  h.load(pos + t * 12 * c_count + c, c_count);

  const float* kt = k + t * n_per;
  float c_prev = 1.f, c_cur = h.cos_phi;
  float energy = kt[0] * c_cur;
  for (int n = 1; n < n_per; ++n) {
    const float c_next = 2.f * h.cos_phi * c_cur - c_prev;
    c_prev = c_cur;
    c_cur = c_next;
    energy += kt[n] * c_cur;
  }
  out[i] = energy;
}

// Writes dpos[t, :, :, c] for one (tuple, conformer) with incoming
// gradient gt.
__device__ __forceinline__ void dihedral_backward(const Dihedral& h,
                                                  const float* kt, int n_per,
                                                  float gt, float* dp,
                                                  int c_count) {
  float gx = 0.f, gy = 0.f;
  if (!h.degenerate) {
    // s = sum_n n k_n U_(n-1)(cos phi); dE/dphi = -sin phi s
    float u_prev = 0.f, u_cur = 1.f, s = 0.f;
    for (int n = 1; n <= n_per; ++n) {
      s += (float)n * kt[n - 1] * u_cur;
      const float u_next = 2.f * h.cos_phi * u_cur - u_prev;
      u_prev = u_cur;
      u_cur = u_next;
    }
    const float g_phi = -gt * s * h.y * rsqrtf(h.r2);
    const float inv_r2 = 1.f / h.r2;
    gx = -g_phi * h.y * inv_r2;
    gy = g_phi * h.x * inv_r2;
  }
  // y = m.u, u = r21 / norm21; x = n1.n2; m = n1 x n2
  const float inv_norm = 1.f / h.norm21;
  float u[3], gm[3], gu[3], gn1[3], gn2[3], tmp[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    u[d] = h.r21[d] * inv_norm;
    gm[d] = gy * u[d];
    gu[d] = gy * h.m[d];
  }
  cross3(h.n2, gm, gn1);              // d(n1 x n2) / dn1: n2 x gm
  cross3(gm, h.n1, gn2);              // d(n1 x n2) / dn2: gm x n1
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    gn1[d] += gx * h.n2[d];
    gn2[d] += gx * h.n1[d];
  }
  // u = r21 / sqrt(|r21|^2 + eps): dr21 = (gu - u (gu.u)) / norm21
  const float gu_u = dot3(gu, u);
  float gr01[3], gr21[3], gr23[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) gr21[d] = (gu[d] - u[d] * gu_u) * inv_norm;
  // n1 = r01 x r21; n2 = r21 x r23
  cross3(h.r21, gn1, gr01);
  cross3(gn1, h.r01, tmp);
#pragma unroll
  for (int d = 0; d < 3; ++d) gr21[d] += tmp[d];
  cross3(h.r23, gn2, tmp);
#pragma unroll
  for (int d = 0; d < 3; ++d) gr21[d] += tmp[d];
  cross3(gn2, h.r21, gr23);
  // r01 = x1 - x0, r21 = x1 - x2, r23 = x3 - x2
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    dp[(0 * 3 + d) * c_count] = -gr01[d];
    dp[(1 * 3 + d) * c_count] = gr01[d] + gr21[d];
    dp[(2 * 3 + d) * c_count] = -gr21[d] - gr23[d];
    dp[(3 * 3 + d) * c_count] = gr23[d];
  }
}

// Sum of v over each segment of `seg` consecutive lanes, into the
// segment's first lane (pos = the lane's place in its segment); a tree of
// fixed shape, so the order of the additions never changes. Every lane of
// the warp takes part.
__device__ __forceinline__ float segment_sum(float v, int pos, int seg) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float w = __shfl_down_sync(0xffffffffu, v, o);
    if ((pos & (2 * o - 1)) == 0 && pos + o < seg) v += w;
  }
  return v;
}

// Warp w takes tuples w * per_warp .. + per_warp - 1, `seg` lanes each
// (seg = min(C, 32), per_warp = 32 / seg); a lane walks conformers c0,
// c0 + seg, ... of its tuple. dk == nullptr: dpos alone.
__global__ void __launch_bounds__(kThreads)
torsion_grad_kernel(const float* __restrict__ pos,
                    const float* __restrict__ k,
                    const float* __restrict__ g, float* __restrict__ dpos,
                    float* __restrict__ dk, int t_count, int c_count,
                    int n_per, int seg, int per_warp) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int slot = lane / seg;
  const int c0 = lane - slot * seg;
  const long long t = warp * per_warp + slot;
  const bool active = slot < per_warp && t < t_count;
  const float* kt = k + t * n_per;
  const int passes = dk == nullptr ? 1 : (n_per + kChunk - 1) / kChunk;
  for (int pass = 0; pass < passes; ++pass) {
    const int n0 = pass * kChunk;    // dk[t, n0 .. n0 + kChunk - 1]
    float acc[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
    if (active) {
      for (int c = c0; c < c_count; c += seg) {
        const long long base = t * 12 * c_count + c;
        Dihedral h;
        h.load(pos + base, c_count);
        const float gt = g[t * c_count + c];
        if (pass == 0)
          dihedral_backward(h, kt, n_per, gt, dpos + base, c_count);
        if (dk != nullptr) {
          // T_n0 and T_(n0+1), then the chunk's terms g T_(n0+1+j)
          float c_prev = 1.f, c_cur = h.cos_phi;
          for (int n = 0; n < n0; ++n) {
            const float c_next = 2.f * h.cos_phi * c_cur - c_prev;
            c_prev = c_cur;
            c_cur = c_next;
          }
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            acc[j] += gt * c_cur;
            const float c_next = 2.f * h.cos_phi * c_cur - c_prev;
            c_prev = c_cur;
            c_cur = c_next;
          }
        }
      }
    }
    if (dk != nullptr) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float v = segment_sum(acc[j], c0, seg);
        if (active && c0 == 0 && n0 + j < n_per) dk[t * n_per + n0 + j] = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// pos: (T, 4, 3, C), k: (T, P) with P >= 1, out: (T, C); all float32,
// contiguous, on the stream's device.
int grappa_torsion_energy(const float* pos, const float* k, float* out,
                          int t, int c, int n_per, void* stream) {
  const long long total = (long long)t * c;
  if (total > 0)
    torsion_energy_kernel<<<cdiv(total, kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>(pos, k, out, total, c,
                                                    n_per);
  return (int)cudaGetLastError();
}

// pos: (T, 4, 3, C), k: (T, P) with P >= 1, g: (T, C) -> dpos (T, 4, 3,
// C) and, unless dk is null, dk (T, P); all float32, contiguous, on the
// stream's device.
int grappa_torsion_grad(const float* pos, const float* k, const float* g,
                        float* dpos, float* dk, int t, int c, int n_per,
                        void* stream) {
  if ((long long)t * c > 0) {
    const int seg = c < 32 ? c : 32;
    const int per_warp = 32 / seg;
    const long long warps = ((long long)t + per_warp - 1) / per_warp;
    torsion_grad_kernel<<<cdiv(warps, kWarps), kThreads, 0,
                          (cudaStream_t)stream>>>(pos, k, g, dpos, dk, t, c,
                                                  n_per, seg, per_warp);
  } else if (dk != nullptr && t > 0) {
    // C = 0: no conformer, so dk is 0
    cudaMemsetAsync(dk, 0, sizeof(float) * t * n_per, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
