// K5: fused dihedral + periodic-torsion energy, pos (T, 4, 3, C) and signed
// k (T, P) -> energy (T, C).
//
// Replaces the Pallas kernel grappa_tpu/ops/torsion_kernel.py::
// _forward_pallas (_torsion_tile_kernel): for each tuple and conformer the
// dihedral of the four gathered positions around the x1-x2 axis, then
// sum_n k_n cos(n phi), n = 1..P. Trig-free: cos phi = x rsqrt(x^2 + y^2)
// with x = n1.n2 and y = (n1 x n2).r21 / |r21|, and cos(n phi) from the
// Chebyshev recurrence cos((n+1)p) = 2 cos p cos(np) - cos((n-1)p). A
// degenerate tuple (x^2 + y^2 < 1e-12, e.g. all four atoms at one point)
// takes cos phi = 1, as atan2's guard in the plain version gives phi = 0.
// Masked or padded tuples carry zeroed k rows, so they come out as 0.
//
// Bound on an H100 SXM: each position read once and each energy written
// once, 4 (12 T C + T P + T C) bytes over 3.35 TB/s: 13.9 MB and 4.2 us for
// the 128-molecule training batch's propers (T=8256, C=32, P=6), 4.7 MB
// and 1.4 us for a 12,000-atom protein's propers (T=20096, C=4). About 70
// FLOP an element never set the bound; at the smaller shapes the launch
// itself dominates.
//
// Design: a memory-bound elementwise pass. One thread per (tuple,
// conformer), conformer index fastest, so a warp's loads of one coordinate
// are neighbouring addresses in the (T, 4, 3, C) layout; the thread reads
// its tuple's k row once (the same address across the warp, a broadcast),
// keeps the geometry and the recurrence in registers and writes its energy
// once. Any T and C: the TPU's padding of T to 256-row tiles and of C to
// 128 lanes, and its note about not blocking C, came from VMEM and do not
// apply here.
#include "common.cuh"

namespace {

constexpr float kDegenerateEps = 1e-12f;

__global__ void __launch_bounds__(kThreads)
torsion_energy_kernel(const float* __restrict__ pos,
                      const float* __restrict__ k, float* __restrict__ out,
                      long long total, int c_count, int n_per) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long t = i / c_count;
  const int c = (int)(i - t * c_count);
  // component d of atom a: pos[t, a, d, c]
  const float* p = pos + t * 12 * c_count + c;
  float x[4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d) x[a][d] = p[(a * 3 + d) * c_count];

  float r01[3], r21[3], r23[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    r01[d] = x[1][d] - x[0][d];
    r21[d] = x[1][d] - x[2][d];
    r23[d] = x[3][d] - x[2][d];
  }
  const float n1[3] = {r01[1] * r21[2] - r01[2] * r21[1],
                       r01[2] * r21[0] - r01[0] * r21[2],
                       r01[0] * r21[1] - r01[1] * r21[0]};
  const float n2[3] = {r21[1] * r23[2] - r21[2] * r23[1],
                       r21[2] * r23[0] - r21[0] * r23[2],
                       r21[0] * r23[1] - r21[1] * r23[0]};
  const float m[3] = {n1[1] * n2[2] - n1[2] * n2[1],
                      n1[2] * n2[0] - n1[0] * n2[2],
                      n1[0] * n2[1] - n1[1] * n2[0]};
  const float norm21 = sqrtf(r21[0] * r21[0] + r21[1] * r21[1] +
                             r21[2] * r21[2] + kDegenerateEps);
  const float y = (m[0] * r21[0] + m[1] * r21[1] + m[2] * r21[2]) / norm21;
  const float xx = n1[0] * n2[0] + n1[1] * n2[1] + n1[2] * n2[2];
  const float r2 = xx * xx + y * y;
  const float cos_phi = r2 < kDegenerateEps ? 1.f : xx * rsqrtf(r2);

  const float* kt = k + t * n_per;
  float c_prev = 1.f, c_cur = cos_phi;
  float energy = kt[0] * c_cur;
  for (int n = 1; n < n_per; ++n) {
    const float c_next = 2.f * cos_phi * c_cur - c_prev;
    c_prev = c_cur;
    c_cur = c_next;
    energy += kt[n] * c_cur;
  }
  out[i] = energy;
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

}  // extern "C"
