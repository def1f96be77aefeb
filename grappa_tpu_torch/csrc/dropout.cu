// K1m / K2m: the dropout masks that K1 and K2 draw, dumped for a seed.
//
// Replaces the Pallas kernels grappa_tpu/ops/fused_gnn.py::dropout_masks
// and grappa_tpu/ops/fused_block.py::dropout_masks (replay checks: an
// outside reference can reproduce a fused forward mask for mask). Both ops
// draw their two masks from the same Philox device function as the GEMM
// epilogues of K1 / K2 (common.cuh, keys (seed, 0) and (seed, 1), counter
// = flat element index), so the dump is bit-identical to what the kernels
// apply.
//
// Bound on an H100 SXM, the larger of two times:
// - stores: two float32 masks, 8 bytes an element (no input), at 3.35
//   TB/s: 13.8 MB and 4.1 us for the (3376, 512) GNN masks of the
//   128-molecule training batch, 135 MB and 40.4 us for the
//   (4, 8256, 512) masks of its n4 head;
// - instructions: one thread an element runs the kernel's SASS once in
//   straight line, two Philox4x32-10 draws. Built for sm_90a it issues
//   132 instructions: 38 integer multiply-adds on the FMA pipe (28
//   IMAD.WIDE.U32, 6 IMAD.HI.U32, 4 other IMAD), 45 other integer
//   instructions on the ALU pipe (36 LOP3, 4 ISETP, 4 IADD3, 1 SHF), 32
//   UIADD3 (the key schedule) and 6 ULDC on the uniform datapath, and 11
//   others (special-register reads, constant loads, selects, stores,
//   exits).
//   An SM runs each pipe at 64 a clock, beside each other, and issues 128
//   instructions a clock, so issue binds: 132 / 128 = 1.03 SM clocks an
//   element, over 132 SMs at 1,980 MHz: 6.8 us for the GNN masks, 66.7 us
//   for the n4 head's.
// So the pass is bound by its instruction issue, not by its stores.
// chip_smoke.py recounts this from the built library's SASS. One thread an
// element, coalesced stores.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
dropout_masks_kernel(Drop a, Drop b, float* __restrict__ m1,
                     float* __restrict__ m2, long long total) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  m1[i] = a.at((unsigned long long)i);
  m2[i] = b.at((unsigned long long)i);
}

// The masks of a shard: a matrix `cols` wide in blocks of `rows` rows,
// each holding rows row0 .. row0 + rows - 1 of a block of rows_glob rows
// (K1's nodes, K2's tuples); element i draws the bits of its flat index in
// the unsharded tensor, as K1's and K2's `_rows` entry points do.
__global__ void __launch_bounds__(kThreads)
dropout_masks_rows_kernel(Drop a, Drop b, float* __restrict__ m1,
                          float* __restrict__ m2, long long total, int cols,
                          long long rows, long long rows_glob,
                          long long row0) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long m = i / cols, n = i - m * cols, s = m / rows;
  const unsigned long long g =
      (unsigned long long)(m + s * (rows_glob - rows) + row0) * cols + n;
  m1[i] = a.at(g);
  m2[i] = b.at(g);
}

}  // namespace

extern "C" {

// m1, m2: `total` floats each, the masks keyed by (seed, 0) and (seed, 1).
int grappa_dropout_masks(uint32_t seed, uint32_t threshold, float drop_scale,
                         long long total, float* m1, float* m2,
                         void* stream) {
  const Drop a = make_drop(seed, 0, threshold, drop_scale, 1, 0);
  const Drop b = make_drop(seed, 1, threshold, drop_scale, 1, 0);
  if (total > 0)
    dropout_masks_kernel<<<cdiv(total, kThreads), kThreads, 0,
                           (cudaStream_t)stream>>>(a, b, m1, m2, total);
  return (int)cudaGetLastError();
}

// The same for a shard's rows (dropout_masks_rows_kernel): K1m's and K2m's
// dump of what K1's and K2's `_rows` entry points draw.
int grappa_dropout_masks_rows(uint32_t seed, uint32_t threshold,
                              float drop_scale, long long total, int cols,
                              long long rows, long long rows_glob,
                              long long row0, float* m1, float* m2,
                              void* stream) {
  const Drop a = make_drop(seed, 0, threshold, drop_scale, 1, 0);
  const Drop b = make_drop(seed, 1, threshold, drop_scale, 1, 0);
  if (total > 0)
    dropout_masks_rows_kernel<<<cdiv(total, kThreads), kThreads, 0,
                                (cudaStream_t)stream>>>(
        a, b, m1, m2, total, cols, rows, rows_glob, row0);
  return (int)cudaGetLastError();
}

}  // extern "C"
