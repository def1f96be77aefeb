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
// Bound on an H100 SXM: writing two float32 masks, 8 bytes an element (no
// input): 13.8 MB for the (3376, 512) GNN masks of the 128-molecule
// training batch, 4.1 us at 3.35 TB/s.
// Philox4x32-10 costs 20 integer multiplies an element, far below the
// integer rate, so the pass is bound by its stores. One thread an element,
// coalesced stores.
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

}  // extern "C"
