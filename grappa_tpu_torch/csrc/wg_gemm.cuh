// A bf16 GEMM on the H100's warpgroup tensor cores: TMA copies bf16 tiles
// into a ring of 128-byte-swizzled shared-memory stages and warpgroups run
// wgmma.mma_async on them. It serves the bf16 mode of every kernel with
// products: K2 / K2b (fused_block.cu), K3 / K3b (fused_symmetriser.cu) and
// K1 / K1b (fused_gnn.cu), replacing the products of their Pallas kernels
// with mm_dtype=bfloat16 (grappa_tpu/ops/fused_block.py::_fused_fwd (:379)
// and _fused_bwd (:421): the forward's four, the backward's eight). It
// computes epi(z, m, n, sum_k A(m, k) B(n, k)) over blockIdx.z's slice of
// the reduction, for operands given as bf16 views (MatH, Tr<MatH>) and any
// epilogue of common.cuh's contract (Out, Partial, ...; EluOutH and
// EluGradOutH below also store a bf16 copy).
//
// Arithmetic: the JAX kernels' _dot / _dot_tn / _dot_nt with
// mm_dtype=bfloat16 -- both operands rounded to bf16 (nearest even), the
// products summed in float32, the output float32. The operands arrive in
// bf16, rounded once by whoever produced them (a LayerNorm, the attention
// pass, an epilogue, a cast pass: fused_block.cu); rounding the same float32
// value to nearest even gives the same bf16 wherever it is done, so only the
// order of the float32 sums differs from any other bf16 product. Each
// 16-deep step is one wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16
// (SASS HGMMA.64x128x16.F32.BF16; chip_smoke.py checks the built library).
// Each 64-deep stage's four steps sum into fresh registers, added into a
// float32 total once they are done, as tc_gemm.cuh does: one wgmma
// accumulator over the whole reduction (512-1536 deep in the dX products,
// ~10,000 rows in a split-K slice at the 512 x 32 training batch) left
// more float32 error: more values fell on the other side of a bf16
// rounding than in the plain bf16 version (K2b's dx at 0.113 of the bf16
// effect against the rule's 0.1 on an H100). The fresh sums cost 64
// registers a thread and a wait for each stage's products, which the
// block's other consumer warpgroup covers.
//
// Bound: K2's four products are 3.1 MFLOP a row (F = hid = 512) and K2b's
// eight 6.3 MFLOP, against ~4 KB a row of input and output, so both are
// bound by operations: 3.2 and 6.4 ns a row at the 989 TFLOP/s bf16 peak.
// Only wgmma reaches that rate; mma.sync cannot.
//
// Design, for that bound:
// - Operands are bf16 in device memory, half the bytes of float32 stages,
//   and no warp converts anything in the mainloop. Every operand is a 2D
//   tensor map (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint, so the library needs no -lcuda) of the true
//   extents; TMA's out-of-bounds fill zeroes the ragged M, N and K edges.
//   Row strides are multiples of 8 elements (16 bytes), as TMA requires:
//   the callers pad their bf16 copies' rows.
// - Stages are 64 deep in the reduction: one 128-byte swizzle row of bf16.
//   A K-major operand tile is R rows of 128 bytes (one box of 64 x R); an
//   MN-major one is 64-wide column blocks of 64 reduction rows x 128 bytes
//   (boxes of 64 x 64, 8 KB). wgmma reads either through its shared-memory
//   descriptor (K-major: 8-row groups 1024 bytes apart; MN-major: 8-row
//   groups 1024 bytes apart, 64-wide blocks 8 KB apart) with its transpose
//   bit set for an MN-major operand, so one engine serves the forward's
//   A @ W^T, the backward's dY @ W (W MN-major) and dY^T @ X (both
//   MN-major) without transposed copies.
// - One producer warp issues the TMA loads of a ring of stages, each with
//   a full / empty mbarrier pair; consumer warpgroups (m64 each) issue
//   four wgmmas a stage, wait for them, release the stage and add the
//   stage's sum.
// - Tiles: 128 x 128 blocks (two consumer warpgroups, 6 stages, 193 KB of
//   dynamic shared memory) where they give at least one block per SM of
//   the H100 (132), else 64 x 128 blocks (one warpgroup, 4 stages, 97 KB).
//   blockIdx.x runs over N, so the blocks in flight share their rows of A
//   (the activations, read once from device memory) and all of B (the
//   weights, which stay in L2).
// - Epilogue: the accumulators go through shared memory (the stages are
//   free by then) into a loop with neighbouring threads on neighbouring
//   columns, tc_gemm.cuh's, so common.cuh's epilogue contract applies; a
//   whole tile takes the loop without bounds tests and the epilogues read
//   their inputs through the read-only path, so each thread has several
//   loads in flight (before both, a 512-deep product that read a residual
//   took twice as long as one with a plain store). Weight gradients split
//   the reduction into tc_wgrad_splits' fixed slices, each a multiple of
//   64 rows, whose partials sum_slices adds in slice order: two runs give
//   the same bits. The epilogue overlaps no product.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>

#include "tc_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Row-major bf16 matrix: (r, k) -> a[r * ld + k], ld a multiple of 8.
struct MatH {
  const bf16* a;
  int ld;
};

inline int pad8(long long n) { return (int)((n + 7) / 8 * 8); }

// ---------------------------------------------------------------- epilogues
// The epilogues read their inputs (bias, residual, stored activation)
// through the read-only data path (__ldg): no product writes what its own
// epilogue reads, and non-coherent loads may be issued ahead of the loop's
// earlier stores, so a thread keeps several in flight.

// common.cuh's Out with its inputs read so; wg_gemm runs every Out as this.
struct OutRo {
  Out o;
  __device__ __forceinline__ void operator()(int, int m, int n,
                                             float v) const {
    if (o.bias) v += __ldg(o.bias + n);
    if (o.act_elu) v = elu(v);
    if (o.drop.on) v *= o.drop(m, n);
    if (o.R) v += __ldg(o.R + (size_t)m * o.ldr + n);
    o.C[(size_t)m * o.ldc + n] = v;
  }
};

// elu(v + bias[n]) to C and, rounded to bf16, to H (K2's FF1: the float32
// activation for the backward's elu', the bf16 one for the products).
struct EluOutH {
  const float* bias;
  float* C;
  int ldc;
  bf16* H;
  int ldh;
  __device__ __forceinline__ void operator()(int, int m, int n,
                                             float v) const {
    v = elu(v + __ldg(bias + n));
    C[(size_t)m * ldc + n] = v;
    H[(size_t)m * ldh + n] = __float2bfloat16_rn(v);
  }
};

// EluGradOut, and the same rounded to bf16 into H.
struct EluGradOutH {
  float* C;
  int ldc;
  const float* a;
  int lda;
  bf16* H;
  int ldh;
  __device__ __forceinline__ void operator()(int, int m, int n,
                                             float v) const {
    v *= elu_grad_of(__ldg(a + (size_t)m * lda + n));
    C[(size_t)m * ldc + n] = v;
    H[(size_t)m * ldh + n] = __float2bfloat16_rn(v);
  }
};

// ---------------------------------------------------------------- operands
template <class L>
struct WgView;

template <>
struct WgView<MatH> {
  static constexpr bool kKMajor = true;
  static const MatH& mat(const MatH& l) { return l; }
};

template <>
struct WgView<Tr<MatH>> {
  static constexpr bool kKMajor = false;
  static const MatH& mat(const Tr<MatH>& l) { return l.in; }
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A tensor map of the bf16 matrix `rows` x `cols` at row stride ld, read in
// 128-byte-swizzled boxes of 64 columns x box_rows rows. Extents of 0 are
// encoded as 1: a product with K = 0 loads nothing.
inline int wg_map(CUtensorMap* map, const bf16* p, int ld, long long cols,
                  long long rows, int box_rows) {
  if ((uintptr_t)p % 16 || ld % 8) return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)(cols > 0 ? cols : 1),
                              (cuuint64_t)(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64u, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)p,
                        dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorNotSupported;
}

// The map of a product operand with `rows` rows on its side of the product
// (M or N) over a reduction of K: K-major, boxes of 64 k x box_rows rows;
// MN-major (stored K x rows), boxes of 64 rows x 64 k.
template <class L>
int wg_operand_map(CUtensorMap* map, const L& l, int rows, int K,
                   int box_rows) {
  const MatH& m = WgView<L>::mat(l);
  return WgView<L>::kKMajor ? wg_map(map, m.a, m.ld, K, rows, box_rows)
                            : wg_map(map, m.a, m.ld, rows, K, 64);
}

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of `map` at (c0 along the contiguous axis, c1 along the rows)
// into shared memory at dst; its bytes complete a transaction of `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d = A B + (accumulate ? d : 0) over one m64n128k16 step of bf16
// operands from shared memory (descriptors da, db; TA / TB 1 for an
// MN-major operand). d's fragments: warp w of the warpgroup, g = lane / 4,
// t = lane % 4: d[4c + 2h + e] is row 16w + g + 8h, column 8c + 2t + e.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// ---------------------------------------------------------------- tiles
constexpr int kWgBK = 64;       // reduction depth of a stage
constexpr int kWgBox = 8192;    // bytes of a 64 x 64 bf16 box

template <int WGM>
struct WgTile {
  static constexpr int BM = 64 * WGM, BN = 128;
  static constexpr int STAGES = WGM == 2 ? 6 : 4;
  static constexpr int THREADS = 128 * WGM + 32;  // + one producer warp
  static constexpr int A_BYTES = BM * kWgBK * 2, B_BYTES = BN * kWgBK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // 1024 bytes to align the stages to the swizzle's 1024-byte period, the
  // stages, a full and an empty barrier a stage
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
};

template <int WGM, bool AK, bool BK, class Epi>
__global__ void __launch_bounds__(WgTile<WGM>::THREADS, 1)
wg_gemm_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb, Epi epi, int M, int N,
               int K, int k_chunk) {
  using T = WgTile<WGM>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t pad = (1024 - raw % 1024) % 1024;
  unsigned char* smem = wg_smem + pad;
  const uint32_t stages = raw + pad;
  const uint32_t full = stages + T::STAGES * T::STAGE_BYTES;
  const uint32_t empty = full + 8 * T::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int ntiles = ke > kb ? (ke - kb + kWgBK - 1) / kWgBK : 0;

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * WGM);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (warp == 4 * WGM) {
    // the producer: one thread keeps the ring's loads in flight
    if (lane == 0) {
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % T::STAGES;
        if (kt >= T::STAGES)
          mbar_wait(empty + 8 * s, ((kt / T::STAGES) + 1) & 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t a = stages + s * T::STAGE_BYTES, b = a + T::A_BYTES;
        const int k0 = kb + kt * kWgBK;
        mbar_expect_tx(bar, T::STAGE_BYTES);
        if constexpr (AK) {
          tma_load(a, &ta, k0, m0, bar);
        } else {
#pragma unroll
          for (int j = 0; j < WGM; ++j)
            tma_load(a + j * kWgBox, &ta, m0 + 64 * j, k0, bar);
        }
        if constexpr (BK) {
          tma_load(b, &tb, k0, n0, bar);
        } else {
#pragma unroll
          for (int j = 0; j < T::BN / 64; ++j)
            tma_load(b + j * kWgBox, &tb, n0 + 64 * j, k0, bar);
        }
      }
    }
  } else {
    // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of the block tile
    const int wg = warp / 4;
    float part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.f;
    for (int kt = 0; kt < ntiles; ++kt) {
      const int s = kt % T::STAGES;
      mbar_wait(full + 8 * s, (kt / T::STAGES) & 1);
      const uint32_t a = stages + s * T::STAGE_BYTES + wg * kWgBox;
      const uint32_t b = stages + s * T::STAGE_BYTES + T::A_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        // K-major: 16 k are 32 bytes along a swizzled row; MN-major: 16
        // rows of 128 bytes
        const uint64_t da = AK ? wg_desc(a + kk * 32, 1, 64)
                               : wg_desc(a + kk * 2048, kWgBox / 16, 64);
        const uint64_t db = BK ? wg_desc(b + kk * 32, 1, 64)
                               : wg_desc(b + kk * 2048, kWgBox / 16, 64);
        wgmma_m64n128<AK ? 0 : 1, BK ? 0 : 1>(part, da, db, kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      // the stage's products are done: release its buffers, and add its
      // sum into the float32 total (the tensor cores' own accumulation
      // does not round to nearest; see the note)
      if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        asm volatile("" : "+f"(part[i])::"memory");
        acc[i] += part[i];
      }
    }
  }

  // The block's sums go through shared memory (every stage is free once all
  // warps are here) into tc_gemm.cuh's coalesced epilogue loop.
  constexpr int kCLd = T::BN + 8;
  static_assert(T::BM * kCLd * 4 <= T::STAGES * T::STAGE_BYTES,
                "the output tile fits in the stages");
  __syncthreads();
  float* cs = reinterpret_cast<float*>(smem);
  if (warp < 4 * WGM) {
    const int g = lane >> 2, t = lane & 3;
    const int row = (warp / 4) * 64 + (warp % 4) * 16 + g;
#pragma unroll
    for (int c = 0; c < T::BN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(cs + (row + 8 * h) * kCLd + 8 * c +
                                   2 * t) =
            make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
  }
  __syncthreads();
  if (m0 + T::BM <= M && n0 + T::BN <= N) {
    // a whole tile: no bounds to test, so the loads of several elements
    // are issued before their stores
#pragma unroll 8
    for (int e = tid; e < T::BM * T::BN; e += T::THREADS) {
      const int r = e / T::BN, col = e % T::BN;
      epi(blockIdx.z, m0 + r, n0 + col, cs[r * kCLd + col]);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < T::BM * T::BN; e += T::THREADS) {
      const int r = e / T::BN, col = e % T::BN;
      const int m = m0 + r, n = n0 + col;
      if (m < M && n < N) epi(blockIdx.z, m, n, cs[r * kCLd + col]);
    }
  }
}

template <int WGM, class AL, class BL, class Epi>
int wg_launch_tile(const AL& a, const BL& b, const Epi& epi, int M, int N,
                   int K, int splits, int k_chunk, cudaStream_t st) {
  using T = WgTile<WGM>;
  CUtensorMap ta, tb;
  RETURN_IF_ERR(wg_operand_map(&ta, a, M, K, T::BM));
  RETURN_IF_ERR(wg_operand_map(&tb, b, N, K, T::BN));
  auto kernel = wg_gemm_kernel<WGM, WgView<AL>::kKMajor,
                               WgView<BL>::kKMajor, Epi>;
  // the shared-memory size is set once a device, not at every launch
  static unsigned long long set_on = 0;
  int dev = 0;
  RETURN_IF_ERR((int)cudaGetDevice(&dev));
  if (!(set_on >> dev & 1)) {
    RETURN_IF_ERR((int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM));
    set_on |= 1ull << dev;
  }
  dim3 grid(cdiv(N, T::BN), cdiv(M, T::BM), splits);
  kernel<<<grid, T::THREADS, T::SMEM, st>>>(ta, tb, epi, M, N, K, k_chunk);
  return (int)cudaGetLastError();
}

// 128 x 128 tiles when they alone give at least one block per SM of the
// H100 (132), else 64 x 128 tiles. With splits > 1, k_chunk is a multiple
// of kWgBK, so no stage reads across two slices.
template <class AL, class BL, class Epi>
int wg_launch(const AL& a, const BL& b, const Epi& epi, int M, int N, int K,
              int splits, int k_chunk, cudaStream_t st) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if ((long long)cdiv(M, 128) * cdiv(N, 128) * splits >= 132)
    return wg_launch_tile<2>(a, b, epi, M, N, K, splits, k_chunk, st);
  return wg_launch_tile<1>(a, b, epi, M, N, K, splits, k_chunk, st);
}

// epi(A B^T) over the whole of K in one pass.
template <class AL, class BL, class Epi>
int wg_gemm(const AL& a, const BL& b, const Epi& epi, int M, int N, int K,
            cudaStream_t st) {
  return wg_launch(a, b, epi, M, N, K, 1, K > 0 ? K : 1, st);
}

template <class AL, class BL>
int wg_gemm(const AL& a, const BL& b, const Out& o, int M, int N, int K,
            cudaStream_t st) {
  return wg_launch(a, b, OutRo{o}, M, N, K, 1, K > 0 ? K : 1, st);
}

// dW[m, n] = sum_k A(m, k) B(n, k) over a long k (the rows of a batch), in
// tc_wgrad_splits' slices (the same 128 x 128 tiles), each a multiple of 64
// rows, into `partial` (kMaxSplits x M x N floats at most); sum_slices adds
// them in slice order.
template <class AL, class BL>
int wg_gemm_wgrad(const AL& a, const BL& b, float* dW, int M, int N, int K,
                  float* partial, cudaStream_t st) {
  const int s = tc_wgrad_splits(M, N, K);
  if (s == 1) return wg_gemm(a, b, out_to(dW, N), M, N, K, st);
  const int chunk = cdiv(cdiv(K, s), kWgBK) * kWgBK;
  const int used = cdiv(K, chunk);
  RETURN_IF_ERR(wg_launch(a, b, Partial{partial, M, N}, M, N, K, used, chunk,
                          st));
  return sum_slices(partial, dW, used, (long long)M * N, st);
}

}  // namespace
