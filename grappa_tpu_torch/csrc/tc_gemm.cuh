// A float32 GEMM on the H100's tensor cores: mma.sync products fed by a
// cp.async ring of shared-memory stages. Every float32 product of the
// port's kernels (K1-K3 forward, K1b-K3b backward) runs on it; their bf16
// products run on wg_gemm.cuh. It computes epi(z, m, n, sum_k A(m, k)
// B(n, k)) over blockIdx.z's slice of the reduction, operands given as
// common.cuh's views Mat and Tr<Mat>, and any epilogue of common.cuh's
// contract (Out, EluGradOut, Partial, ...).
//
// Arithmetic, 3xTF32. Each operand element is
// split as a = big + small with big = cvt.rna.tf32(a) and small =
// cvt.rna.tf32(a - big); the products small*big, big*small and big*big are
// summed in float32 by mma.sync.m16n8k8 (TF32 inputs, float32 accumulator).
// The dropped small*small term and the rounding of small leave about 2^-21
// of each product, close to float32; one TF32 pass (about 2^-11) would not
// meet the port's 1e-4 gradient tolerance over 33k-row weight gradients
// (tests/test_torch_port_tf32.py rehearses both in numpy). mma.sync rather
// than wgmma: a TF32 wgmma reads its shared-memory operands only K-major,
// and most backward products read an MN-major operand (the dX products read
// W transposed, the dW products both operands); mma.sync fragments are
// loaded by each thread, so one engine serves every layout.
//
// Loads. Each block tile's A (BM x 32) and B (BN x 32) slices are copied by
// cp.async into a ring of STAGES shared-memory stages, so STAGES - 1 copies
// are in flight while the tensor cores work on the oldest. The shared
// layout follows the operand's contiguous axis: K-major rows of 32 + 4
// floats, or MN-major rows of BM + 8 floats; both pads make the fragment
// reads (8 rows x 4 columns a warp, or 4 rows x 8) free of bank conflicts.
// Copies are 16 bytes where the operand's base and row stride are 16-byte
// aligned (checked on the host per launch), else 4 bytes; the ragged M, N
// and K edges are zero-filled by the copies' source size. A transform on
// load (an elu, a LayerNorm of gathered rows) cannot ride cp.async and is
// not taken: applied to each fragment it is recomputed by every warp that
// reads the element, so a caller stores the transformed operand instead.
//
// Tiles. 128 x 128 blocks of 8 warps, each warp 64 x 32 (4 x 4 m16n8
// tiles), 4 stages (147 KB of dynamic shared memory, one block an SM);
// 64 x 64 blocks (warps 32 x 16) where the big tiles would give fewer than
// one block per SM. Weight gradients split the reduction (the batch's rows)
// into at most kMaxSplits fixed slices whose partial products are added in
// slice order by sum_slices: no float atomics, two runs give the same bits.
#pragma once

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- operands
// The storage behind a loader view: element (r, k) of the product's side at
// p[r * ld + k] (K-major, Mat) or p[k * ld + r] (MN-major, Tr<Mat>).
template <class L>
struct TcView;

template <>
struct TcView<Mat> {
  static constexpr bool kKMajor = true;
  static const float* ptr(const Mat& l) { return l.a; }
  static int ld(const Mat& l) { return l.ld; }
};

template <>
struct TcView<Tr<Mat>> {
  static constexpr bool kKMajor = false;
  static const float* ptr(const Tr<Mat>& l) { return l.in.a; }
  static int ld(const Tr<Mat>& l) { return l.in.ld; }
};

// What a kernel gets of an operand: base, row stride, and whether both
// allow 16-byte copies.
struct TcOperand {
  const float* p;
  int ld;
  int vec16;
};

template <class L>
TcOperand tc_operand(const L& l) {
  const float* p = TcView<L>::ptr(l);
  const int ld = TcView<L>::ld(l);
  return TcOperand{p, ld, ((uintptr_t)p % 16 == 0) && (ld % 4 == 0)};
}

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a = big + small, both TF32 (float32 bit patterns, low 13 bits zero).
__device__ __forceinline__ void split_tf32(float a, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(a));
  const float rest = a - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// c += a b over one m16n8k8 tile. Fragments (g = lane / 4, t = lane % 4):
// a (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b (k = t, n = g),
// (k = t + 4, n = g); c (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------- tiles
constexpr int kTcBK = 32;   // reduction depth of one stage

template <int BM_, int BN_, int WARPS_M_, int STAGES_>
struct TcTile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = kWarps / WARPS_M_;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static_assert(MI * 16 == WM && NI * 8 == WN, "warp tile of m16n8 tiles");
};
using TcBig = TcTile<128, 128, 2, 4>;
using TcSmall = TcTile<64, 64, 2, 4>;

// Shared layout of one stage of an operand with R rows on the block's side.
template <int R, bool KMajor>
struct TcSmem {
  static constexpr int kLd = KMajor ? kTcBK + 4 : R + 8;
  static constexpr int kSize = KMajor ? R * kLd : kTcBK * kLd;
  static __device__ __forceinline__ int at(int r, int k) {
    return KMajor ? r * kLd + k : k * kLd + r;
  }
};

template <class T, bool AK, bool BK>
constexpr int tc_smem_bytes() {
  return T::STAGES * (TcSmem<T::BM, AK>::kSize + TcSmem<T::BN, BK>::kSize) *
         (int)sizeof(float);
}

// Rows [r0, r0 + R) x reduction [k0, k0 + 32) of an operand into one stage;
// elements outside rows < `rows`, k < ke are zero.
template <int R, bool KMajor>
__device__ __forceinline__ void tc_load(float* s, const TcOperand& op, int r0,
                                        int rows, int k0, int ke, int tid) {
  using S = TcSmem<R, KMajor>;
  static_assert(R * kTcBK % (4 * kThreads) == 0, "whole copies a thread");
  if (op.vec16) {
#pragma unroll
    for (int j = 0; j < R * kTcBK / (4 * kThreads); ++j) {
      const int i = tid + j * kThreads;
      int r, k, n;
      const float* src;
      if constexpr (KMajor) {
        r = i / (kTcBK / 4);
        k = (i % (kTcBK / 4)) * 4;
        const int gr = r0 + r, gk = k0 + k;
        n = gr < rows ? min(max(ke - gk, 0), 4) : 0;
        src = op.p + (size_t)gr * op.ld + gk;
      } else {
        k = i / (R / 4);
        r = (i % (R / 4)) * 4;
        const int gr = r0 + r, gk = k0 + k;
        n = gk < ke ? min(max(rows - gr, 0), 4) : 0;
        src = op.p + (size_t)gk * op.ld + gr;
      }
      cp_async16(s + S::at(r, k), n ? src : op.p, 4 * n);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < R * kTcBK / kThreads; ++j) {
      const int i = tid + j * kThreads;
      int r, k;
      if constexpr (KMajor) {
        r = i / kTcBK;
        k = i % kTcBK;
      } else {
        k = i / R;
        r = i % R;
      }
      const int gr = r0 + r, gk = k0 + k;
      const bool in = gr < rows && gk < ke;
      const float* src = KMajor ? op.p + (size_t)gr * op.ld + gk
                                : op.p + (size_t)gk * op.ld + gr;
      cp_async4(s + S::at(r, k), in ? src : op.p, in ? 4 : 0);
    }
  }
}

// One 32-deep stage's products of a warp's tiles into part, 3xTF32.
template <class T, class SA, class SB>
__device__ __forceinline__ void tc_stage(const float* as, const float* bs,
                                         float (&part)[T::MI][T::NI][4],
                                         int wm0, int wn0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kTcBK; kk += 8) {
    uint32_t ab[T::MI][4], asm_[T::MI][4], bb[T::NI][2], bsm[T::NI][2];
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        split_tf32(as[SA::at(wm0 + i * 16 + g + (c & 1) * 8,
                             kk + t + (c >> 1) * 4)],
                   ab[i][c], asm_[i][c]);
#pragma unroll
    for (int j = 0; j < T::NI; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        split_tf32(bs[SB::at(wn0 + j * 8 + g, kk + t + c * 4)], bb[j][c],
                   bsm[j][c]);
    // one pass over all tiles per term: 16 independent mmas between two
    // that share an accumulator
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int j = 0; j < T::NI; ++j) mma_tf32(part[i][j], asm_[i], bb[j]);
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int j = 0; j < T::NI; ++j) mma_tf32(part[i][j], ab[i], bsm[j]);
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int j = 0; j < T::NI; ++j) mma_tf32(part[i][j], ab[i], bb[j]);
  }
}

template <class T, bool AK, bool BK, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
tc_gemm_kernel(TcOperand A, TcOperand B, Epi epi, int M, int N, int K,
               int k_chunk) {
  using SA = TcSmem<T::BM, AK>;
  using SB = TcSmem<T::BN, BK>;
  extern __shared__ __align__(16) float tc_smem[];
  float* As = tc_smem;
  float* Bs = tc_smem + T::STAGES * SA::kSize;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp % T::WARPS_M) * T::WM;
  const int wn0 = (warp / T::WARPS_M) * T::WN;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int ntiles = ke > kb ? (ke - kb + kTcBK - 1) / kTcBK : 0;

  float acc[T::MI][T::NI][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < T::NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kb + kt * kTcBK;
    tc_load<T::BM, AK>(As + stage * SA::kSize, A, m0, M, k0, ke, tid);
    tc_load<T::BN, BK>(Bs + stage * SB::kSize, B, n0, N, k0, ke, tid);
  };

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < ntiles) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    const int next = kt + T::STAGES - 1;
    if (next < ntiles) load_stage(next % T::STAGES, next);
    cp_async_commit();

    const float* as = As + (kt % T::STAGES) * SA::kSize;
    const float* bs = Bs + (kt % T::STAGES) * SB::kSize;
    // this stage's products go to a fresh sum, then one float32 add into
    // acc: the tensor cores' own accumulation is not round-to-nearest, and
    // over a 2k-33k-row reduction its error grows with the length
    float part[T::MI][T::NI][4];
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int j = 0; j < T::NI; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
    tc_stage<T, SA, SB>(as, bs, part, wm0, wn0, g, t);
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int j = 0; j < T::NI; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
  }
  cp_async_wait<0>();

  // The block's sums go through shared memory (the stages are free now), so
  // the epilogue is a loop with neighbouring threads on neighbouring
  // columns: coalesced loads and stores, and its code (Philox, elu, ...)
  // unrolled 4 times (four residual / gate loads in flight), not once per
  // accumulator.
  constexpr int kCLd = T::BN + 8;   // float2 writes free of bank conflicts
  static_assert(T::BM * kCLd <= T::STAGES * (SA::kSize + SB::kSize),
                "the output tile fits in the stages");
  __syncthreads();
  float* cs = tc_smem;
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < T::NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            cs + (wm0 + i * 16 + g + h * 8) * kCLd + wn0 + j * 8 + 2 * t) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
#pragma unroll 4
  for (int e = tid; e < T::BM * T::BN; e += kThreads) {
    const int r = e / T::BN, col = e % T::BN;
    const int m = m0 + r, n = n0 + col;
    if (m < M && n < N) epi(blockIdx.z, m, n, cs[r * kCLd + col]);
  }
}

template <class T, class AL, class BL, class Epi>
int tc_launch_tile(const AL& a, const BL& b, const Epi& epi, int M, int N,
                   int K, int splits, int k_chunk, cudaStream_t st) {
  constexpr bool AK = TcView<AL>::kKMajor, BK = TcView<BL>::kKMajor;
  constexpr int bytes = tc_smem_bytes<T, AK, BK>();
  auto kernel = tc_gemm_kernel<T, AK, BK, Epi>;
  RETURN_IF_ERR((int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  dim3 grid(cdiv(M, T::BM), cdiv(N, T::BN), splits);
  kernel<<<grid, kThreads, bytes, st>>>(tc_operand(a), tc_operand(b), epi, M,
                                        N, K, k_chunk);
  return (int)cudaGetLastError();
}

// 128 x 128 tiles when they alone give at least one block per SM of the
// H100 (132), else 64 x 64 tiles. With splits > 1, k_chunk is a multiple of
// kTcBK (so every slice starts 16-byte aligned).
template <class AL, class BL, class Epi>
int tc_launch(const AL& a, const BL& b, const Epi& epi, int M, int N, int K,
              int splits, int k_chunk, cudaStream_t st) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if ((long long)cdiv(M, TcBig::BM) * cdiv(N, TcBig::BN) * splits >= 132)
    return tc_launch_tile<TcBig>(a, b, epi, M, N, K, splits, k_chunk, st);
  return tc_launch_tile<TcSmall>(a, b, epi, M, N, K, splits, k_chunk, st);
}

// epi(A B^T) over the whole of K in one pass.
template <class AL, class BL, class Epi>
int tc_gemm(const AL& a, const BL& b, const Epi& epi, int M, int N, int K,
            cudaStream_t st) {
  return tc_launch(a, b, epi, M, N, K, 1, K > 0 ? K : 1, st);
}

// The forward form: C = epilogue(A @ W^T) with W (N, K) row-major.
template <class AL>
int tc_gemm(const AL& a, const float* W, int ldw, const float* bias,
            const float* R, int ldr, float* C, int ldc, int M, int N, int K,
            bool act_elu, cudaStream_t st,
            Drop drop = make_drop(0, 0, 0, 1.f, 0, 0)) {
  Out o = out_to(C, ldc);
  o.bias = bias;
  o.act_elu = act_elu;
  o.drop = drop;
  o.R = R;
  o.ldr = ldr;
  return tc_gemm(a, Mat{W, ldw}, o, M, N, K, st);
}

// Slices of the reduction for a weight gradient: as many as fill two waves
// of 128 x 128 blocks on 132 SMs without a third, each at least 256 rows,
// at most kMaxSplits. A pure function of the shape, so the order of the
// sums is fixed.
inline int tc_wgrad_splits(int M, int N, int K) {
  const long long tiles =
      (long long)cdiv(M, TcBig::BM) * cdiv(N, TcBig::BN);
  long long s = 264 / tiles;
  s = s < K / 256 ? s : K / 256;
  s = s < kMaxSplits ? s : kMaxSplits;
  return s > 1 ? (int)s : 1;
}

// dW[m, n] = sum_k A(m, k) B(n, k) over a long k (the rows of a batch):
// the slices of k run in parallel into `partial` (kMaxSplits x M x N floats
// at most) and sum_slices adds them in slice order, in float32.
template <class AL, class BL>
int tc_gemm_wgrad(const AL& a, const BL& b, float* dW, int M, int N, int K,
                  float* partial, cudaStream_t st) {
  const int s = tc_wgrad_splits(M, N, K);
  if (s == 1) return tc_gemm(a, b, out_to(dW, N), M, N, K, st);
  const int chunk = cdiv(cdiv(K, s), kTcBK) * kTcBK;
  const int used = cdiv(K, chunk);
  RETURN_IF_ERR(tc_launch(a, b, Partial{partial, M, N}, M, N, K, used, chunk,
                          st));
  return sum_slices(partial, dW, used, (long long)M * N, st);
}

}  // namespace
