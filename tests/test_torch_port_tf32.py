"""CPU rehearsal of the numerics of the tensor-core GEMM on which every
product of the port's kernels runs (`grappa_tpu_torch/csrc/tc_gemm.cuh`),
emulated in numpy.

The kernel rounds each operand element to TF32 with `cvt.rna` (keep 10
mantissa bits, round to nearest, ties away from zero), splits it as
a = big + small with big = rna(a), small = rna(a - big), and sums the
products small*big + big*small + big*big (3xTF32) in float32, eight
reduction steps per mma; a weight gradient splits its rows into fixed
slices of a multiple of 32 rows whose sums are added in slice order. This
file repeats that arithmetic on seeded products of the kernels'
reduction lengths (K = 512 and 1536; K = 2048, the longest forward
reduction, K1's FF2 and K3's layer 0; a dW over the n4 training shape's
33,024 rows in 2 and 16 slices) against float64, and holds it to the
port's own tolerances: forward / dX outputs elementwise 1e-4 + 1e-4 |y|
(KERNEL_ATOL / KERNEL_RTOL), weight gradients max |err| <= 1e-4 x max
|dW| (GRAD_RTOL). One TF32 pass (big*big alone) is shown to err at least 10x
more on the dW case, which is why the kernel pays for three. Imports
neither JAX nor the port: the emulation is the point.
"""
import numpy as np
import pytest

KERNEL_RTOL = KERNEL_ATOL = 1e-4
GRAD_RTOL = 1e-4
TRAIN_ROWS = 4 * 8256     # the n4 head's rows at the training batch
BK = 32                   # the kernel's reduction depth per stage


def tf32_rna(x):
    """float32 -> TF32 as cvt.rna.tf32.f32: the low 13 of the 23 mantissa
    bits rounded away (half rounds away from zero), as a float32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split_tf32(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def emulate(a, b, passes, slices=1):
    """sum_k a[m, k] b[n, k] as the kernel forms it: `passes` = 3 sums
    small*big + big*small + big*big, 1 only big*big; float32 sums of eight
    k at a time into a float32 accumulator, per slice of the reduction
    (ceil(ceil(K / slices) / 32) * 32 rows each), the slices added in
    order."""
    (ab, asm), (bb, bsm) = split_tf32(a), split_tf32(b)
    terms = [(asm, bb), (ab, bsm), (ab, bb)] if passes == 3 else [(ab, bb)]
    k = a.shape[1]
    chunk = -(-(-(-k // slices)) // BK) * BK
    total = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k0 in range(0, k, chunk):
        acc = np.zeros_like(total)
        for j in range(k0, min(k, k0 + chunk), 8):
            for x, y in terms:
                acc += x[:, j:j + 8] @ y[:, j:j + 8].T
        total += acc
    return total


def _exact(a, b):
    return a.astype(np.float64) @ b.astype(np.float64).T


@pytest.mark.parametrize('k', [512, 1536, 2048])
def test_3xtf32_products_meet_the_kernel_tolerance(k):
    """A forward or dX product: LayerNorm-scale activations (N(0, 1))
    against weights N(0, 1 / K), K = F or hid (512), 3F (1536) or 4F and
    S*F (2048)."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((64, k)).astype(np.float32)
    w = (rng.standard_normal((48, k)) / np.sqrt(k)).astype(np.float32)
    want = _exact(x, w)
    err = np.abs(emulate(x, w, 3) - want)
    assert np.all(err <= KERNEL_ATOL + KERNEL_RTOL * np.abs(want)), \
        float(err.max())


def _dw_case(seed):
    """dW = dY^T X over the training rows: 40 x 48 entries of it."""
    rng = np.random.default_rng(seed)
    dy_t = rng.standard_normal((40, TRAIN_ROWS)).astype(np.float32)
    x_t = rng.standard_normal((48, TRAIN_ROWS)).astype(np.float32)
    return dy_t, x_t, _exact(dy_t, x_t)


@pytest.mark.parametrize('slices', [2, 16])
def test_3xtf32_weight_gradient_meets_grad_rtol(slices):
    dy_t, x_t, want = _dw_case(slices)
    err = float(np.abs(emulate(dy_t, x_t, 3, slices) - want).max())
    assert err <= GRAD_RTOL * float(np.abs(want).max())


@pytest.mark.parametrize('slices', [2, 16])
def test_one_tf32_pass_errs_ten_times_more(slices):
    dy_t, x_t, want = _dw_case(100 + slices)
    scale = float(np.abs(want).max())
    err3 = float(np.abs(emulate(dy_t, x_t, 3, slices) - want).max())
    err1 = float(np.abs(emulate(dy_t, x_t, 1, slices) - want).max())
    print(f'dW over {TRAIN_ROWS} rows in {slices} slices: max |err| / max '
          f'|dW| 3xTF32 {err3 / scale:.2e}, 1xTF32 {err1 / scale:.2e} '
          f'(GRAD_RTOL {GRAD_RTOL})')
    assert err1 >= 10 * err3


def test_tf32_rounding_and_split():
    one = np.float32(1.0)
    half_ulp = np.float32(2.0 ** -11)       # half a TF32 ulp at 1
    x = np.array([one + half_ulp, -(one + half_ulp),
                  one + half_ulp - np.float32(2.0 ** -23), 3.0, 0.0],
                 np.float32)
    np.testing.assert_array_equal(
        tf32_rna(x), np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 3.0,
                               0.0], np.float32))
    v = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    big, small = split_tf32(v)
    assert not np.any(big.view(np.uint32) & np.uint32(0x1FFF))
    assert not np.any(small.view(np.uint32) & np.uint32(0x1FFF))
    # big + small carries 22 of the 24 bits: |v - big - small| <= 2^-22 |v|
    rest = np.abs(v.astype(np.float64) - big - small)
    assert np.all(rest <= 2.0 ** -22 * np.abs(v))
