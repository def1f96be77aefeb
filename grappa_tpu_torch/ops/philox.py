"""Philox dropout masks in plain PyTorch: the bits of the kernels' device
function (`csrc/common.cuh` `philox_bits`), on any device.

A mask element is a pure function of (seed, stream, flat index): Philox4x32
with 10 rounds, key (seed, stream), counter (index low word, index high
word, 0, 0), first output word. The element is kept iff its bits
>= round(rate * 2**32), and kept values are scaled by float32(1) /
float32(1 - rate): the rule of the JAX package's `_dropout_mask`
(grappa_tpu/ops/fused_block.py). Philox cannot give the TPU's bits, so the
port's dropout is checked against this plain version, not against JAX.

The 32 x 32 -> 64-bit products Philox needs are formed from 16-bit halves
in int64, which never overflows (torch has no unsigned 64-bit arithmetic).

`dropout` is the port's dropout outside the kernels: its seed comes from an
explicit `torch.Generator` (a CPU one, so drawing it never waits for the
card), never from torch's global RNG.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57       # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85       # key increments (Weyl sequence)
_MASK32 = 0xFFFFFFFF
ROUNDS = 10


def _mulhilo(a: int, b: torch.Tensor):
    """High and low 32-bit words of a * b, for a constant a < 2**32 and an
    int64 tensor b of values < 2**32."""
    a1, a0 = a >> 16, a & 0xFFFF
    b1, b0 = b >> 16, b & 0xFFFF
    mid = a1 * b0 + a0 * b1                         # < 2**33
    low = a0 * b0 + ((mid & 0xFFFF) << 16)          # < 2**33
    return a1 * b1 + (mid >> 16) + (low >> 32), low & _MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter words (int64 tensors of values
    < 2**32) under key (k0, k1); returns the four output words."""
    k0, k1 = k0 & _MASK32, k1 & _MASK32
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox_bits(seed: int, stream: int, numel: int,
                device=None) -> torch.Tensor:
    """The first Philox4x32-10 output word for counters 0..numel-1 under
    key (seed, stream), as int64 values in [0, 2**32)."""
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    return philox4x32(idx & _MASK32, idx >> 32, zero, zero, seed, stream)[0]


def keep_threshold(rate: float) -> int:
    """Bits at or above this keep an element: round(rate * 2**32)."""
    return min(int(round(rate * float(2 ** 32))), _MASK32)


def keep_scale(rate: float) -> float:
    """The factor on kept elements, 1 / (1 - rate) rounded as float32."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")


def dropout_mask(seed: int, stream: int, shape: Sequence[int], rate: float,
                 device=None) -> torch.Tensor:
    """float32 mask of `shape`: keep_scale(rate) where kept, else 0."""
    check_rate(rate)
    numel = int(np.prod(shape, dtype=np.int64))
    keep = philox_bits(seed, stream, numel, device) >= keep_threshold(rate)
    return (keep.to(torch.float32) * keep_scale(rate)).reshape(tuple(shape))


def draw_seed(generator: torch.Generator) -> int:
    """One 32-bit seed from `generator` (one per fused block per step, as
    the JAX package draws one key per block)."""
    return int(torch.randint(0, 2 ** 32, (1,), generator=generator))


def seed_for(rate: float, training: bool,
             generator: Optional[torch.Generator]) -> Optional[int]:
    """The seed of one fused block's dropout: drawn from `generator` in
    training mode at rate > 0, else None (no dropout)."""
    if not training or rate == 0.0:
        return None
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator "
                         "(the train step passes one)")
    return draw_seed(generator)


def kernel_args(seed: Optional[int], rate: float):
    """(seed, threshold, scale, on) as the kernels take them; `seed` None
    means no dropout."""
    if seed is None:
        return 0, 0, 1.0, 0
    check_rate(rate)
    return seed & _MASK32, keep_threshold(rate), keep_scale(rate), 1


def dump_masks(seed: int, shape: Sequence[int], rate: float,
               device: torch.device):
    """The two masks a fused K1 / K2 call draws for `seed` (keys (seed, 0)
    and (seed, 1)), each of `shape`: the mask-dump kernel
    (`csrc/dropout.cu`) on a CUDA device, this module's plain version on
    the CPU."""
    if device.type != 'cuda':
        return (dropout_mask(seed, 0, shape, rate, device),
                dropout_mask(seed, 1, shape, rate, device))
    from grappa_tpu_torch.ops import _cuda
    s, thr, scale, _ = kernel_args(seed, rate)
    m1 = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    m2 = torch.empty_like(m1)
    _cuda.check(_cuda.lib().grappa_dropout_masks(
        s, thr, scale, m1.numel(), m1.data_ptr(), m2.data_ptr(),
        _cuda.stream_of(m1)), 'grappa_dropout_masks')
    return m1, m2


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout of x with a Philox mask whose seed is drawn from
    `generator`; the identity in eval mode or at rate 0."""
    seed = seed_for(rate, training, generator)
    if seed is None:
        return x
    return x * dropout_mask(seed, 0, x.shape, rate, x.device)
