"""K1 / K1b / K1m: the GNN residual-attention block after the neighbour
gather, forward and backward, with dropout.

Counterpart of `grappa_tpu/ops/fused_gnn.py::fused_gnn_block` (forward and
custom_vjp backward) and of its `dropout_masks`. Everything after the
gather `feat[neighbors]` runs as one op:

    scores -> masked softmax over neighbour slots -> weighted message sum
    -> head_reducer -> dropout -> residual(+LN input) -> interaction LN
    -> FF(4F, elu) -> elu -> dropout -> residual

The pre-LN, the `fc` projection, the gather and its transpose (the
scatter-add of dnbr) stay in torch autograd (in `models.gnn`), as the JAX
package leaves them to XLA.

On CUDA tensors `fused_gnn_block` launches the hand-written kernels in
`csrc/fused_gnn.cu`: the forward, and in the backward a kernel chain that
recomputes the forward and returns dfeat, dnbr, dhn and the eight parameter
gradients (the source notes give the card's bound and the design). On CPU
tensors it runs `reference_gnn_block`, the plain PyTorch version, and
autograd differentiates it. `fused_gnn_block.launches` and
`fused_gnn_block.bwd_launches` count kernel launches.

Dropout (training mode, rate > 0) takes a 32-bit `seed`: mask 1 (after
head_reducer) and mask 2 (after the FF's elu) are Philox bits keyed by
(seed, 0) and (seed, 1) (`ops.philox`); the backward regenerates them.
`dropout_masks` dumps them (the mask-dump kernel on CUDA, counted by
`dropout_masks.launches`).

Parameters are a tuple in torch Linear layout (weight (out, in)):
    (head_reducer.weight, head_reducer.bias, interaction_norm.weight,
     interaction_norm.bias, si_dense1.weight, si_dense1.bias,
     si_dense2.weight, si_dense2.bias)
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from grappa_tpu_torch.models.layers import LN_EPS
from grappa_tpu_torch.ops import _cuda, philox
from grappa_tpu_torch.utils import resolve_device

_NEG = -1e30
MAX_SLOTS = 8     # the kernel keeps the D slot scores in registers


def reference_gnn_block(feat, nbr, hn, mask, params: Sequence[torch.Tensor],
                        n_heads: int = 16,
                        masks: Optional[Tuple[torch.Tensor, torch.Tensor]]
                        = None) -> torch.Tensor:
    """Plain PyTorch version: feat (N, F), nbr (D, N, F), hn (N, F),
    mask (D, N) float -> (N, F). `masks`: the two dropout masks (N, F),
    already scaled by 1/keep, or None for no dropout."""
    wr, br, g2, b2, w1, c1, w2, c2 = params
    d, n, f = nbr.shape
    dh = f // n_heads
    feath = feat.reshape(n, n_heads, dh)
    nbrh = nbr.reshape(d, n, n_heads, dh)
    m = mask[:, :, None]
    scores = (torch.einsum('nhd,knhd->knh', feath, nbrh)
              * _cuda.head_scale(dh))
    scores = torch.where(m > 0, scores, torch.full_like(scores, _NEG))
    exps = torch.exp(scores - scores.amax(dim=0)) * m
    alpha = exps / exps.sum(dim=0).clamp_min(1e-9)
    attn0 = torch.einsum('knh,knhd->nhd', alpha, nbrh).reshape(n, f)
    a1 = F.linear(attn0, wr, br)
    if masks is not None:
        a1 = a1 * masks[0]
    x1n = F.layer_norm(a1 + hn, (f,), g2, b2, LN_EPS)
    e1 = F.elu(F.linear(x1n, w1, c1))
    e2 = F.elu(F.linear(e1, w2, c2))
    if masks is not None:
        e2 = e2 * masks[1]
    return e2 + x1n


def _check(feat, nbr, hn, mask, params, n_heads):
    if feat.dim() != 2 or nbr.dim() != 3 or mask.dim() != 2:
        raise ValueError("fused_gnn_block takes feat (N, F), nbr (D, N, F), "
                         "hn (N, F) and mask (D, N)")
    n, f = feat.shape
    d = nbr.shape[0]
    if (tuple(nbr.shape) != (d, n, f) or tuple(hn.shape) != (n, f)
            or tuple(mask.shape) != (d, n)):
        raise ValueError(
            f"shape mismatch: feat {tuple(feat.shape)}, nbr "
            f"{tuple(nbr.shape)}, hn {tuple(hn.shape)}, mask "
            f"{tuple(mask.shape)}")
    if f % n_heads:
        raise ValueError(
            f"node feature width {f} must be divisible by n_heads={n_heads}")
    if len(params) != 8:
        raise ValueError("fused_gnn_block takes 8 parameter tensors")
    hid = params[4].shape[0]
    want = [(f, f), (f,), (f,), (f,), (hid, f), (hid,), (f, hid), (f,)]
    got = [tuple(p.shape) for p in params]
    if got != want:
        raise ValueError(f"parameter shapes {got}, expected {want}")


class _GnnBlockKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, nbr, hn, mask, n_heads, drop, *params):
        (d, n, f), hid = nbr.shape, params[4].shape[0]
        lib = _cuda.lib()
        scratch = torch.empty(lib.grappa_fused_gnn_scratch(n, f, hid),
                              dtype=torch.float32, device=feat.device)
        y = torch.empty((n, f), dtype=torch.float32, device=feat.device)
        ptrs = [t.data_ptr() for t in (feat, nbr, hn, mask, *params)]
        rc = lib.grappa_fused_gnn_fwd(
            *ptrs, *drop, scratch.data_ptr(), y.data_ptr(), n, f, hid, d,
            n_heads, _cuda.head_scale(f // n_heads), _cuda.stream_of(feat))
        _cuda.check(rc, 'grappa_fused_gnn_fwd')
        fused_gnn_block.launches += 1
        ctx.save_for_backward(feat, nbr, hn, mask, *params)
        ctx.n_heads, ctx.drop = n_heads, drop
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        feat, nbr, hn, mask, *params = ctx.saved_tensors
        dy = _cuda.grad_output(dy, feat, 'fused_gnn_block')
        (d, n, f), hid = nbr.shape, params[4].shape[0]
        lib = _cuda.lib()
        scratch = torch.empty(lib.grappa_fused_gnn_bwd_scratch(n, f, hid),
                              dtype=torch.float32, device=feat.device)
        grads = [torch.empty_like(t) for t in (feat, nbr, hn, *params)]
        rc = lib.grappa_fused_gnn_bwd(
            *[t.data_ptr() for t in (feat, nbr, hn, mask, *params, dy)],
            *ctx.drop, scratch.data_ptr(), *[g.data_ptr() for g in grads],
            n, f, hid, d, ctx.n_heads, _cuda.head_scale(f // ctx.n_heads),
            _cuda.stream_of(feat))
        _cuda.check(rc, 'grappa_fused_gnn_bwd')
        fused_gnn_block.bwd_launches += 1
        dfeat, dnbr, dhn, *dparams = grads
        return (dfeat, dnbr, dhn, None, None, None, *dparams)


def fused_gnn_block(feat, nbr, hn, mask, params: Sequence[torch.Tensor],
                    n_heads: int = 16, dropout_rate: float = 0.0,
                    training: bool = False,
                    seed: Optional[int] = None) -> torch.Tensor:
    """Post-gather half of a GNN ResidualAttentionBlock (see module doc).
    Dropout runs in training mode at rate > 0 and then needs `seed`."""
    params = tuple(params)
    _check(feat, nbr, hn, mask, params, n_heads)
    philox.check_rate(dropout_rate)
    drop = training and dropout_rate > 0
    if drop and seed is None:
        raise ValueError("fused_gnn_block: dropout in training mode needs a "
                         "seed")
    if not _cuda.on_cuda((feat, nbr, hn, mask, *params), 'fused_gnn_block'):
        masks = (philox.dump_masks(seed, feat.shape, dropout_rate,
                                   feat.device) if drop else None)
        return reference_gnn_block(feat, nbr, hn, mask, params, n_heads,
                                   masks)
    d = nbr.shape[0]
    if not 1 <= d <= MAX_SLOTS:
        raise ValueError(f"the kernel takes 1..{MAX_SLOTS} neighbour slots, "
                         f"got {d}")
    return _GnnBlockKernel.apply(
        feat, nbr, hn, mask, n_heads,
        philox.kernel_args(seed if drop else None, dropout_rate), *params)


def dropout_masks(seed: int, shape: Sequence[int], rate: float,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1m: the two masks (N, F) that `fused_gnn_block` draws for `seed`
    at `rate`, values already scaled by 1/keep (mask 1 after head_reducer,
    mask 2 after the FF). Runs on `device`: CUDA unless the caller asks for
    another; on the CPU it is the plain Philox."""
    device = resolve_device(device)
    masks = philox.dump_masks(seed, shape, rate, device)
    if device.type == 'cuda':
        dropout_masks.launches += 1
    return masks


fused_gnn_block.launches = 0
fused_gnn_block.bwd_launches = 0
dropout_masks.launches = 0
