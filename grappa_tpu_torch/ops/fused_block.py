"""K2 / K2b / K2m: one tuple-head TransformerBlock on x (S, T, F), forward
and backward, with dropout.

Counterpart of `grappa_tpu/ops/fused_block.py::fused_transformer_block`
(forward and custom_vjp backward) and of its `dropout_masks`: pre-LN
packed-QKV multi-head attention across the S slots of each tuple, dropout,
+ residual onto the LN1 output, then pre-LN FF (elu), dropout, + residual
onto the LN2 output, as one op on the (S, T, F) layout.

On CUDA tensors `fused_transformer_block` launches the hand-written kernels
in `csrc/fused_block.cu`: the forward, and in the backward a kernel chain
that recomputes the forward and returns dx and the twelve parameter
gradients (the source notes give the card's bound and the design). On CPU
tensors it runs `reference_block`, the plain PyTorch version, and autograd
differentiates it. `fused_transformer_block.launches` and
`fused_transformer_block.bwd_launches` count kernel launches.

Dropout (training mode, rate > 0) takes a 32-bit `seed`: mask 1 (after
out_proj) and mask 2 (after linear2) are Philox bits keyed by (seed, 0) and
(seed, 1) over the (S, T, F) layout (`ops.philox`); the backward
regenerates them. `dropout_masks` dumps them (the mask-dump kernel on
CUDA, counted by `dropout_masks.launches`).

Parameters are a tuple in torch layout (`TransformerBlock.fused_params()`):
    (norm1.weight, norm1.bias, attn.in_proj_weight, attn.in_proj_bias,
     attn.out_proj.weight, attn.out_proj.bias, ff.norm1.weight,
     ff.norm1.bias, ff.linear1.weight, ff.linear1.bias, ff.linear2.weight,
     ff.linear2.bias)
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from grappa_tpu_torch.models.layers import LN_EPS
from grappa_tpu_torch.ops import _cuda, philox
from grappa_tpu_torch.utils import resolve_device

ARITIES = (2, 3, 4)   # the kernel is instantiated for these tuple sizes


def reference_block(x, params: Sequence[torch.Tensor], n_heads: int = 8,
                    masks: Optional[Tuple[torch.Tensor, torch.Tensor]]
                    = None) -> torch.Tensor:
    """Plain PyTorch version on x (S, T, F) -> (S, T, F). `masks`: the two
    dropout masks (S, T, F), already scaled by 1/keep, or None."""
    g1, b1, wq, bq, wo, bo, g2, b2, w1, c1, w2, c2 = params
    s, t, f = x.shape
    dh = f // n_heads
    xn = F.layer_norm(x, (f,), g1, b1, LN_EPS)
    q, k, v = (a.reshape(s, t, n_heads, dh)
               for a in F.linear(xn, wq, bq).split(f, dim=-1))
    logits = torch.einsum('sthd,uthd->thsu', q, k) * _cuda.head_scale(dh)
    w = torch.softmax(logits, dim=-1)
    attn0 = torch.einsum('thsu,uthd->sthd', w, v).reshape(s, t, f)
    attn1 = F.linear(attn0, wo, bo)
    if masks is not None:
        attn1 = attn1 * masks[0]
    x1n = F.layer_norm(attn1 + xn, (f,), g2, b2, LN_EPS)
    h = F.linear(F.elu(F.linear(x1n, w1, c1)), w2, c2)
    if masks is not None:
        h = h * masks[1]
    return h + x1n


def _check(x, params, n_heads):
    if x.dim() != 3:
        raise ValueError(f"fused_transformer_block takes x (S, T, F), got "
                         f"shape {tuple(x.shape)}")
    f = x.shape[-1]
    if f % n_heads:
        raise ValueError(
            f"feature width {f} must be divisible by n_heads={n_heads}")
    if len(params) != 12:
        raise ValueError("fused_transformer_block takes 12 parameter tensors")
    hid = params[8].shape[0]
    want = [(f,), (f,), (3 * f, f), (3 * f,), (f, f), (f,), (f,), (f,),
            (hid, f), (hid,), (f, hid), (f,)]
    got = [tuple(p.shape) for p in params]
    if got != want:
        raise ValueError(f"parameter shapes {got}, expected {want}")


class _BlockKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n_heads, drop, *params):
        (s, t, f), hid = x.shape, params[8].shape[0]
        lib = _cuda.lib()
        scratch = torch.empty(lib.grappa_fused_block_scratch(s, t, f, hid),
                              dtype=torch.float32, device=x.device)
        y = torch.empty_like(x)
        rc = lib.grappa_fused_block_fwd(
            x.data_ptr(), *[p.data_ptr() for p in params], *drop,
            scratch.data_ptr(), y.data_ptr(), s, t, f, hid, n_heads,
            _cuda.head_scale(f // n_heads), _cuda.stream_of(x))
        _cuda.check(rc, 'grappa_fused_block_fwd')
        fused_transformer_block.launches += 1
        ctx.save_for_backward(x, *params)
        ctx.n_heads, ctx.drop = n_heads, drop
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        dy = _cuda.grad_output(dy, x, 'fused_transformer_block')
        (s, t, f), hid = x.shape, params[8].shape[0]
        lib = _cuda.lib()
        scratch = torch.empty(
            lib.grappa_fused_block_bwd_scratch(s, t, f, hid),
            dtype=torch.float32, device=x.device)
        grads = [torch.empty_like(p) for p in (x, *params)]
        rc = lib.grappa_fused_block_bwd(
            *[p.data_ptr() for p in (x, *params, dy)], *ctx.drop,
            scratch.data_ptr(), *[g.data_ptr() for g in grads], s, t, f, hid,
            ctx.n_heads, _cuda.head_scale(f // ctx.n_heads),
            _cuda.stream_of(x))
        _cuda.check(rc, 'grappa_fused_block_bwd')
        fused_transformer_block.bwd_launches += 1
        dx, *dparams = grads
        return (dx, None, None, *dparams)


def fused_transformer_block(x, params: Sequence[torch.Tensor],
                            n_heads: int = 8, dropout_rate: float = 0.0,
                            training: bool = False,
                            seed: Optional[int] = None) -> torch.Tensor:
    """One TransformerBlock on x (S, T, F) (see module doc). Dropout runs
    in training mode at rate > 0 and then needs `seed`."""
    params = tuple(params)
    _check(x, params, n_heads)
    philox.check_rate(dropout_rate)
    drop = training and dropout_rate > 0
    if drop and seed is None:
        raise ValueError("fused_transformer_block: dropout in training mode "
                         "needs a seed")
    if not _cuda.on_cuda((x, *params), 'fused_transformer_block'):
        masks = (philox.dump_masks(seed, x.shape, dropout_rate, x.device)
                 if drop else None)
        return reference_block(x, params, n_heads, masks)
    if x.shape[0] not in ARITIES:
        raise ValueError(f"the kernel takes tuples of {ARITIES} slots, got "
                         f"S={x.shape[0]}")
    return _BlockKernel.apply(
        x, n_heads, philox.kernel_args(seed if drop else None, dropout_rate),
        *params)


def dropout_masks(seed: int, shape: Sequence[int], rate: float,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2m: the two masks (S, T, F) that `fused_transformer_block` draws
    for `seed` at `rate`, values already scaled by 1/keep (mask 1 after
    out_proj, mask 2 after linear2). Runs on `device`: CUDA unless the
    caller asks for another; on the CPU it is the plain Philox."""
    device = resolve_device(device)
    masks = philox.dump_masks(seed, shape, rate, device)
    if device.type == 'cuda':
        dropout_masks.launches += 1
    return masks


fused_transformer_block.launches = 0
fused_transformer_block.bwd_launches = 0
dropout_masks.launches = 0
