"""K2: one tuple-head TransformerBlock on x (S, T, F).

Counterpart of `grappa_tpu/ops/fused_block.py::fused_transformer_block`
(forward): pre-LN packed-QKV multi-head attention across the S slots of each
tuple + residual onto the LN1 output, then pre-LN FF (elu) + residual onto
the LN2 output, as one op on the (S, T, F) layout.

On a CUDA tensor `fused_transformer_block` launches the hand-written kernel
in `csrc/fused_block.cu` (its note gives the card's bound and the design);
on a CPU tensor it runs `reference_block`, the plain PyTorch version of the
same function. `fused_transformer_block.launches` counts kernel launches.

Parameters are a tuple in torch layout (`TransformerBlock.fused_params()`):
    (norm1.weight, norm1.bias, attn.in_proj_weight, attn.in_proj_bias,
     attn.out_proj.weight, attn.out_proj.bias, ff.norm1.weight,
     ff.norm1.bias, ff.linear1.weight, ff.linear1.bias, ff.linear2.weight,
     ff.linear2.bias)
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from grappa_tpu_torch.models.layers import LN_EPS
from grappa_tpu_torch.ops import _cuda

ARITIES = (2, 3, 4)   # the kernel is instantiated for these tuple sizes


def reference_block(x, params: Sequence[torch.Tensor],
                    n_heads: int = 8) -> torch.Tensor:
    """Plain PyTorch version on x (S, T, F) -> (S, T, F)."""
    g1, b1, wq, bq, wo, bo, g2, b2, w1, c1, w2, c2 = params
    s, t, f = x.shape
    dh = f // n_heads
    xn = F.layer_norm(x, (f,), g1, b1, LN_EPS)
    q, k, v = (a.reshape(s, t, n_heads, dh)
               for a in F.linear(xn, wq, bq).split(f, dim=-1))
    logits = torch.einsum('sthd,uthd->thsu', q, k) * _cuda.head_scale(dh)
    w = torch.softmax(logits, dim=-1)
    attn0 = torch.einsum('thsu,uthd->sthd', w, v).reshape(s, t, f)
    x1 = F.linear(attn0, wo, bo) + xn
    x1n = F.layer_norm(x1, (f,), g2, b2, LN_EPS)
    return F.linear(F.elu(F.linear(x1n, w1, c1)), w2, c2) + x1n


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
    def forward(ctx, x, n_heads, *params):
        (s, t, f), hid = x.shape, params[8].shape[0]
        lib = _cuda.lib()
        scratch = torch.empty(lib.grappa_fused_block_scratch(s, t, f, hid),
                              dtype=torch.float32, device=x.device)
        y = torch.empty_like(x)
        rc = lib.grappa_fused_block_fwd(
            x.data_ptr(), *[p.data_ptr() for p in params],
            scratch.data_ptr(), y.data_ptr(), s, t, f, hid, n_heads,
            _cuda.head_scale(f // n_heads),
            torch.cuda.current_stream(x.device).cuda_stream)
        _cuda.check(rc, 'grappa_fused_block_fwd')
        fused_transformer_block.launches += 1
        return y

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the fused transformer block kernel has no backward yet: it "
            "comes with the training slice of the port (ROADMAP.md, K2b)")


def fused_transformer_block(x, params: Sequence[torch.Tensor],
                            n_heads: int = 8, dropout_rate: float = 0.0,
                            training: bool = False) -> torch.Tensor:
    """One TransformerBlock on x (S, T, F) (see module doc). Deterministic:
    dropout in training mode raises until the training slice."""
    if training and dropout_rate > 0:
        raise NotImplementedError(
            "fused_transformer_block has no dropout yet (training slice of "
            "the port, ROADMAP.md K2b); use fused_heads=False to train with "
            "dropout")
    params = tuple(params)
    _check(x, params, n_heads)
    if not _cuda.on_cuda((x, *params), 'fused_transformer_block'):
        return reference_block(x, params, n_heads)
    if x.shape[0] not in ARITIES:
        raise ValueError(f"the kernel takes tuples of {ARITIES} slots, got "
                         f"S={x.shape[0]}")
    return _BlockKernel.apply(x, n_heads, *params)


fused_transformer_block.launches = 0
