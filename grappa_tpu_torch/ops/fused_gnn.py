"""K1: the GNN residual-attention block after the neighbour gather.

Counterpart of `grappa_tpu/ops/fused_gnn.py::fused_gnn_block` (forward).
Everything after the gather `feat[neighbors]` runs as one op:

    scores -> masked softmax over neighbour slots -> weighted message sum
    -> head_reducer -> residual(+LN input) -> interaction LN
    -> FF(4F, elu) -> elu -> residual

The pre-LN, the `fc` projection and the gather stay outside (in
`models.gnn`), as in the JAX package.

On a CUDA tensor `fused_gnn_block` launches the hand-written kernel in
`csrc/fused_gnn.cu` (its note gives the card's bound and the design); on a
CPU tensor it runs `reference_gnn_block`, the plain PyTorch version of the
same function. `fused_gnn_block.launches` counts kernel launches.

Parameters are a tuple in torch Linear layout (weight (out, in)):
    (head_reducer.weight, head_reducer.bias, interaction_norm.weight,
     interaction_norm.bias, si_dense1.weight, si_dense1.bias,
     si_dense2.weight, si_dense2.bias)
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from grappa_tpu_torch.models.layers import LN_EPS
from grappa_tpu_torch.ops import _cuda

_NEG = -1e30
MAX_SLOTS = 8     # the kernel keeps the D slot scores in registers


def reference_gnn_block(feat, nbr, hn, mask, params: Sequence[torch.Tensor],
                        n_heads: int = 16) -> torch.Tensor:
    """Plain PyTorch version: feat (N, F), nbr (D, N, F), hn (N, F),
    mask (D, N) float -> (N, F)."""
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
    x1 = F.linear(attn0, wr, br) + hn
    x1n = F.layer_norm(x1, (f,), g2, b2, LN_EPS)
    e1 = F.elu(F.linear(x1n, w1, c1))
    return F.elu(F.linear(e1, w2, c2)) + x1n


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
    return n, f, d, hid


class _GnnBlockKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, nbr, hn, mask, n_heads, *params):
        (d, n, f), hid = nbr.shape, params[4].shape[0]
        lib = _cuda.lib()
        scratch = torch.empty(lib.grappa_fused_gnn_scratch(n, f, hid),
                              dtype=torch.float32, device=feat.device)
        y = torch.empty((n, f), dtype=torch.float32, device=feat.device)
        ptrs = [t.data_ptr() for t in (feat, nbr, hn, mask, *params)]
        rc = lib.grappa_fused_gnn_fwd(
            *ptrs, scratch.data_ptr(), y.data_ptr(), n, f, hid, d, n_heads,
            _cuda.head_scale(f // n_heads),
            torch.cuda.current_stream(feat.device).cuda_stream)
        _cuda.check(rc, 'grappa_fused_gnn_fwd')
        fused_gnn_block.launches += 1
        return y

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the fused GNN block kernel has no backward yet: it comes with "
            "the training slice of the port (ROADMAP.md, K1b)")


def fused_gnn_block(feat, nbr, hn, mask, params: Sequence[torch.Tensor],
                    n_heads: int = 16, dropout_rate: float = 0.0,
                    training: bool = False) -> torch.Tensor:
    """Post-gather half of a GNN ResidualAttentionBlock (see module doc).

    The kernel (and so this op) is deterministic: dropout in training mode
    raises until the training slice brings the kernel's dropout."""
    if training and dropout_rate > 0:
        raise NotImplementedError(
            "fused_gnn_block has no dropout yet (training slice of the port,"
            " ROADMAP.md K1b); use fused_gnn=False to train with dropout")
    params = tuple(params)
    _check(feat, nbr, hn, mask, params, n_heads)
    if not _cuda.on_cuda((feat, nbr, hn, mask, *params), 'fused_gnn_block'):
        return reference_gnn_block(feat, nbr, hn, mask, params, n_heads)
    d = nbr.shape[0]
    if not 1 <= d <= MAX_SLOTS:
        raise ValueError(f"the kernel takes 1..{MAX_SLOTS} neighbour slots, "
                         f"got {d}")
    return _GnnBlockKernel.apply(feat, nbr, hn, mask, n_heads, *params)


fused_gnn_block.launches = 0
