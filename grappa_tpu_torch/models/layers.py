"""Shared neural-network building blocks (torch.nn).

Counterparts of `grappa_tpu.models.layers`, named after the reference's torch
modules so that a reference-named state_dict loads strictly:
  * FeedForward == reference FeedForwardLayer (pre-LN `norm1`, one hidden
    layer, optional repeat-interleave skip that adds the *normalized* input)
  * SelfAttention == torch.nn.MultiheadAttention's packed `in_proj_weight`
    / `in_proj_bias` and `out_proj`, on the (S, T, F) layout
  * TransformerBlock == reference DottedAttWithMLP (pre-LN MHA + FF)
  * ChargeEncoding == the sinusoidal partial-charge encoding

LayerNorm uses eps=1e-5 as in the JAX package. Parameters are initialised
like flax's (`init_parameters`): LeCun-normal kernels, zero biases, and zero
branch outputs where the JAX package zero-initialises them. Dropout draws
its masks from an explicit `torch.Generator` passed down the forward
(`Dropout`, `ops.philox`), never from torch's global RNG.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from grappa_tpu_torch.ops import philox

LN_EPS = 1e-5

# flax's lecun_normal draws from a normal truncated at two standard
# deviations and rescales it so the variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over `dim` restricted to mask==True; all-masked rows -> 0."""
    neg = torch.finfo(logits.dtype).min / 2
    masked = logits.masked_fill(~mask, neg)
    shifted = masked - masked.amax(dim=dim, keepdim=True)
    weights = torch.exp(shifted) * mask.to(logits.dtype)
    denom = weights.sum(dim=dim, keepdim=True)
    return weights / denom.clamp_min(1e-9)


def repeat_interleave_skip(x_skip: torch.Tensor, out_feats: int
                           ) -> torch.Tensor:
    """Repeat-interleave the feature axis so a skip connection fits."""
    in_feats = x_skip.shape[-1]
    if out_feats == in_feats:
        return x_skip
    return x_skip.repeat_interleave(out_feats // in_feats, dim=-1)


def use_fused(flag, x: torch.Tensor) -> bool:
    """Resolve a fused_gnn / fused_heads flag for input x: 'auto' means the
    fused ops whenever x lies on a CUDA device."""
    return x.is_cuda if flag == 'auto' else bool(flag)


def make_norm(feats: int, enabled: bool = True) -> nn.Module:
    return nn.LayerNorm(feats, eps=LN_EPS) if enabled else nn.Identity()


def zero_init(linear: nn.Linear) -> nn.Linear:
    """Mark a branch-output layer to start at zero (ReZero/Fixup-style, as
    the JAX package's zero_init_residual)."""
    linear.zero_init = True
    return linear


@torch.no_grad()
def init_parameters(module: nn.Module,
                    generator: Optional[torch.Generator] = None) -> None:
    """flax-style initialisation of every Linear / SelfAttention /
    LayerNorm below `module`, drawn from `generator`."""
    def lecun_(w):
        std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)

    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            if getattr(mod, 'zero_init', False):
                mod.weight.zero_()
            else:
                lecun_(mod.weight)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, SelfAttention):
            lecun_(mod.in_proj_weight)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


class Dropout(nn.Module):
    """Dropout whose mask comes from a seed drawn from the generator the
    forward passes (`ops.philox.dropout`); the identity in eval mode."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        philox.check_rate(p)
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return philox.dropout(x, self.p, self.training, generator)


class FeedForward(nn.Module):
    """Pre-LN MLP with one hidden layer, optional skip (repeat-interleave).
    The skip adds the *normalized* input, as the JAX FeedForward does."""

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int,
                 skip: bool = False, layer_norm: bool = True,
                 dropout: float = 0.0, zero_init_out: bool = False):
        super().__init__()
        self.norm1 = make_norm(in_feats, layer_norm)
        self.linear1 = nn.Linear(in_feats, hidden_feats)
        self.linear2 = nn.Linear(hidden_feats, out_feats)
        if zero_init_out:
            zero_init(self.linear2)
        self.dropout = Dropout(dropout)
        self.skip = skip
        self.out_feats = out_feats

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.norm1(x)
        h = self.dropout(self.linear2(F.elu(self.linear1(x))), generator)
        if self.skip:
            h = h + repeat_interleave_skip(x, self.out_feats)
        return h


class SelfAttention(nn.Module):
    """Multi-head self-attention over the tuple axis S of x (S, T, F), with
    torch.nn.MultiheadAttention's packed parameter names."""

    def __init__(self, feats: int, num_heads: int,
                 zero_init_out: bool = False):
        super().__init__()
        if feats % num_heads:
            raise ValueError(f"feature width {feats} must be divisible by "
                             f"num_heads={num_heads}")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * feats, feats))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * feats))
        self.out_proj = nn.Linear(feats, feats)
        if zero_init_out:
            zero_init(self.out_proj)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, t, f = x.shape
        dh = f // self.num_heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (a.reshape(s, t, self.num_heads, dh)
                   for a in qkv.split(f, dim=-1))
        logits = torch.einsum('sthd,uthd->thsu', q, k) / math.sqrt(dh)
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum('thsu,uthd->sthd', weights, v).reshape(s, t, f)
        return self.out_proj(out)


class TransformerBlock(nn.Module):
    """Pre-LN self-attention + feed-forward block (DottedAttWithMLP) on
    x (S, T, F). zero_init_residual starts every branch output at zero so
    the deep stack is the identity at initialization."""

    def __init__(self, feats: int, num_heads: int, hidden_feats: int,
                 layer_norm: bool = True, dropout: float = 0.0,
                 zero_init_residual: bool = True):
        super().__init__()
        self.norm1 = make_norm(feats, layer_norm)
        self.attn = SelfAttention(feats, num_heads,
                                  zero_init_out=zero_init_residual)
        self.ff = FeedForward(feats, hidden_feats, feats, skip=True,
                              layer_norm=layer_norm, dropout=dropout,
                              zero_init_out=zero_init_residual)
        self.dropout = Dropout(dropout)
        self.num_heads = num_heads

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.norm1(x)
        x = self.dropout(self.attn(x), generator) + x
        return self.ff(x, generator)

    def fused_params(self):
        """The block's tensors in the order `ops.fused_block` takes them."""
        ff = self.ff
        return (self.norm1.weight, self.norm1.bias, self.attn.in_proj_weight,
                self.attn.in_proj_bias, self.attn.out_proj.weight,
                self.attn.out_proj.bias, ff.norm1.weight, ff.norm1.bias,
                ff.linear1.weight, ff.linear1.bias, ff.linear2.weight,
                ff.linear2.bias)


class ChargeEncoding(nn.Module):
    """Sinusoidal encoding of partial charges clamped to [-2, 2]."""

    def __init__(self, dimension: int = 16, min_value: float = -2.0,
                 max_value: float = 2.0):
        super().__init__()
        self.dimension = dimension
        self.min_value, self.max_value = min_value, max_value

    def forward(self, values: torch.Tensor) -> torch.Tensor:
        values = values.clamp(self.min_value, self.max_value)
        scaled = (values + self.max_value) / (self.max_value - self.min_value)
        half = self.dimension // 2
        freqs = torch.exp(
            torch.arange(half, dtype=torch.float32, device=values.device)
            * (-math.log(10000.0) / half))
        args = scaled[:, None] * freqs[None, :]
        enc = torch.zeros(values.shape[0], self.dimension,
                          dtype=torch.float32, device=values.device)
        enc[:, 0::2] = torch.sin(args)
        enc[:, 1::2] = torch.cos(args)
        return enc
