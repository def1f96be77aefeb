"""Graph neural network over the molecular bond graph (torch.nn).

Counterpart of `grappa_tpu.models.gnn`: each node gathers its neighbors from
a fixed-width padded neighbor list and attends over that static axis. Module
names follow the reference (graph_attention.py:48-415) so a reference-named
state_dict loads strictly:

  * NeighborAttention == DGL DotGatConv (`graph_module.fc`): one shared
    bias-free projection, dot scores / sqrt(d_head), softmax over the
    incoming neighbors (no self loop), message = projected neighbor feature.
  * SAGEConv (mean aggregator; `fc_self`, `fc_neigh`) for the conv blocks.
  * ResidualAttentionBlock: `layer_norm`, `graph_module`, `head_reducer`,
    `interaction_norm`, `self_interaction` (Linear, ELU, Linear, ELU).

With `fused` on (True, or 'auto' for CUDA inputs) an attention block runs
everything after the neighbor gather through `ops.fused_gnn.fused_gnn_block`
(the CUDA kernels on the card, its plain version on the CPU). In training
mode every dropout draws from the `generator` the forward takes: a fused
block one seed per call for its two in-kernel masks, as the JAX package
draws one key per fused block.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from grappa_tpu_torch import constants
from grappa_tpu_torch.models.layers import (
    ChargeEncoding, Dropout, make_norm, masked_softmax,
    repeat_interleave_skip, use_fused, zero_init)
from grappa_tpu_torch.ops import philox
from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block

Generator = Optional[torch.Generator]


class NeighborAttention(nn.Module):
    """Dot-product graph attention over a padded neighbor list."""

    def __init__(self, in_feats: int, out_feats: int, num_heads: int):
        super().__init__()
        self.fc = nn.Linear(in_feats, out_feats, bias=False)
        self.num_heads = num_heads

    def forward(self, h, neighbors, neighbor_mask):
        # h: (N, F); neighbors: (N, D) int64; neighbor_mask: (N, D) bool
        feat = self.fc(h)
        n, f = feat.shape
        dh = f // self.num_heads
        feat = feat.reshape(n, self.num_heads, dh)
        nbr_feat = feat[neighbors]                              # (N, D, H, dh)
        scores = torch.einsum('nhd,nkhd->nkh', feat, nbr_feat) / math.sqrt(dh)
        alpha = masked_softmax(scores, neighbor_mask[:, :, None], dim=1)
        out = torch.einsum('nkh,nkhd->nhd', alpha, nbr_feat)
        return out.reshape(n, f)


class SAGEConv(nn.Module):
    """GraphSAGE with mean aggregation over the padded neighbor list."""

    def __init__(self, in_feats: int, out_feats: int):
        super().__init__()
        self.fc_self = nn.Linear(in_feats, out_feats, bias=False)
        self.fc_neigh = nn.Linear(in_feats, out_feats)

    def forward(self, h, neighbors, neighbor_mask):
        m = neighbor_mask.to(h.dtype)
        nbr = h[neighbors] * m[:, :, None]
        count = m.sum(dim=1, keepdim=True).clamp_min(1.0)
        return self.fc_self(h) + self.fc_neigh(nbr.sum(dim=1) / count)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, feats: int, num_heads: int, dropout: float = 0.0,
                 layer_norm: bool = True, self_interaction: bool = True,
                 zero_init_residual: bool = True, fused=False):
        super().__init__()
        self.layer_norm = make_norm(feats, layer_norm)
        self.graph_module = NeighborAttention(feats, feats, num_heads)
        self.head_reducer = nn.Linear(feats, feats)
        if self_interaction:
            self.interaction_norm = make_norm(feats, layer_norm)
            self.self_interaction = nn.Sequential(
                nn.Linear(feats, 4 * feats), nn.ELU(),
                nn.Linear(4 * feats, feats), nn.ELU())
        if zero_init_residual:
            zero_init(self.head_reducer)
            if self_interaction:
                zero_init(self.self_interaction[2])
        self.dropout = Dropout(dropout)
        self.num_heads = num_heads
        self.has_self_interaction = self_interaction
        # the kernel covers the block with both layer norms and the FF
        self.fused = fused if layer_norm and self_interaction else False

    def forward(self, h, neighbors, neighbor_mask,
                generator: Generator = None):
        if use_fused(self.fused, h):
            return self._fused(h, neighbors, neighbor_mask, generator)
        h = self.layer_norm(h)
        h_skip = h
        a = self.graph_module(h, neighbors, neighbor_mask)
        h = self.dropout(self.head_reducer(a), generator) + h_skip
        if self.has_self_interaction:
            h = self.interaction_norm(h)
            h = self.dropout(self.self_interaction(h), generator) + h
        return h

    def fused_params(self):
        """The tensors `ops.fused_gnn.fused_gnn_block` takes, in order."""
        si = self.self_interaction
        return (self.head_reducer.weight, self.head_reducer.bias,
                self.interaction_norm.weight, self.interaction_norm.bias,
                si[0].weight, si[0].bias, si[2].weight, si[2].bias)

    def _fused(self, h, neighbors, neighbor_mask, generator: Generator):
        """The pre-LN, the fc projection and the gather stay here (as in the
        JAX package); everything after the gather is one fused op."""
        hn = self.layer_norm(h)
        feat = self.graph_module.fc(hn)
        nbr = feat[neighbors.t()].contiguous()                    # (D, N, F)
        mask = neighbor_mask.t().to(feat.dtype).contiguous()      # (D, N)
        seed = philox.seed_for(self.dropout.p, self.training, generator)
        return fused_gnn_block(feat, nbr, hn, mask, self.fused_params(),
                               self.num_heads, self.dropout.p, self.training,
                               seed)


class ResidualConvBlock(nn.Module):
    def __init__(self, feats: int, dropout: float = 0.0,
                 layer_norm: bool = True, self_interaction: bool = True):
        super().__init__()
        self.layer_norm = make_norm(feats, layer_norm)
        self.graph_module = SAGEConv(feats, feats)
        if self_interaction:
            self.interaction_norm = make_norm(feats, layer_norm)
            self.self_interaction = nn.Sequential(nn.Linear(feats, feats),
                                                  nn.ELU())
        self.dropout = Dropout(dropout)
        self.has_self_interaction = self_interaction

    def forward(self, h, neighbors, neighbor_mask,
                generator: Generator = None):
        h = self.layer_norm(h)
        h_skip = h
        x = F.elu(self.graph_module(h, neighbors, neighbor_mask))
        h = (self.dropout(x, generator)
             + repeat_interleave_skip(h_skip, h.shape[-1]))
        if self.has_self_interaction:
            h = self.interaction_norm(h)
            h = self.dropout(self.self_interaction(h), generator) + h
        return h


def input_width(in_feat_names: Sequence[str],
                charge_encoding: bool = True) -> int:
    """Width of the concatenated per-atom input features (torch modules
    need it at construction; flax infers it at init)."""
    return (sum(constants.FEATURE_DIMS[n] for n in in_feat_names)
            + (16 if charge_encoding else 0))


class GrappaGNN(nn.Module):
    """Atom embedder: feature concat (+ charge encoding) -> pre-dense ->
    conv blocks -> attention blocks -> post-dense."""

    def __init__(self, out_feats: int = 256, node_feats: int = 512,
                 n_conv: int = 0, n_att: int = 7, n_heads: int = 16,
                 in_feat_names: Sequence[str] = (
                     'atomic_number', 'partial_charge', 'ring_encoding',
                     'degree', 'charge_model'),
                 charge_encoding: bool = True, conv_dropout: float = 0.0,
                 attention_dropout: float = 0.0,
                 initial_dropout: float = 0.0, final_dropout: float = 0.0,
                 layer_norm: bool = True, self_interaction: bool = True,
                 fused=False):
        super().__init__()
        self.in_feat_names = tuple(in_feat_names)
        self.charge_encoder = ChargeEncoding() if charge_encoding else None
        self.pre_dense = nn.Sequential(
            nn.Linear(input_width(in_feat_names, charge_encoding),
                      node_feats),
            nn.ELU(), Dropout(initial_dropout))
        self.conv_blocks = nn.ModuleList([
            ResidualConvBlock(node_feats, conv_dropout, layer_norm,
                              self_interaction) for _ in range(n_conv)])
        self.att_blocks = nn.ModuleList([
            ResidualAttentionBlock(node_feats, n_heads, attention_dropout,
                                   layer_norm, self_interaction, fused=fused)
            for _ in range(n_att)])
        self.post_dense = nn.Sequential(nn.Linear(node_feats, out_feats),
                                        Dropout(final_dropout))
        # the reference registers `blocks = conv_blocks + att_blocks`, which
        # aliases every block under gnn.blocks.{i} in the state_dict
        if n_conv + n_att > 0:
            self.blocks = self.conv_blocks + self.att_blocks

    def forward(self, feats: Dict[str, torch.Tensor], neighbors,
                neighbor_mask, generator: Generator = None) -> torch.Tensor:
        cols = [feats[n] if feats[n].dim() >= 2 else feats[n][:, None]
                for n in self.in_feat_names]
        if self.charge_encoder is not None:
            cols.append(self.charge_encoder(feats['partial_charge']))
        dense, act, drop = self.pre_dense
        h = drop(act(dense(torch.cat(cols, dim=-1))), generator)
        for blk in self.conv_blocks:
            h = blk(h, neighbors, neighbor_mask, generator)
        for blk in self.att_blocks:
            h = blk(h, neighbors, neighbor_mask, generator)
        dense, drop = self.post_dense
        return drop(dense(h), generator)
