"""Permutation-symmetric parameter heads (torch.nn).

Counterpart of `grappa_tpu.models.heads`. One head per interaction type maps
the GNN atom embeddings of a tuple to MM parameters, invariant under the
tuple's symmetry permutations (reference: src/grappa/models/
perm_equiv_transformer.py:13-319, interaction_parameters.py:140-562):

  * RepProjector (`rep_projector.mlp.0`): Dense+ELU on atom embeddings, then
    a gather by tuple indices straight into the (S, T, F) layout
  * GrappaTransformer: a fixed-length transformer over the tuple axis with a
    permutation-invariant positional-encoding buffer
  * Symmetriser: a shared MLP over every allowed permutation of the
    flattened tuple features, summed -> exact invariance

With `fused` on (True, or 'auto' for CUDA inputs) the transformer blocks
run through `ops.fused_block.fused_transformer_block` and the symmetriser
through
`ops.fused_symmetriser.fused_symmetriser` (CUDA kernels on the card, their
plain versions on the CPU). In training mode every dropout draws from the
`generator` the forward takes: each fused transformer block one seed per
call, as the JAX package draws one key per fused block.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from grappa_tpu_torch.models import scalers
from grappa_tpu_torch.models.layers import (FeedForward, TransformerBlock,
                                            use_fused)
from grappa_tpu_torch.ops import philox
from grappa_tpu_torch.ops.fused_block import fused_transformer_block
from grappa_tpu_torch.ops.fused_symmetriser import (fused_symmetriser,
                                                    reference_symmetriser)

# symmetry permutation sets per interaction type
PERMUTATIONS = {
    'n2': ((0, 1), (1, 0)),
    'n3': ((0, 1, 2), (2, 1, 0)),
    'n4': ((0, 1, 2, 3), (3, 2, 1, 0)),
    'n4_improper': ((0, 1, 2, 3), (3, 1, 2, 0)),
}
# espaloma-style ablation: all central-atom-fixing permutations
WRONG_SYMMETRY_IMPROPER = ((0, 1, 2, 3), (3, 1, 2, 0), (1, 3, 2, 0),
                           (0, 3, 2, 1), (3, 0, 2, 1), (1, 0, 2, 3))

POSITIONAL_ENCODINGS = {
    'n2': None,
    'n3': ((0.0,), (1.0,), (0.0,)),
    'n4': ((0.0,), (1.0,), (1.0,), (0.0,)),
    'n4_improper': ((0.0,), (1.0,), (1.0,), (0.0,)),
}
WRONG_SYMMETRY_POS_ENC = ((0.0,), (0.0,), (1.0,), (0.0,))


class RepProjector(nn.Module):
    def __init__(self, in_feats: int, out_feats: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(in_feats, out_feats), nn.ELU())

    def forward(self, h, idxs):
        # h: (N, F_rep); idxs: (T, arity) -> (arity, T, F)
        return self.mlp(h)[idxs.t()].contiguous()


class GrappaTransformer(nn.Module):
    """Positional encoding + a stack of TransformerBlocks on (S, T, F)."""

    def __init__(self, feats: int, n_heads: int, hidden_feats: int,
                 n_layers: int, positional_encoding=None,
                 layer_norm: bool = True, dropout: float = 0.0,
                 fused=False):
        super().__init__()
        if positional_encoding is not None:
            self.register_buffer('positional_encoding', torch.tensor(
                positional_encoding, dtype=torch.float32))
        else:
            self.positional_encoding = None
        self.transformer = nn.ModuleList([
            TransformerBlock(feats, n_heads, hidden_feats, layer_norm,
                             dropout) for _ in range(n_layers)])
        self.fused = fused if layer_norm else False

    def forward(self, x, generator: Optional[torch.Generator] = None):
        fused = use_fused(self.fused, x)
        if self.positional_encoding is not None:
            pos = self.positional_encoding[:, None, :].expand(
                -1, x.shape[1], -1)
            x = torch.cat([x, pos], dim=-1)
        for blk in self.transformer:
            if fused:
                rate = blk.dropout.p
                x = fused_transformer_block(
                    x, blk.fused_params(), blk.num_heads, rate,
                    self.training,
                    philox.seed_for(rate, self.training, generator))
            else:
                x = blk(x, generator)
        return x


class Symmetriser(nn.Module):
    """Sum of a shared MLP over all symmetry-permuted copies of the tuple."""

    def __init__(self, in_feats: int, out_feats: int,
                 permutations: Sequence[Tuple[int, ...]], hidden_feats: int,
                 n_layers: int = 1, layer_norm: bool = True,
                 fused=False):
        super().__init__()
        self.perms = tuple(tuple(p) for p in permutations)
        # the reference registers the permutation set and its prefactors as
        # buffers (perm_equiv_transformer.py:318-319)
        self.register_buffer('permutations',
                             torch.tensor(self.perms, dtype=torch.int32))
        self.register_buffer('permutation_prefactors',
                             torch.ones(len(self.perms), dtype=torch.float32))
        width = in_feats * len(self.perms[0])
        last = n_layers - 1
        self.mlp = nn.ModuleList([
            FeedForward(width if i == 0 else hidden_feats, hidden_feats,
                        hidden_feats if i != last else out_feats,
                        skip=(0 < i < last), layer_norm=layer_norm)
            for i in range(n_layers)])
        self.fused = fused if layer_norm else False

    def forward(self, x):
        # x: (S, T, F) -> (T, out_feats); without layer norm the norm
        # parameters are None and the plain version skips the norm
        layers = [(getattr(m.norm1, 'weight', None),
                   getattr(m.norm1, 'bias', None), m.linear1.weight,
                   m.linear1.bias, m.linear2.weight, m.linear2.bias)
                  for m in self.mlp]
        if use_fused(self.fused, x):
            return fused_symmetriser(x, layers, self.perms)
        return reference_symmetriser(x, layers, self.perms)


class TupleHead(nn.Module):
    """Fixed-length transformer -> Symmetriser -> raw coefficients; the
    reference's SymmetrisedTransformer (the RepProjector belongs to the
    writer, as the reference names it)."""

    def __init__(self, proj_feats: int, n_layers: int, n_heads: int,
                 hidden_feats: int, symmetriser_layers: int,
                 symmetriser_feats: int, out_feats: int,
                 permutations: Sequence[Tuple[int, ...]],
                 positional_encoding=None, dropout: float = 0.0,
                 layer_norm: bool = True, fused=False):
        super().__init__()
        feats = proj_feats + (0 if positional_encoding is None
                              else len(positional_encoding[0]))
        self.grappa_transformer = GrappaTransformer(
            feats, n_heads, hidden_feats, n_layers, positional_encoding,
            layer_norm, dropout, fused)
        self.symmetriser = Symmetriser(
            feats, out_feats, permutations, symmetriser_feats,
            symmetriser_layers, layer_norm, fused)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.symmetriser(self.grappa_transformer(x, generator))


class HarmonicParameterHead(nn.Module):
    """Bond (arity 2) or angle (arity 3) head -> (k, eq) with scalers.

    eq uses to_positive for bonds and to_range(max=pi) for angles; k uses
    to_positive. Optional sigmoid gate on k (harmonic_gate)."""

    def __init__(self, term: str, rep_feats: int, transformer_width: int,
                 transformer_depth: int, n_heads: int,
                 symmetriser_depth: int, symmetriser_width: int,
                 k_mean: float, k_std: float, eq_mean: float, eq_std: float,
                 positional_encoding: bool = True, gate: bool = False,
                 dropout: float = 0.0, layer_norm: bool = True,
                 fused=False):
        super().__init__()
        self.term, self.gate = term, gate
        pos_enc = (POSITIONAL_ENCODINGS[term] if positional_encoding
                   else None)
        proj = transformer_width - (0 if pos_enc is None
                                    else len(pos_enc[0]))
        self.rep_projector = RepProjector(rep_feats, proj)
        head = TupleHead(proj, transformer_depth, n_heads, transformer_width,
                         symmetriser_depth, symmetriser_width, 2 + int(gate),
                         PERMUTATIONS[term], pos_enc, dropout, layer_norm,
                         fused)
        # reference module names: bond_model / angle_model
        self.model_name = 'bond_model' if term == 'n2' else 'angle_model'
        setattr(self, self.model_name, head)
        self.to_k = scalers.ToPositive(k_mean, k_std)
        self.to_eq = (scalers.ToPositive(eq_mean, eq_std) if term == 'n2'
                      else scalers.ToRange(math.pi, eq_std))

    def forward(self, h, idxs, generator: Optional[torch.Generator] = None):
        coeffs = getattr(self, self.model_name)(self.rep_projector(h, idxs),
                                                generator)
        k = self.to_k(coeffs[:, 1])
        if self.gate:
            k = k * scalers.sigmoid_gate(coeffs[:, 2])
        return k, self.to_eq(coeffs[:, 0])


class TorsionParameterHead(nn.Module):
    """Proper/improper head -> signed torsion amplitudes (T, n_periodicity)."""

    def __init__(self, term: str, rep_feats: int, n_periodicity: int,
                 transformer_width: int, transformer_depth: int,
                 n_heads: int, symmetriser_depth: int,
                 symmetriser_width: int, k_mean: Sequence[float],
                 k_std: Sequence[float], gated: bool = True,
                 positional_encoding: bool = True,
                 wrong_symmetry: bool = False, cutoff: float = 1e-4,
                 dropout: float = 0.0, layer_norm: bool = True,
                 fused=False):
        super().__init__()
        if wrong_symmetry and term == 'n4_improper':
            perms = WRONG_SYMMETRY_IMPROPER
            pos_enc = WRONG_SYMMETRY_POS_ENC if positional_encoding else None
        else:
            perms = PERMUTATIONS[term]
            pos_enc = (POSITIONAL_ENCODINGS[term] if positional_encoding
                       else None)
        proj = transformer_width - (0 if pos_enc is None
                                    else len(pos_enc[0]))
        n_out = 2 * n_periodicity if gated else n_periodicity
        self.rep_projector = RepProjector(rep_feats, proj)
        self.torsion_model = TupleHead(
            proj, transformer_depth, n_heads, transformer_width,
            symmetriser_depth, symmetriser_width, n_out, perms, pos_enc,
            dropout, layer_norm, fused)
        self.register_buffer('n_periodicity',
                             torch.tensor(n_periodicity, dtype=torch.int64))
        self.register_buffer('k_mean', torch.tensor(
            [list(k_mean)[:n_periodicity]], dtype=torch.float32))
        self.register_buffer('k_std', torch.tensor(
            [list(k_std)[:n_periodicity]], dtype=torch.float32))
        self.n_per, self.gated, self.cutoff = n_periodicity, gated, cutoff

    def forward(self, h, idxs, generator: Optional[torch.Generator] = None):
        coeffs = self.torsion_model(self.rep_projector(h, idxs), generator)
        if self.gated:
            gate = torch.sigmoid(coeffs[:, self.n_per:])
            # gated: no mean shift, so the gate can express exact zeros
            k = coeffs[:, :self.n_per] * gate * self.k_std
        else:
            k = coeffs * self.k_std + self.k_mean
        if self.cutoff > 0:
            k = scalers.hard_cutoff(k, self.cutoff)
        return k
