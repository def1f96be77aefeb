"""Differentiable classical MM bonded energy over a GraphBatch.

Counterpart of `grappa_tpu.models.mm_energy`: harmonic bond / angle terms
0.5*k*(x - eq)^2, periodic torsions sum_n k_n cos(n*phi) with signed k
(phase folded into the sign), per-molecule pooling, and the gradient of the
total energy with respect to the coordinates. Pooling is `index_add` into
num_mols + 1 segments, the last (padding's) dropped. The gradient comes
from `torch.autograd.grad(..., create_graph=True)` whenever the parameters
require grad, so a loss on it trains the parameter model (double
backward).

Parameter convention: a dict keyed like the model output --
  n2_k (B,), n2_eq (B,), n3_k (A,), n3_eq (A,),
  n4_k (P, n_per) signed, n4_improper_k (I, n_per) signed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from grappa_tpu_torch.data.graph_batch import GraphBatch
from grappa_tpu_torch.models import geometry

ParamDict = Dict[str, torch.Tensor]
TORSIONS = ('n4', 'n4_improper')


def harmonic_term_energy(k: torch.Tensor, eq: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """0.5 * k * (x - eq)^2 per tuple / conformer; k, eq: (T,), x: (T, C)."""
    return 0.5 * k[:, None] * torch.square(x - eq[:, None])


def torsion_term_energy(signed_k: torch.Tensor, phi: torch.Tensor,
                        offset: bool = False) -> torch.Tensor:
    """sum_n k_n cos(n*phi) (+ |k_n| if offset) per tuple / conformer.

    signed_k: (T, P) with periodicity n = column index + 1; phi: (T, C).
    cos(n*phi) comes from the Chebyshev recurrence on cos(phi)."""
    n_per = signed_k.shape[1]
    cos_phi = torch.cos(phi)
    c_prev, c_cur = torch.ones_like(cos_phi), cos_phi
    energy = signed_k[:, 0][:, None] * c_cur
    for n in range(2, n_per + 1):
        c_prev, c_cur = c_cur, 2.0 * cos_phi * c_cur - c_prev
        energy = energy + signed_k[:, n - 1][:, None] * c_cur
    if offset:
        energy = energy + signed_k.abs().sum(dim=1)[:, None]
    return energy


def _points(xyz: torch.Tensor, idxs: torch.Tensor):
    return [xyz[idxs[:, j]] for j in range(idxs.shape[1])]


def internal_coordinates(batch: GraphBatch,
                         xyz: torch.Tensor) -> Dict[str, torch.Tensor]:
    """x (T, C) per interaction term from coordinates (N, C, 3)."""
    coords = {
        'n2': geometry.distance(*_points(xyz, batch.terms['n2'].idxs)),
        'n3': geometry.bond_angle(*_points(xyz, batch.terms['n3'].idxs)),
    }
    for t in TORSIONS:
        coords[t] = geometry.dihedral_angle(*_points(xyz,
                                                     batch.terms[t].idxs))
    return coords


def tuple_energies(batch: GraphBatch, params: ParamDict, xyz: torch.Tensor,
                   offset_torsion: bool = False,
                   use_fused_torsion: bool = False) -> Dict[str, torch.Tensor]:
    """Masked per-tuple energies (T, C) for every term."""
    if use_fused_torsion:
        raise NotImplementedError(
            "use_fused_torsion: the torsion kernel is not ported yet "
            "(ROADMAP.md, K5); the Chebyshev path computes the same energy")
    x = internal_coordinates(batch, xyz)
    energies = {t: harmonic_term_energy(params[f'{t}_k'], params[f'{t}_eq'],
                                        x[t]) for t in ('n2', 'n3')}
    for t in TORSIONS:
        energies[t] = torsion_term_energy(params[f'{t}_k'], x[t],
                                          offset_torsion)
    return {t: torch.where(batch.terms[t].mask[:, None], e,
                           torch.zeros_like(e))
            for t, e in energies.items()}


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_mols: int) -> torch.Tensor:
    """Sum of rows per segment id over num_mols + 1 segments (the last
    collects the padding), the last dropped."""
    out = values.new_zeros((num_mols + 1, *values.shape[1:]))
    return out.index_add(0, seg.long(), values)[:num_mols]


def pooled_energy(batch: GraphBatch, params: ParamDict, xyz: torch.Tensor,
                  offset_torsion: bool = False,
                  use_fused_torsion: bool = False) -> Dict[str, torch.Tensor]:
    """Per-molecule energies (M, C) per term plus 'energy' (the total)."""
    energies = tuple_energies(batch, params, xyz, offset_torsion,
                              use_fused_torsion)
    out = {}
    total = xyz.new_zeros((batch.num_mols, xyz.shape[1]))
    for t, e in energies.items():
        pooled = segment_sum(e, batch.terms[t].mol, batch.num_mols)
        out[f'energy_{t}'] = pooled
        total = total + pooled
    out['energy'] = total
    return out


def energy_and_gradient(batch: GraphBatch, params: ParamDict,
                        offset_torsion: bool = False,
                        use_fused_torsion: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Total bonded energy (M, C) and its gradient w.r.t. xyz (N, C, 3).

    The gradient is dE/dx, NOT the force -dE/dx (the reference's 'gradient'
    convention). When any parameter requires grad it is differentiable
    w.r.t. the parameters (create_graph), so a loss on it trains the model
    through a double backward."""
    create = any(p.requires_grad for p in params.values())
    with torch.enable_grad():
        xyz = batch.xyz.detach().requires_grad_(True)
        energy = pooled_energy(batch, params, xyz, offset_torsion,
                               use_fused_torsion)['energy']
        (gradient,) = torch.autograd.grad(energy.sum(), xyz,
                                          create_graph=create)
    return (energy if create else energy.detach()), gradient


def centered(energy: torch.Tensor, conf_mask: torch.Tensor) -> torch.Tensor:
    """Subtract each molecule's mean over valid conformers; zero where
    masked."""
    conf_mask = conf_mask.to(energy.dtype)
    count = conf_mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    mean = (energy * conf_mask).sum(dim=1, keepdim=True) / count
    return (energy - mean) * conf_mask
