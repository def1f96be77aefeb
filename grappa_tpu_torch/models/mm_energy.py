"""Differentiable classical MM bonded energy over a GraphBatch.

Counterpart of `grappa_tpu.models.mm_energy`: harmonic bond / angle terms
0.5*k*(x - eq)^2, periodic torsions sum_n k_n cos(n*phi) with signed k
(phase folded into the sign), per-molecule pooling, and the gradient of the
total energy with respect to the coordinates. Pooling is `index_add` into
num_mols + 1 segments, the last (padding's) dropped. The gradient comes
from `torch.autograd.grad(..., create_graph=True)` whenever the parameters
require grad, so a loss on it trains the parameter model (double
backward). `use_fused_torsion=True` computes the torsion terms with the
torsion kernel K5 (`ops.torsion_kernel`), whose backward is differentiable
too.

On an atom-sharded batch (`parallel.sp`: the rank's node rows and tuples,
`batch.shard` set) `energy_and_gradient` computes the rank's tuples'
energies on the all-gathered positions and all-reduces the per-molecule
sums; dE/dx of the rank's tuples is taken on all positions, all-reduced,
and the rank's rows kept (`sharded_energy_and_gradient`).

Parameter convention: a dict keyed like the model output --
  n2_k (B,), n2_eq (B,), n3_k (A,), n3_eq (A,),
  n4_k (P, n_per) signed, n4_improper_k (I, n_per) signed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from grappa_tpu_torch.data.graph_batch import GraphBatch
from grappa_tpu_torch.models import geometry
from grappa_tpu_torch.ops.torsion_kernel import (gather_torsion_positions,
                                                 torsion_energy_fused)

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
    """x (T, C) of every term from coordinates (N, C, 3): the bond lengths,
    the bond angles and the proper and improper dihedrals."""
    coords = {'n2': geometry.distance(*_points(xyz, batch.terms['n2'].idxs)),
              'n3': geometry.bond_angle(*_points(xyz,
                                                 batch.terms['n3'].idxs))}
    for t in TORSIONS:
        coords[t] = geometry.dihedral_angle(*_points(xyz,
                                                     batch.terms[t].idxs))
    return coords


def tuple_energies(batch: GraphBatch, params: ParamDict, xyz: torch.Tensor,
                   offset_torsion: bool = False,
                   use_fused_torsion: bool = False) -> Dict[str, torch.Tensor]:
    """Masked per-tuple energies (T, C) for every term.

    use_fused_torsion routes the torsion terms through the torsion kernel
    K5 and its backward K5b (`ops.torsion_kernel`, launched on CUDA
    tensors); with offset_torsion=True they take the Chebyshev path, as in
    the JAX package. It stays the caller's choice and off by default, as
    in the JAX package (PERF.md §6 times energy + dE/dx with and without
    it)."""
    energies = {
        'n2': harmonic_term_energy(params['n2_k'], params['n2_eq'],
                                   geometry.distance(*_points(
                                       xyz, batch.terms['n2'].idxs))),
        'n3': harmonic_term_energy(params['n3_k'], params['n3_eq'],
                                   geometry.bond_angle(*_points(
                                       xyz, batch.terms['n3'].idxs))),
    }
    for t in TORSIONS:
        tb = batch.terms[t]
        if use_fused_torsion and not offset_torsion:
            k = torch.where(tb.mask[:, None], params[f'{t}_k'],
                            torch.zeros_like(params[f'{t}_k']))
            energies[t] = torsion_energy_fused(
                gather_torsion_positions(xyz, tb.idxs), k)
        else:
            energies[t] = torsion_term_energy(
                params[f'{t}_k'],
                geometry.dihedral_angle(*_points(xyz, tb.idxs)),
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
    through a double backward. On an atom-sharded batch: the energy of
    the whole molecules and the rank's rows of dE/dx (module doc)."""
    create = any(p.requires_grad for p in params.values())
    if batch.shard is not None:
        return sharded_energy_and_gradient(batch, params, batch.xyz, create,
                                           offset_torsion, use_fused_torsion)
    with torch.enable_grad():
        xyz = batch.xyz.detach().requires_grad_(True)
        energy = pooled_energy(batch, params, xyz, offset_torsion,
                               use_fused_torsion)['energy']
        (gradient,) = torch.autograd.grad(energy.sum(), xyz,
                                          create_graph=create)
    return (energy if create else energy.detach()), gradient


def sharded_energy_and_gradient(batch: GraphBatch, params: ParamDict,
                                xyz: torch.Tensor, create: bool = False,
                                offset_torsion: bool = False,
                                use_fused_torsion: bool = False
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Energy (M, C) and the rank's rows of dE/dx at positions `xyz` (the
    rank's rows) of an atom-sharded batch: the rank's tuples on the
    all-gathered positions, the per-molecule energies and dE/dx all-reduced
    (differentiable collectives, so `create` trains through them)."""
    shard = batch.shard
    with torch.enable_grad():
        x_all = shard.gather_nodes(xyz.detach()).requires_grad_(True)
        part = pooled_energy(batch, params, x_all, offset_torsion,
                             use_fused_torsion)['energy']
        (g_all,) = torch.autograd.grad(part.sum(), x_all,
                                       create_graph=create)
        energy = shard.all_reduce(part)
        gradient = shard.local_nodes(shard.all_reduce(g_all))
    if not create:
        energy, gradient = energy.detach(), gradient.detach()
    return energy, gradient


def centered(energy: torch.Tensor, conf_mask: torch.Tensor) -> torch.Tensor:
    """Subtract each molecule's mean over valid conformers; zero where
    masked."""
    conf_mask = conf_mask.to(energy.dtype)
    count = conf_mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    mean = (energy * conf_mask).sum(dim=1, keepdim=True) / count
    return (energy - mean) * conf_mask
