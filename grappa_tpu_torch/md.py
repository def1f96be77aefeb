"""Molecular dynamics on grappa-predicted bonded parameters.

Counterpart of `grappa_tpu.md`: velocity-Verlet NVE, or BAOAB Langevin with
the O-step's exact Ornstein-Uhlenbeck coefficients, and gradient-descent
minimisation. The batch's conformer axis carries C independent replicas
(every energy and force op is conformer-parallel). Forces are -dE/dx of
`mm_energy.pooled_energy` with its default path, as in the JAX package.

Where the JAX package scans a jitted step, this runs a Python loop of
steps on the batch's device. Energies and kinetic energies go into
preallocated device tensors, so a step never waits for the host. No
autograd graph is kept across steps: the parameters enter detached and each
force is a fresh first-order gradient. Randomness comes from an explicit
`torch.Generator` on the batch's device; its numbers are not JAX's, so
Langevin runs are compared with the JAX package statistically.

An atom-sharded batch (`parallel.sp.shard_batch_by_atoms`, as the JAX
package's md.py documents) runs the same loop on every rank of its mesh:
each rank integrates its rows of the positions and velocities, the forces
come from `mm_energy.sharded_energy_and_gradient` (the rank's tuples on the
all-gathered positions, all-reduced), kinetic energies are all-reduced,
and every random draw is of the whole array with the rank's rows kept, so
the sharded run follows the unsharded one. Masses, xyz0 and v0 may be given
whole (N) or as the rank's rows; the returned positions, velocities and
trajectory are the rank's rows, the energies the whole molecules'.

Units follow the grappa convention (kcal/mol, Angstrom, amu); time is
handled in femtoseconds and converted to the internal unit
sqrt(amu*A^2/(kcal/mol)) ~= 48.89 fs.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from grappa_tpu_torch.constants import ATOMIC_MASSES
from grappa_tpu_torch.data.graph_batch import GraphBatch
from grappa_tpu_torch.models import mm_energy
from grappa_tpu_torch.utils import resolve_device

# 1 internal time unit = sqrt(amu * A^2 / (kcal/mol)) in femtoseconds
TIME_UNIT_FS = 48.88821
# Boltzmann constant [kcal/mol/K]
KB = 0.001987204259


def masses_from_molecules(molecules: Sequence, n_pad: int,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> torch.Tensor:
    """Per-node masses (amu) for a batch collated from `molecules` in
    order (collate packs atoms contiguously); padded nodes get mass 1. On
    `device` (CUDA unless the caller asks for another)."""
    m = np.ones(n_pad, np.float32)
    off = 0
    for mol in molecules:
        zs = np.asarray(mol.atomic_numbers)
        m[off:off + len(zs)] = [ATOMIC_MASSES[int(z)] for z in zs]
        off += len(zs)
    return torch.from_numpy(m).to(resolve_device(device))


def make_force_fn(batch: GraphBatch, params):
    """(N, C, 3) xyz -> (forces (N, C, 3), potential (M, C)), both
    detached."""
    params = {k: v.detach() for k, v in params.items()}
    if batch.shard is not None:
        def sharded_force(xyz):
            e, g = mm_energy.sharded_energy_and_gradient(batch, params, xyz)
            return -g, e
        return sharded_force

    def force(xyz):
        with torch.enable_grad():
            x = xyz.detach().requires_grad_(True)
            e = mm_energy.pooled_energy(batch, params, x)['energy']
            (g,) = torch.autograd.grad(e.sum(), x)
        return -g, e.detach()

    return force


def kinetic_energy(batch: GraphBatch, masses: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Per-molecule kinetic energy (M, C) from velocities (N, C, 3)."""
    ke_atom = 0.5 * masses[:, None] * torch.sum(v * v, dim=-1)   # (N, C)
    ke_atom = ke_atom * batch.node_mask[:, None]
    ke = mm_energy.segment_sum(ke_atom, batch.node_mol, batch.num_mols)
    return ke if batch.shard is None else batch.shard.all_reduce(ke)


def _randn(batch: GraphBatch, shape, generator: torch.Generator,
           device) -> torch.Tensor:
    """Standard normal noise of `shape` (a node-indexed array): on a shard
    the whole array's draw, the rank's rows kept."""
    if batch.shard is None:
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)
    full = torch.randn((batch.shard.n_nodes, *shape[1:]), generator=generator,
                       dtype=torch.float32, device=device)
    return batch.shard.local_nodes(full)


def _rows(batch: GraphBatch, t: Optional[torch.Tensor]):
    """t's rows of the rank when t is a whole node-indexed array of a
    sharded batch; t itself otherwise."""
    if (t is None or batch.shard is None
            or t.shape[0] != batch.shard.n_nodes):
        return t
    return batch.shard.local_nodes(t)


def maxwell_boltzmann_velocities(batch: GraphBatch, masses: torch.Tensor,
                                 temperature: float,
                                 generator: torch.Generator) -> torch.Tensor:
    """Sample initial velocities at `temperature` K from `generator` (on
    the batch's device); padded nodes frozen."""
    sigma = torch.sqrt(KB * temperature / _rows(batch, masses))[:, None,
                                                                  None]
    noise = _randn(batch, batch.xyz.shape, generator, batch.xyz.device)
    return sigma * noise * batch.node_mask[:, None, None]


def simulate(batch: GraphBatch, params, masses: torch.Tensor,
             dt_fs: float = 0.5, n_steps: int = 1000,
             xyz0: Optional[torch.Tensor] = None,
             v0: Optional[torch.Tensor] = None,
             temperature: Optional[float] = None,
             friction_per_ps: float = 1.0,
             seed: int = 0,
             record_every: int = 0) -> Dict[str, torch.Tensor]:
    """Run MD on the predicted bonded force field on the batch's device.

    temperature=None: velocity-Verlet NVE. Otherwise: BAOAB Langevin at
    `temperature` K with `friction_per_ps` (1/ps) coupling, its noise (and
    the initial velocities when v0 is None) drawn from a generator seeded
    with `seed`. Every conformer column of xyz0 is an independent replica.

    record_every > 0 additionally returns 'trajectory'
    (n_steps // record_every, N, C, 3) -- positions every that many steps.

    Returns {'xyz', 'velocities', 'potential' (n_steps, M, C),
    'kinetic' (n_steps, M, C)[, 'trajectory']}.
    """
    n_frames = 0
    if record_every and record_every > 0:
        if n_steps % record_every:
            raise ValueError('n_steps must be a multiple of record_every')
        n_frames = n_steps // record_every
    x = (batch.xyz if xyz0 is None else _rows(batch, xyz0)).detach()
    device = x.device
    dt = float(np.float32(dt_fs / TIME_UNIT_FS))
    masses = _rows(batch, masses.to(device))
    mask = batch.node_mask[:, None, None].to(torch.float32)
    half_dt_over_m = 0.5 * dt / masses[:, None, None]
    gen = torch.Generator(device=device).manual_seed(seed)
    if v0 is not None:
        v = _rows(batch, v0).detach()
    elif temperature is not None:
        v = maxwell_boltzmann_velocities(batch, masses, temperature, gen)
    else:
        v = torch.zeros_like(x)
    force = make_force_fn(batch, params)

    if temperature is not None:
        # BAOAB: the O-step's exact Ornstein-Uhlenbeck coefficients
        gamma = friction_per_ps * (TIME_UNIT_FS / 1000.0)   # 1/time-unit
        c1 = float(np.exp(np.float32(-gamma * dt)))
        sigma = torch.sqrt(KB * temperature * (1.0 - c1 ** 2) / masses
                           )[:, None, None]

    m, c = batch.num_mols, x.shape[1]
    potential = x.new_empty((n_steps, m, c))
    kinetic = x.new_empty((n_steps, m, c))
    frames = x.new_empty((n_frames, *x.shape)) if n_frames else None
    f, _ = force(x)
    with torch.no_grad():
        for i in range(n_steps):
            if temperature is None:
                v_half = v + half_dt_over_m * f
                x = x + dt * v_half
                f, e = force(x)
                v = v_half + half_dt_over_m * f
            else:
                v = v + half_dt_over_m * f
                x = x + 0.5 * dt * v
                noise = _randn(batch, v.shape, gen, device) * mask
                v = c1 * v + sigma * noise
                x = x + 0.5 * dt * v
                f, e = force(x)
                v = v + half_dt_over_m * f
            v = v * mask
            potential[i] = e
            kinetic[i] = kinetic_energy(batch, masses, v)
            if n_frames and (i + 1) % record_every == 0:
                frames[(i + 1) // record_every - 1] = x
    out = {'xyz': x, 'velocities': v, 'potential': potential,
           'kinetic': kinetic}
    if n_frames:
        out['trajectory'] = frames
    return out


def minimize(batch: GraphBatch, params, n_steps: int = 200,
             lr: float = 1e-3,
             xyz0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gradient-descent energy minimisation (relaxation) on the batch's
    device; a light-weight stand-in for an external minimiser before
    dynamics."""
    x = (batch.xyz if xyz0 is None else _rows(batch, xyz0)).detach()
    force = make_force_fn(batch, params)
    for _ in range(n_steps):
        f, _ = force(x)
        x = x + lr * f
    return x
