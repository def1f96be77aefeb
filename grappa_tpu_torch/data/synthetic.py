"""Synthetic molecules and QM-like data for tests, smoke training and
benches.

Counterpart of `grappa_tpu.data.synthetic`: random molecular graphs (trees,
rings, sp2-like improper centres), plausible classical parameters,
conformers embedded in 3D, and ground-truth bonded energies / gradients
from an independent float64 PyTorch implementation of the MM terms (the
oracle the MM energy is tested against). The same seed gives the same
arrays as the JAX package. `minimize_geometry` has the JAX package's two
paths: 'torch' (the default, float64 on the CPU, step for step the JAX
package's) and 'bucketed' (the JAX package's 'jax': a padded Adam loop,
here on a torch device, CUDA by default).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from grappa_tpu_torch import constants
from grappa_tpu_torch.data.moldata import MolData
from grappa_tpu_torch.data.molecule import Molecule
from grappa_tpu_torch.data.parameters import Parameters


def random_molecule(seed: int = 0, n_atoms: Optional[int] = None,
                    charge_model: str = 'am1BCC',
                    elements: Optional[List[int]] = None,
                    atom_range: Tuple[int, int] = (6, 24)) -> Molecule:
    """Random connected molecule with branches, an occasional ring and
    improper centers at every degree-3 atom. The same seed gives the same
    molecule as `grappa_tpu.data.synthetic.random_molecule`.

    elements: atomic-number palette to draw from (repeats raise the draw
    probability), default [1, 6, 6, 7, 8, 16]. atom_range: (lo, hi) for the
    random atom count when n_atoms is None."""
    rng = np.random.default_rng(seed)
    if n_atoms is None:
        n_atoms = int(rng.integers(atom_range[0], atom_range[1]))
    bonds = []
    for i in range(1, n_atoms):
        parent = int(rng.integers(max(0, i - 4), i))
        bonds.append((parent, i))
    # close one ring of size 5 or 6 if possible
    if n_atoms >= 8 and rng.random() < 0.7:
        size = int(rng.choice([5, 6]))
        start = int(rng.integers(0, n_atoms - size))
        ring_atoms = list(range(start, start + size))
        ring_bonds = [(ring_atoms[i], ring_atoms[i + 1])
                      for i in range(size - 1)] + [(ring_atoms[-1],
                                                    ring_atoms[0])]
        existing = {tuple(sorted(b)) for b in bonds}
        for b in ring_bonds:
            if tuple(sorted(b)) not in existing:
                bonds.append(b)

    # improper sets: atoms with exactly 3 neighbors
    deg = np.zeros(n_atoms, int)
    nbrs = {i: [] for i in range(n_atoms)}
    for a, b in bonds:
        deg[a] += 1
        deg[b] += 1
        nbrs[a].append(b)
        nbrs[b].append(a)
    if np.max(deg) > constants.MAX_NEIGHBORS:
        raise RuntimeError("generated degree too large")
    improper_sets = []
    for center in range(n_atoms):
        if deg[center] == 3 and rng.random() < 0.8:
            a, b, c = sorted(nbrs[center])
            improper_sets.append((a, b, center, c))

    zs = rng.choice(elements if elements is not None else [1, 6, 6, 7, 8, 16],
                    size=n_atoms)
    charges = rng.normal(0, 0.3, size=n_atoms).astype(np.float32)
    charges -= charges.mean()
    return Molecule(
        atoms=np.arange(n_atoms), bonds=bonds, impropers=improper_sets,
        atomic_numbers=zs, partial_charges=charges,
        charge_model=charge_model,
    )


def random_parameters(mol: Molecule, seed: int = 0) -> Parameters:
    """Plausible random MM parameters (phases restricted to {0, pi})."""
    rng = np.random.default_rng(seed + 1)
    p = Parameters.get_nan_params(mol)
    p.bond_k = rng.normal(700, 100, len(p.bonds)).clip(min=200.0)
    p.bond_eq = rng.normal(1.4, 0.1, len(p.bonds)).clip(min=1.0)
    p.angle_k = rng.normal(100, 20, len(p.angles)).clip(min=30.0)
    p.angle_eq = rng.normal(1.95, 0.1, len(p.angles)).clip(1.4, 2.8)
    p.proper_ks = np.abs(rng.normal(0, 0.6, p.proper_ks.shape))
    p.proper_phases = np.where(rng.random(p.proper_ks.shape) < 0.5, 0.0, np.pi)
    p.improper_ks = np.abs(rng.normal(0, 1.5, p.improper_ks.shape))
    p.improper_phases = np.where(
        rng.random(p.improper_ks.shape) < 0.5, 0.0, np.pi)
    return p


def environment_parameters(mol: Molecule) -> Parameters:
    """Deterministic 'ground-truth force field': every parameter is a fixed
    function of the atomic numbers (and degrees) of the tuple atoms, so a
    model CAN generalize to held-out molecules — unlike random_parameters,
    whose per-molecule draws make validation loss irreducible. Used for
    convergence/capacity experiments."""
    def table(key, lo, hi):
        # process-stable hash (python's hash() is salted per interpreter)
        import zlib
        seed = zlib.crc32(repr(key).encode())
        rng = np.random.default_rng(seed)
        return float(lo + (hi - lo) * rng.random())

    zs = {int(a): int(z) for a, z in zip(mol.atoms, mol.atomic_numbers)}
    deg = {a: len(n) for a, n in mol.neighbor_map.items()}

    p = Parameters.get_nan_params(mol)
    p.bond_k = np.array([
        table(('bk',) + tuple(sorted((zs[int(a)], zs[int(b)]))), 300, 900)
        for a, b in mol.bonds])
    p.bond_eq = np.array([
        table(('be',) + tuple(sorted((zs[int(a)], zs[int(b)]))), 1.0, 1.8)
        for a, b in mol.bonds])
    p.angle_k = np.array([
        table(('ak', zs[int(b)], *sorted((zs[int(a)], zs[int(c)]))), 40, 160)
        for a, b, c in mol.angles])
    p.angle_eq = np.array([
        table(('ae', zs[int(b)], *sorted((zs[int(a)], zs[int(c)]))), 1.6, 2.4)
        for a, b, c in mol.angles])
    npp = p.proper_ks.shape[1]
    p.proper_ks = np.array([
        [table(('pk', n, *sorted((zs[int(t[0])], zs[int(t[3])])),
                *sorted((zs[int(t[1])], zs[int(t[2])]))), 0.0, 1.5 / n)
         for n in range(1, npp + 1)]
        for t in mol.propers], dtype=np.float64).reshape(-1, npp)
    p.proper_phases = np.zeros_like(p.proper_ks)
    npi = p.improper_ks.shape[1]
    p.improper_ks = np.array([
        [table(('ik', n, zs[int(t[2])], deg.get(int(t[2]), 0)), 0.0, 3.0)
         if n == 2 else 0.0
         for n in range(1, npi + 1)]
        for t in mol.impropers], dtype=np.float64).reshape(-1, npi)
    p.improper_phases = np.zeros_like(p.improper_ks)
    return p


def embed_conformers(mol: Molecule, n_confs: int, seed: int = 0,
                     noise: float = 0.25,
                     params: Optional[Parameters] = None) -> np.ndarray:
    """Rough 3D embedding: random-walk layout + per-conformer noise.
    Returns (n_confs, n_atoms, 3) in Angstrom. When `params` is given, each
    bond is placed at its equilibrium length, so conformers sit near the
    force field's minimum (realistic force magnitudes)."""
    rng = np.random.default_rng(seed + 2)
    n = len(mol.atoms)
    base = np.zeros((n, 3))
    nbr = mol.neighbor_map
    id2idx = mol.index_of()
    placed = {0}
    order = [0]
    bond_eq = {}
    if params is not None:
        for (a, b), eq in zip(np.asarray(params.bonds), params.bond_eq):
            key = tuple(sorted((int(a), int(b))))
            if np.isfinite(eq):
                bond_eq[key] = float(eq)
    # BFS placement at ~1.4 A bond length; directions rejection-sampled so
    # no two atoms come closer than ~1.1 A (clash-free, sane angles — random
    # directions produce 0.1 A overlaps and forces 10x harder than reality)
    queue = [int(mol.atoms[0])]
    while queue:
        a = queue.pop(0)
        ai = id2idx[a]
        for b in nbr.get(a, []):
            bi = id2idx[b]
            if bi not in placed:
                length = bond_eq.get(tuple(sorted((a, b))), 1.4)
                # clash check against the most recent placements only —
                # identical for small molecules, O(N) instead of O(N^2) for
                # 10k+-atom macromolecule benchmarks (the BFS layout keeps
                # clashes local)
                existing = base[order[-512:]]
                best, best_dist = None, -1.0
                for _ in range(30):
                    direction = rng.normal(size=3)
                    direction /= np.linalg.norm(direction)
                    candidate = base[ai] + length * direction
                    dist = np.linalg.norm(existing - candidate, axis=1)
                    dist = dist[dist > 1e-9].min() if len(existing) > 1 else 2.0
                    if dist > best_dist:
                        best, best_dist = candidate, dist
                    if dist >= 1.1:
                        break
                base[bi] = best
                placed.add(bi)
                order.append(bi)
                queue.append(b)
    confs = base[None] + rng.normal(0, noise, size=(n_confs, n, 3))
    return confs.astype(np.float32)


def minimize_geometry(mol: Molecule, params: Parameters, xyz0: np.ndarray,
                      n_steps: int = 300, lr: float = 5e-3,
                      method: Optional[str] = None, device=None,
                      dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Relax one conformer (n_atoms, 3) to a local minimum of the given
    parameters with Adam, so synthetic conformers sample around a true
    force-field minimum as MD / QM ensembles do.

    method: 'torch' (the default; float64 on the CPU, the JAX package's
    default path step for step, which regenerating the committed datasets
    byte for byte requires) or 'bucketed' ('jax', the JAX package's name
    for it): atoms padded to a multiple of 8 and tuples to a multiple of
    32, on `device` (CUDA unless the caller asks for another) in `dtype`
    (float32, or float64 when asked). Same energy and Adam semantics on
    another float path: an equivalent minimum, not a bit-identical one.
    Unset, it is the GRAPPA_TPU_MINIMIZER environment variable's value.
    `device` and `dtype` apply to 'bucketed' alone."""
    method = method or os.environ.get('GRAPPA_TPU_MINIMIZER', 'torch')
    if method in ('bucketed', 'jax'):
        return _minimize_geometry_bucketed(mol, params, xyz0, n_steps, lr,
                                           device, dtype)
    if method != 'torch':
        raise ValueError(f"minimize_geometry: method must be 'torch', "
                         f"'bucketed' or 'jax', got {method!r}")
    x = torch.tensor(xyz0[None], dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([x], lr=lr)
    static = _torch_graph_static(mol, params)
    for _ in range(n_steps):
        opt.zero_grad()
        energy, _ = _torch_energy_graph(mol, params, x, static=static)
        energy.sum().backward()
        opt.step()
    return x.detach().numpy()[0].astype(np.float32)


def _round_up(x: int, mult: int, minimum: int) -> int:
    return max(minimum, ((x + mult - 1) // mult) * mult)


def _bucketed_terms(mol: Molecule, params: Parameters, device,
                    dtype: torch.dtype):
    """The padded tuples and parameters of the bucketed minimizer, as the
    JAX package pads them: tuples to a multiple of 32, the padded rows
    indexing real, distinct atoms (0, 1, 2, 3: the geometry stays
    non-degenerate and differentiable) with k = 0, NaN parameters as 0; a
    torsion term without tuples or periodicities is left out."""
    idx = mol.tuple_indices()
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    def pad_term(arr, count_pad, fill_row):
        out = np.tile(np.asarray(fill_row, np.int64), (count_pad, 1))
        if len(arr):
            out[:len(arr)] = arr
        return torch.as_tensor(out, device=device)

    def pad_param(a, count_pad, n_per=None):
        shape = (count_pad,) if n_per is None else (count_pad, n_per)
        out = np.zeros(shape, np_dtype)
        if a is not None and len(a):
            out[:len(a)] = np.nan_to_num(np.asarray(a, np_dtype))
        return torch.as_tensor(out, device=device)

    terms = {}
    for term, k, eq, fill in (('n2', params.bond_k, params.bond_eq, [0, 1]),
                              ('n3', params.angle_k, params.angle_eq,
                               [0, 1, 2])):
        t_pad = _round_up(len(idx[term]), 32, 32)
        terms[term] = (pad_term(idx[term], t_pad, fill),
                       pad_param(k, t_pad), pad_param(eq, t_pad))
    for term, ks, phases in (
            ('n4', params.proper_ks, params.proper_phases),
            ('n4_improper', params.improper_ks, params.improper_phases)):
        count = len(idx[term])
        n_per = (np.asarray(ks).shape[1]
                 if count and ks is not None and len(ks) else 0)
        if n_per == 0:
            continue
        t_pad = _round_up(count, 32, 32)
        terms[term] = (pad_term(idx[term], t_pad, [0, 1, 2, 3]),
                       pad_param(ks, t_pad, n_per),
                       pad_param(phases, t_pad, n_per))
    return terms


def _bucketed_energy(x: torch.Tensor, terms) -> torch.Tensor:
    """The bonded energy of padded coordinates x (n_pad, 3): harmonic bonds
    and angles, cos(n phi - phase) torsions (the JAX package's
    `_jax_minimizer_fn` energy)."""
    idx, k, eq = terms['n2']
    p = x[idx]
    r = torch.linalg.norm(p[:, 0] - p[:, 1], dim=-1)
    e = (0.5 * k * (r - eq) ** 2).sum()
    idx, k, eq = terms['n3']
    p = x[idx]
    u = p[:, 0] - p[:, 1]
    v = p[:, 2] - p[:, 1]
    cos = (u * v).sum(-1) / (torch.linalg.norm(u, dim=-1)
                             * torch.linalg.norm(v, dim=-1))
    theta = torch.arccos(cos.clamp(-1 + 1e-9, 1 - 1e-9))
    e = e + (0.5 * k * (theta - eq) ** 2).sum()
    for term in ('n4', 'n4_improper'):
        if term not in terms:
            continue
        idx, ks, phs = terms[term]
        pos = x[idx]
        b1 = pos[:, 1] - pos[:, 0]
        b2 = pos[:, 2] - pos[:, 1]
        b3 = pos[:, 3] - pos[:, 2]
        c1 = torch.cross(b1, b2, dim=-1)
        c2 = torch.cross(b2, b3, dim=-1)
        m1 = torch.cross(c1, b2 / torch.linalg.norm(b2, dim=-1,
                                                    keepdim=True), dim=-1)
        phi = torch.atan2((m1 * c2).sum(-1), (c1 * c2).sum(-1))
        for n in range(1, ks.shape[1] + 1):
            e = e + (ks[:, n - 1] * torch.cos(n * phi - phs[:, n - 1])).sum()
    return e


_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def _adam_step(x, m, v, t, terms, corrections, lr: float):
    """One Adam step of the bucketed minimizer, in place: x -= lr mhat /
    (sqrt(vhat) + eps) with the bias corrections of step t (a device
    tensor, incremented here). Nothing reads a value back to the host, so
    a CUDA graph can replay it."""
    x.requires_grad_(True)
    g, = torch.autograd.grad(_bucketed_energy(x, terms), x)
    with torch.no_grad():
        m.mul_(_ADAM_B1).add_(g, alpha=1 - _ADAM_B1)
        v.mul_(_ADAM_B2).addcmul_(g, g, value=1 - _ADAM_B2)
        bc1, bc2 = (torch.index_select(c, 0, t) for c in corrections)
        x.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + _ADAM_EPS))
        t.add_(1)


def _minimize_geometry_bucketed(mol: Molecule, params: Parameters,
                                xyz0: np.ndarray, n_steps: int, lr: float,
                                device, dtype: torch.dtype) -> np.ndarray:
    """Adam on the padded energy with torch-Adam's update (bias-corrected
    moments, eps outside the root), as the JAX package's
    `_minimize_geometry_jax` runs it. Padded atoms sit at the origin, in no
    tuple: their gradient is 0 and they do not move. On a card one step is
    captured as a CUDA graph and replayed: a step is many small kernels,
    whose launches from Python would pace the loop."""
    from grappa_tpu_torch.utils import resolve_device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f'minimize_geometry: dtype must be float32 or '
                         f'float64, got {dtype}')
    device = resolve_device(device)
    n = xyz0.shape[0]
    terms = _bucketed_terms(mol, params, device, dtype)
    x0 = torch.zeros((_round_up(n, 8, 8), 3), dtype=dtype, device=device)
    x0[:n] = torch.as_tensor(np.asarray(xyz0), dtype=dtype, device=device)
    steps = np.arange(1, n_steps + 1, dtype=np.float64)
    corrections = [torch.as_tensor(1 - b ** steps, dtype=dtype, device=device)
                   for b in (_ADAM_B1, _ADAM_B2)]
    x = x0.clone()
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    t = torch.zeros(1, dtype=torch.long, device=device)
    state = (x, m, v, t, terms, corrections, lr)
    if device.type != 'cuda' or n_steps < 2:
        for _ in range(n_steps):
            _adam_step(*state)
        return x.detach()[:n].cpu().numpy().astype(np.float32)
    # a capture needs one step run before it on a side stream; then the
    # state starts over and the captured step replays n_steps times
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        _adam_step(*state)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad():
        x.copy_(x0)
        m.zero_()
        v.zero_()
        t.zero_()
    with torch.cuda.graph(graph):
        _adam_step(*state)
    with torch.no_grad():
        x.copy_(x0)
        m.zero_()
        v.zero_()
        t.zero_()
    for _ in range(n_steps):
        graph.replay()
    return x.detach()[:n].cpu().numpy().astype(np.float32)


# ----------------------------------------------------------------------
# independent torch ground truth
def torch_bonded_energy(mol: Molecule, params: Parameters, xyz: np.ndarray):
    """Ground-truth bonded energy + gradient via torch autograd (CPU).

    Intentionally an independent implementation (direct cos(n*phi - phase)
    form with explicit phases rather than signed k) used as the oracle for
    the MM energy. Returns (energy (n_confs,), gradient (n_confs, n_atoms, 3))
    in kcal/mol and kcal/mol/A.
    """
    x = torch.tensor(xyz, dtype=torch.float64, requires_grad=True)
    energy, _ = _torch_energy_graph(mol, params, x)
    grad = torch.autograd.grad(energy.sum(), x)[0]
    return energy.detach().numpy(), grad.numpy()


def _torch_graph_static(mol: Molecule, params: Parameters):
    """Precompute the x-independent tensors of `_torch_energy_graph`
    (tuple index arrays and parameter constants) so repeated evaluations —
    the 300-step minimizer — skip the per-step Python rebuild. Values are
    byte-identical to the inline construction, so minimization
    trajectories (and hence generated datasets) are unchanged."""
    idx = mol.tuple_indices()
    static = {'idx': {t: v.astype(np.int64) for t, v in idx.items()}}
    if len(idx['n2']):
        static['bond'] = (torch.tensor(params.bond_k, dtype=torch.float64),
                          torch.tensor(params.bond_eq, dtype=torch.float64))
    if len(idx['n3']):
        static['angle'] = (torch.tensor(params.angle_k, dtype=torch.float64),
                           torch.tensor(params.angle_eq,
                                        dtype=torch.float64))
    for term, ks, phases in (
            ('n4', params.proper_ks, params.proper_phases),
            ('n4_improper', params.improper_ks, params.improper_phases)):
        if len(idx[term]) == 0 or ks is None or len(ks) == 0:
            continue
        static[term] = (torch.tensor(np.nan_to_num(ks), dtype=torch.float64),
                        torch.tensor(np.nan_to_num(phases),
                                     dtype=torch.float64))
    return static


def _torch_energy_graph(mol: Molecule, params: Parameters, x, static=None):
    """torch energy graph (C,) for coordinates tensor x (C, N, 3)."""
    if static is None:
        static = _torch_graph_static(mol, params)
    idx = static['idx']

    def gather(t):
        return x[:, idx[t]]  # (C, T, arity, 3)

    energy = torch.zeros(x.shape[0], dtype=torch.float64)

    if len(idx['n2']):
        pos = gather('n2')
        r = torch.linalg.norm(pos[:, :, 0] - pos[:, :, 1], dim=-1)
        k, eq = static['bond']
        energy = energy + (0.5 * k * (r - eq) ** 2).sum(dim=1)

    if len(idx['n3']):
        pos = gather('n3')
        u = pos[:, :, 0] - pos[:, :, 1]
        v = pos[:, :, 2] - pos[:, :, 1]
        cos = (u * v).sum(-1) / (torch.linalg.norm(u, dim=-1)
                                 * torch.linalg.norm(v, dim=-1))
        theta = torch.arccos(cos.clamp(-1 + 1e-9, 1 - 1e-9))
        k, eq = static['angle']
        energy = energy + (0.5 * k * (theta - eq) ** 2).sum(dim=1)

    def dihedral(pos):
        b1 = pos[:, :, 1] - pos[:, :, 0]
        b2 = pos[:, :, 2] - pos[:, :, 1]
        b3 = pos[:, :, 3] - pos[:, :, 2]
        n1 = torch.cross(b1, b2, dim=-1)
        n2 = torch.cross(b2, b3, dim=-1)
        m1 = torch.cross(n1, b2 / torch.linalg.norm(b2, dim=-1, keepdim=True),
                         dim=-1)
        yy = (m1 * n2).sum(-1)
        xx = (n1 * n2).sum(-1)
        return torch.atan2(yy, xx)

    for term in ('n4', 'n4_improper'):
        if term not in static:
            continue
        pos = gather(term)
        phi = dihedral(pos)  # (C, T)
        k, ph = static[term]
        n_per = k.shape[1]
        for n in range(1, n_per + 1):
            # reference/openmm convention: k*(1 + cos(n*phi - phase)); the
            # constant offset drops out of centered energies but we keep the
            # cos term identical to the signed-k convention because
            # cos(n*phi - {0, pi}) = +-cos(n*phi).
            energy = energy + (
                k[:, n - 1] * torch.cos(n * phi - ph[:, n - 1])).sum(dim=1)

    return energy, x


def make_moldata(seed: int = 0, n_confs: int = 8,
                 n_atoms: Optional[int] = None,
                 ds_name: str = 'synthetic',
                 learnable: bool = False,
                 conf_noise: float = 0.25,
                 charge_model: str = 'am1BCC',
                 elements: Optional[List[int]] = None,
                 atom_range: Tuple[int, int] = (6, 24)) -> MolData:
    """Full synthetic dataset entry with self-consistent targets.
    learnable=True derives parameters from atomic environments (a fixed
    ground-truth FF the model can generalize), else random per molecule.
    conf_noise: per-coordinate displacement (A); ~0.08 mimics realistic
    near-equilibrium conformer ensembles, 0.25 is a stress test."""
    mol = random_molecule(seed, n_atoms=n_atoms, charge_model=charge_model,
                          elements=elements, atom_range=atom_range)
    params = (environment_parameters(mol) if learnable
              else random_parameters(mol, seed))
    xyz = embed_conformers(mol, n_confs, seed, noise=conf_noise,
                           params=params if learnable else None)
    if learnable:
        # relax the base geometry to the FF minimum, then sample around it —
        # otherwise forces are dominated by the arbitrary embedding strain
        rng = np.random.default_rng(seed + 5)
        base = minimize_geometry(mol, params, xyz[0])
        xyz = (base[None] + rng.normal(0, conf_noise,
                                       size=(n_confs, len(mol.atoms), 3))
               ).astype(np.float32)
    energy, gradient = torch_bonded_energy(mol, params, xyz)
    energy_ref = energy - energy.mean()
    return MolData(
        molecule=mol, xyz=xyz,
        energy=energy.astype(np.float32),
        gradient=gradient.astype(np.float32),
        energy_ref=energy_ref.astype(np.float32),
        gradient_ref=gradient.astype(np.float32),
        mol_id=f'{ds_name}-{seed}',
        classical_parameters=params,
    )


def make_dataset(n_mols: int = 8, n_confs: int = 8, seed: int = 0,
                 ds_name: str = 'synthetic',
                 learnable: bool = False,
                 conf_noise: float = 0.25,
                 charge_model: str = 'am1BCC',
                 elements: Optional[List[int]] = None,
                 atom_range: Tuple[int, int] = (6, 24)) -> List[MolData]:
    return [make_moldata(seed=seed * 1000 + i, n_confs=n_confs,
                         ds_name=ds_name, learnable=learnable,
                         conf_noise=conf_noise, charge_model=charge_model,
                         elements=elements, atom_range=atom_range)
            for i in range(n_mols)]
