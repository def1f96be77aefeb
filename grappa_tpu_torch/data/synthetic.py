"""Synthetic molecules for smoke runs and tests (the QM-like data generator
of the JAX package is queued for a later slice)."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from grappa_tpu_torch import constants
from grappa_tpu_torch.data.molecule import Molecule


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
