"""Kimmdy reactive-MD integration (optional, import-gated).

The reference registers a kimmdy `Parameterizer` so reactive simulations can
re-parametrize radicals on the fly (reference: src/grappa/utils/
kimmdy_utils.py:243-290). This adapter provides the same hook on top of
grappa_tpu_torch (counterpart of `grappa_tpu.wrappers.kimmdy_adapter`).
Where kimmdy is absent, the same partial-reparametrization logic
is available directly through `GromacsGrappa.parametrize(..., focus_nrs=...)`
on topology files.
"""
from __future__ import annotations

import importlib
from typing import Optional, Set

import numpy as np

from grappa_tpu_torch.api import Grappa
from grappa_tpu_torch.data.molecule import Molecule


def _require_kimmdy():
    if importlib.util.find_spec('kimmdy') is None:
        raise ImportError(
            "kimmdy is not installed; use GromacsGrappa.parametrize with "
            "focus_nrs for file-based partial reparametrization instead")


def build_molecule_from_kimmdy(topology, atom_nrs: Optional[Set[str]] = None,
                               charge_model: str = 'amber99') -> Molecule:
    """kimmdy Topology (sub)graph -> grappa Molecule (ids = atom nrs as ints);
    radical flags from kimmdy's radical bookkeeping."""
    _require_kimmdy()
    atoms = topology.atoms
    nrs = sorted((int(a.nr) for a in atoms.values())
                 if atom_nrs is None else (int(x) for x in atom_nrs))
    keep = set(nrs)
    bonds = [(int(b.ai), int(b.aj)) for b in topology.bonds.values()
             if int(b.ai) in keep and int(b.aj) in keep]
    atomic_numbers, charges, radical = [], [], []
    from grappa_tpu_torch.wrappers.gromacs_wrapper import element_from_mass
    for nr in nrs:
        atom = atoms[str(nr)]
        atomic_numbers.append(element_from_mass(float(atom.mass)))
        charges.append(float(atom.charge))
        radical.append(float(getattr(atom, 'is_radical', False)))
    impropers = [tuple(int(x) for x in (d.ai, d.aj, d.ak, d.al))
                 for d in topology.improper_dihedrals.values()
                 if all(int(x) in keep for x in (d.ai, d.aj, d.ak, d.al))]
    mol = Molecule(atoms=nrs, bonds=bonds, impropers=impropers,
                   atomic_numbers=atomic_numbers, partial_charges=charges,
                   improper_in_correct_format=False,
                   charge_model=charge_model)
    mol.set_radical_flags(np.asarray(radical))
    return mol


def make_kimmdy_parameterizer(grappa_instance: Grappa,
                              charge_model: str = 'amber99'):
    """Returns a kimmdy Parameterizer subclass instance bound to the model."""
    _require_kimmdy()
    from kimmdy.plugins import Parameterizer
    from grappa_tpu_torch.wrappers.gromacs_wrapper import fov_neighborhood

    class GrappaTpuParameterizer(Parameterizer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.grappa = grappa_instance
            self.charge_model = charge_model

        def parameterize_topology(self, current_topology,
                                  focus_nrs: Optional[Set[str]] = None):
            bonds = [(int(b.ai), int(b.aj))
                     for b in current_topology.bonds.values()]
            if focus_nrs:
                fov = self.grappa.field_of_view
                apply_nrs = fov_neighborhood(
                    bonds, {int(x) for x in focus_nrs}, fov)
                build_nrs = fov_neighborhood(bonds, apply_nrs, fov)
            else:
                build_nrs = None
                apply_nrs = None
            mol = build_molecule_from_kimmdy(
                current_topology,
                {str(x) for x in build_nrs} if build_nrs else None,
                charge_model=self.charge_model)
            params = self.grappa.predict(mol)
            _apply_to_kimmdy_topology(current_topology, params, apply_nrs)
            return current_topology

    return GrappaTpuParameterizer


def _apply_to_kimmdy_topology(topology, params, apply_nrs: Optional[Set[int]]):
    """Write predicted parameters into a kimmdy Topology in place (GROMACS
    units; funct 1/1/9/4).

    Clear-and-replace like the file-based path (gromacs_wrapper
    _merge_partial): every existing entry whose atoms all lie in the apply
    region is dropped, then the predictions are inserted under grappa's
    canonical tuple keys. Matching old keys entry-by-entry would be wrong —
    a kimmdy topology may store the same proper reversed or an improper in
    any of its orderings, which would leave stale unparametrized duplicates
    behind (grappa emits 3 cyclic improper versions that jointly carry the
    improper energy, replacing however many entries the topology had)."""
    from kimmdy.topology.atomic import (Angle, Bond, Dihedral,
                                        MultipleDihedrals)
    from grappa_tpu_torch.wrappers.gromacs_wrapper import (
        ANGLE_EQ_FACTOR, ANGLE_K_FACTOR, BOND_EQ_FACTOR, BOND_K_FACTOR,
        TORSION_K_FACTOR, TORSION_PHASE_FACTOR)

    def ok(tup):
        return apply_nrs is None or all(int(x) in apply_nrs for x in tup)

    for store in (topology.bonds, topology.angles,
                  topology.proper_dihedrals, topology.improper_dihedrals):
        for key in [k for k in store if ok(k)]:
            del store[key]

    for i, (a, b) in enumerate(params.bonds):
        if not ok((a, b)):
            continue
        key = tuple(str(x) for x in sorted((int(a), int(b))))
        topology.bonds[key] = Bond(
            *key, funct='1',
            c0=f'{params.bond_eq[i] * BOND_EQ_FACTOR:.6f}',
            c1=f'{params.bond_k[i] * BOND_K_FACTOR:.4f}')
    for i, (a, b, c) in enumerate(params.angles):
        if not ok((a, b, c)):
            continue
        key = (str(int(a)), str(int(b)), str(int(c)))
        topology.angles[key] = Angle(
            *key, funct='1',
            c0=f'{params.angle_eq[i] * ANGLE_EQ_FACTOR:.4f}',
            c1=f'{params.angle_k[i] * ANGLE_K_FACTOR:.4f}')
    for tuples, ks, phases, store, funct in (
            (params.propers, params.proper_ks, params.proper_phases,
             topology.proper_dihedrals, '9'),
            (params.impropers, params.improper_ks, params.improper_phases,
             topology.improper_dihedrals, '4')):
        if tuples is None:
            continue
        for i, tup in enumerate(tuples):
            if not ok(tup):
                continue
            key = tuple(str(int(x)) for x in tup)
            dihedrals = {}
            for n in range(ks.shape[1]):
                dihedrals[str(n + 1)] = Dihedral(
                    *key, funct=funct,
                    c0=f'{phases[i, n] * TORSION_PHASE_FACTOR:.4f}',
                    c1=f'{ks[i, n] * TORSION_K_FACTOR:.6f}',
                    periodicity=str(n + 1))
            store[key] = MultipleDihedrals(*key, funct=funct,
                                           dihedrals=dihedrals)
