"""A minimal stand-in for the openff-toolkit / rdkit API surface used by
grappa_tpu_torch.wrappers.openff_utils (test double; the port's copy of
tests/openff_double.py with the port's imports, so that it runs where the
JAX package cannot).

Backs `Molecule.from_mapped_smiles` with the first-party mapped-SMILES
parser (grappa_tpu_torch.data.smiles), exposes atoms/bonds/partial_charges/
smirnoff_impropers with openff's attribute names, and provides a tiny rdkit
shim (HybridizationType + GetAtoms) whose hybridization/aromaticity
assignments are a deterministic function of connectivity — enough to
execute the import-gated glue; chemistry fidelity is not the point.

The SMIRNOFF-engine path (ForceField.create_openmm_system) is NOT doubled:
it is a full force-field typing engine, and molecule_from_smiles /
get_openmm_system stay gated on the real openff-toolkit.

Install with install(), remove with uninstall().
"""
from __future__ import annotations

import importlib.machinery
import sys
import types
from typing import List, Optional

import numpy as np

from grappa_tpu_torch.data.smiles import parse_mapped_smiles
from grappa_tpu_torch.graph_features import ring_membership_sizes


class FFQuantity:
    """pint-like quantity: division by the unit exposes .magnitude."""

    def __init__(self, magnitude):
        self.magnitude = np.asarray(magnitude)

    def __truediv__(self, unit):
        return self

    def __rmul__(self, other):
        return FFQuantity(other)


class _FFUnit:
    # defer numpy ufuncs so ndarray * unit reaches __rmul__ (one
    # FFQuantity wrapping the whole array, like pint)
    __array_ufunc__ = None

    def __rmul__(self, other):        # np.asarray(x) * elementary_charge
        return FFQuantity(other)

    def __rtruediv__(self, other):
        return FFQuantity(other)


class HybridizationType:
    S, SP, SP2, SP3, SP3D, SP3D2, UNSPECIFIED = range(7)


class _RDAtom:
    def __init__(self, hybridization, aromatic: bool):
        self._h = hybridization
        self._a = bool(aromatic)

    def GetHybridization(self):
        return self._h

    def GetIsAromatic(self):
        return self._a


class _RDMol:
    def __init__(self, atoms: List[_RDAtom]):
        self._atoms = atoms

    def GetNumAtoms(self):
        return len(self._atoms)

    def GetAtoms(self):
        return list(self._atoms)


class _OFFAtom:
    def __init__(self, index: int, z: int):
        self.molecule_atom_index = index
        self.atomic_number = int(z)


class _OFFBond:
    def __init__(self, a: int, b: int):
        self.atom1_index = int(a)
        self.atom2_index = int(b)


class OFFMolecule:
    """openff.toolkit.topology.Molecule double (SMILES-parse backed)."""

    def __init__(self, atomic_numbers, bonds,
                 partial_charges: Optional[np.ndarray] = None):
        self.atoms = [_OFFAtom(i, z) for i, z in enumerate(atomic_numbers)]
        self.bonds = [_OFFBond(a, b) for a, b in bonds]
        self.partial_charges = (FFQuantity(partial_charges)
                                if partial_charges is not None else None)

    @classmethod
    def from_mapped_smiles(cls, smiles: str,
                           allow_undefined_stereo: bool = False):
        zs, bonds, _ = parse_mapped_smiles(smiles)
        mol = cls(zs, bonds)
        mol._source_smiles = smiles
        return mol

    def to_topology(self):
        return _OFFTopology(self)

    def to_smiles(self, mapped: bool = True):
        return getattr(self, '_source_smiles', None)

    # -- derived connectivity ------------------------------------------
    def _neighbors(self):
        nbrs = {i: [] for i in range(len(self.atoms))}
        for b in self.bonds:
            nbrs[b.atom1_index].append(b.atom2_index)
            nbrs[b.atom2_index].append(b.atom1_index)
        return nbrs

    @property
    def smirnoff_impropers(self):
        """All orderings with the trivalent center at position 1 (openff's
        convention), three per center — the glue only uses the atom sets."""
        out = []
        for c, nb in self._neighbors().items():
            if len(nb) != 3:
                continue
            n0, n1, n2 = sorted(nb)
            for order in ((n0, c, n1, n2), (n1, c, n2, n0), (n2, c, n0, n1)):
                out.append(tuple(self.atoms[i] for i in order))
        return out

    amber_impropers = smirnoff_impropers

    def to_rdkit(self):
        nbrs = self._neighbors()
        bond_pairs = [(b.atom1_index, b.atom2_index) for b in self.bonds]
        ring_sizes = ring_membership_sizes(bond_pairs, len(self.atoms))
        atoms = []
        for i, atom in enumerate(self.atoms):
            degree = len(nbrs[i])
            if atom.atomic_number == 1:
                h = HybridizationType.S
            elif degree >= 4:
                h = HybridizationType.SP3
            elif degree == 3:
                h = HybridizationType.SP2
            elif degree == 2:
                h = HybridizationType.SP
            else:
                h = HybridizationType.SP3
            aromatic = any(s in (5, 6) for s in ring_sizes[i])
            atoms.append(_RDAtom(h, aromatic))
        return _RDMol(atoms)




class _OFFTopology:
    def __init__(self, molecule):
        self._molecule = molecule

    def to_openmm(self):
        """openmm(double) Topology: one MOL residue, X{i} atom names."""
        from openmm.app import Element, Topology
        top = Topology()
        chain = top.addChain('A')
        res = top.addResidue('MOL', chain)
        atoms = [top.addAtom(f'X{i}', Element.getByAtomicNumber(
                     a.atomic_number), res)
                 for i, a in enumerate(self._molecule.atoms)]
        for b in self._molecule.bonds:
            top.addBond(atoms[b.atom1_index], atoms[b.atom2_index])
        return top


# element-pair harmonic bond lengths (nm); generic amber-like stiffness
_BOND_R0 = {
    frozenset((6, 6)): 0.1526, frozenset((6, 7)): 0.1449,
    frozenset((6, 8)): 0.1410, frozenset((6, 1)): 0.1090,
    frozenset((7, 1)): 0.1010, frozenset((8, 1)): 0.0960,
    frozenset((7, 8)): 0.1400, frozenset((8, 8)): 0.1480,
}


class SmirnoffForceField:
    """openff.toolkit.typing.engines.smirnoff.ForceField double.

    Types by connectivity with generic amber-like values — enough to
    execute the MolData.from_smiles path (system construction, charge
    assignment, classical-parameter extraction, nonbonded subtraction)
    against the openmm double."""

    def __init__(self, *sources):
        self.sources = sources

    def create_openmm_system(self, off_topology, charge_from_molecules=None):
        import openmm
        from grappa_tpu_torch.constants import ATOMIC_MASSES

        mol = off_topology._molecule
        n = len(mol.atoms)
        if charge_from_molecules:
            pc = charge_from_molecules[0].partial_charges
            charges = np.asarray(getattr(pc, 'magnitude', pc), np.float64)
        elif mol.partial_charges is not None:
            charges = np.asarray(mol.partial_charges.magnitude, np.float64)
        else:
            # stand-in for am1bcc: electronegativity-flavored, neutralized
            base = {1: 0.06, 6: -0.05, 7: -0.4, 8: -0.5, 16: -0.2}
            charges = np.asarray(
                [base.get(a.atomic_number, 0.0) for a in mol.atoms])
            charges -= charges.mean()

        system = openmm.System()
        nonbonded = openmm.NonbondedForce()
        for i, a in enumerate(mol.atoms):
            system.addParticle(ATOMIC_MASSES.get(a.atomic_number, 12.0))
            sigma = 0.12 if a.atomic_number == 1 else 0.33
            eps = 0.0657 if a.atomic_number == 1 else 0.36
            nonbonded.addParticle(float(charges[i]), sigma, eps)

        bonds = [(b.atom1_index, b.atom2_index) for b in mol.bonds]
        neighbor = {i: set() for i in range(n)}
        for i, j in bonds:
            neighbor[i].add(j)
            neighbor[j].add(i)

        bond_force = openmm.HarmonicBondForce()
        z = [a.atomic_number for a in mol.atoms]
        for i, j in bonds:
            r0 = _BOND_R0.get(frozenset((z[i], z[j])), 0.1500)
            bond_force.addBond(i, j, r0, 265265.6)
        system.addForce(bond_force)

        angle_force = openmm.HarmonicAngleForce()
        for j in range(n):
            ns = sorted(neighbor[j])
            for ai in range(len(ns)):
                for bi in range(ai + 1, len(ns)):
                    angle_force.addAngle(ns[ai], j, ns[bi], 1.9111355, 400.0)
        system.addForce(angle_force)

        torsion_force = openmm.PeriodicTorsionForce()
        seen = set()
        for j, k in bonds:
            for i in neighbor[j] - {k}:
                for l in neighbor[k] - {j}:
                    if i == l:
                        continue
                    key = min((i, j, k, l), (l, k, j, i))
                    if key in seen:
                        continue
                    seen.add(key)
                    torsion_force.addTorsion(*key, 3, 0.0, 0.6508444)
        system.addForce(torsion_force)
        system.addForce(nonbonded)
        return system


def _module(name: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
    return mod


def install():
    offtk = _module('openff.toolkit')
    topology = _module('openff.toolkit.topology')
    topology.Molecule = OFFMolecule
    offtk.topology = topology
    typing = _module('openff.toolkit.typing')
    engines = _module('openff.toolkit.typing.engines')
    smirnoff = _module('openff.toolkit.typing.engines.smirnoff')
    smirnoff.ForceField = SmirnoffForceField
    engines.smirnoff = smirnoff
    typing.engines = engines
    offtk.typing = typing

    openff = _module('openff')
    openff.toolkit = offtk
    units = _module('openff.units')
    unit_mod = _module('openff.units.unit')
    units.unit = unit_mod
    unit_mod.elementary_charge = _FFUnit()
    openff.units = units

    rdkit = _module('rdkit')
    chem = _module('rdkit.Chem')
    rdchem = _module('rdkit.Chem.rdchem')
    rdchem.HybridizationType = HybridizationType
    chem.rdchem = rdchem
    rdkit.Chem = chem

    for name, mod in (('openff', openff), ('openff.toolkit', offtk),
                      ('openff.toolkit.topology', topology),
                      ('openff.toolkit.typing', typing),
                      ('openff.toolkit.typing.engines', engines),
                      ('openff.toolkit.typing.engines.smirnoff', smirnoff),
                      ('openff.units', units),
                      ('openff.units.unit', unit_mod),
                      ('rdkit', rdkit), ('rdkit.Chem', chem),
                      ('rdkit.Chem.rdchem', rdchem)):
        sys.modules[name] = mod


def uninstall():
    for name in ('openff', 'openff.toolkit', 'openff.toolkit.topology',
                 'openff.toolkit.typing', 'openff.toolkit.typing.engines',
                 'openff.toolkit.typing.engines.smirnoff',
                 'openff.units', 'openff.units.unit',
                 'rdkit', 'rdkit.Chem', 'rdkit.Chem.rdchem'):
        sys.modules.pop(name, None)
