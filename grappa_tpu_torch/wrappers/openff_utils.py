"""OpenFF-toolkit glue (optional interop, import-gated).

Counterpart of `grappa_tpu.wrappers.openff_utils`.

Counterpart of the reference's openff utilities (reference: src/grappa/utils/
openff_utils.py:15-176): mapped-SMILES -> openmm system/topology via openff
or openmmforcefields, sp-hybridization / aromaticity featurizers, and
Molecule constructors from openff molecules. None of this is needed by the
core TPU path; it exists so datasets created with openff-based charges and
features can be reproduced.
"""
from __future__ import annotations

import importlib
from typing import List, Tuple, Union

import numpy as np

from grappa_tpu_torch.data.molecule import Molecule

_HYBRIDIZATIONS = ['S', 'SP', 'SP2', 'SP3', 'SP3D', 'SP3D2']


def _require(pkg: str):
    try:
        found = importlib.util.find_spec(pkg) is not None
    except ModuleNotFoundError:
        found = False
    if not found:
        raise ImportError(
            f"{pkg} is required for this interop path but is not installed")


def get_openff_molecule(mapped_smiles: str):
    _require('openff.toolkit')
    from openff.toolkit.topology import Molecule as OFFMolecule
    return OFFMolecule.from_mapped_smiles(mapped_smiles,
                                          allow_undefined_stereo=True)


def get_sp_hybridization_encoding(openff_mol) -> np.ndarray:
    """(n_atoms, 6) one-hot over S/SP/SP2/SP3/SP3D/SP3D2 via rdkit."""
    _require('rdkit')
    from rdkit.Chem.rdchem import HybridizationType
    rd_mol = openff_mol.to_rdkit()
    mapping = {
        HybridizationType.S: 0, HybridizationType.SP: 1,
        HybridizationType.SP2: 2, HybridizationType.SP3: 3,
        HybridizationType.SP3D: 4, HybridizationType.SP3D2: 5,
    }
    enc = np.zeros((rd_mol.GetNumAtoms(), 6), np.float32)
    for i, atom in enumerate(rd_mol.GetAtoms()):
        idx = mapping.get(atom.GetHybridization())
        if idx is not None:
            enc[i, idx] = 1.0
    return enc


def get_is_aromatic(openff_mol) -> np.ndarray:
    _require('rdkit')
    rd_mol = openff_mol.to_rdkit()
    return np.array([[a.GetIsAromatic()] for a in rd_mol.GetAtoms()],
                    np.float32)


def get_openmm_system(mapped_smiles: str,
                      openff_forcefield: str = 'openff-1.2.0.offxml',
                      partial_charges=None):
    """(system, topology, openff_mol) from a mapped smiles + openff FF."""
    _require('openff.toolkit')
    from openff.toolkit.typing.engines.smirnoff import ForceField
    mol = get_openff_molecule(mapped_smiles)
    if partial_charges is not None:
        from openff.units import unit as ff_unit
        mol.partial_charges = np.asarray(partial_charges) \
            * ff_unit.elementary_charge
    ff = ForceField(openff_forcefield)
    off_topology = mol.to_topology()
    kwargs = {}
    if partial_charges is not None:
        kwargs['charge_from_molecules'] = [mol]
    system = ff.create_openmm_system(off_topology, **kwargs)
    return system, off_topology.to_openmm(), mol


def molecule_from_openff(openff_mol, partial_charges=None,
                         impropers: Union[str, List[Tuple[int, int, int, int]]]
                         = 'smirnoff',
                         charge_model: str = 'am1BCC') -> Molecule:
    """grappa Molecule from an openff molecule (reference semantics:
    Molecule.from_openff_molecule, Molecule.py:371-426)."""
    _require('openff.toolkit')
    atoms = [a.molecule_atom_index for a in openff_mol.atoms]
    atomic_numbers = [a.atomic_number for a in openff_mol.atoms]
    bonds = [(b.atom1_index, b.atom2_index) for b in openff_mol.bonds]

    if partial_charges is None:
        from openff.units import unit as ff_unit
        assert openff_mol.partial_charges is not None
        partial_charges = (openff_mol.partial_charges
                           / ff_unit.elementary_charge).magnitude

    if isinstance(impropers, str):
        source = (openff_mol.smirnoff_impropers if impropers == 'smirnoff'
                  else openff_mol.amber_impropers)
        improper_sets = list({
            tuple(sorted(a.molecule_atom_index for a in tup))
            for tup in source
        })
    else:
        improper_sets = impropers

    mol = Molecule(
        atoms=atoms, bonds=bonds, impropers=improper_sets,
        atomic_numbers=atomic_numbers,
        partial_charges=np.asarray(partial_charges, np.float32),
        improper_in_correct_format=False, charge_model=charge_model)
    mol.additional_features['sp_hybridization'] = \
        get_sp_hybridization_encoding(openff_mol)
    mol.additional_features['is_aromatic'] = get_is_aromatic(openff_mol)
    return mol


def molecule_from_smiles(mapped_smiles: str,
                         openff_forcefield: str = 'openff-1.2.0.offxml',
                         partial_charges=None,
                         charge_model: str = 'am1BCC') -> Molecule:
    """grappa Molecule from a mapped smiles via an openff force field."""
    from grappa_tpu_torch.wrappers.openmm_wrapper import (
        molecule_from_openmm)
    system, topology, openff_mol = get_openmm_system(
        mapped_smiles, openff_forcefield, partial_charges)
    mol = molecule_from_openmm(system, topology,
                               partial_charges=partial_charges,
                               charge_model=charge_model)
    mol.additional_features['sp_hybridization'] = \
        get_sp_hybridization_encoding(openff_mol)
    mol.additional_features['is_aromatic'] = get_is_aromatic(openff_mol)
    return mol
