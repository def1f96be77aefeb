"""Dataset-entry data class: a molecule with QM conformer data.

Counterpart of `grappa_tpu.data.moldata.MolData` (the port's own copy; the
npz layout is the JAX package's and the reference's, so entries
interchange through `to_dict` / `from_dict` / `save` / `load`):
conformational arrays (xyz, energy, gradient), reference targets
(energy_ref = QM minus classical nonbonded, mean-centred; gradient_ref),
classical parameters for regularisation, and per-force-field energy /
gradient dictionaries under prefixed keys. `from_smiles` needs the MD
engine wrappers and is queued with them (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from grappa_tpu_torch.data.molecule import Molecule
from grappa_tpu_torch.data.parameters import Parameters

_PARAM_KEYS = ('bond_k', 'bond_eq', 'angle_k', 'angle_eq', 'proper_ks',
               'proper_phases', 'improper_ks', 'improper_phases')
_TUPLE_KEYS = ('atoms', 'bonds', 'angles', 'propers', 'impropers')
_STR_KEYS = ('mol_id', 'mapped_smiles', 'pdb', 'smiles', 'sequence')


@dataclass
class MolData:
    molecule: Molecule

    xyz: np.ndarray            # (n_confs, n_atoms, 3) Angstrom
    energy: np.ndarray         # (n_confs,) QM energy, kcal/mol
    gradient: np.ndarray       # (n_confs, n_atoms, 3) QM gradient

    energy_ref: np.ndarray     # (n_confs,) centered bonded target
    gradient_ref: np.ndarray   # (n_confs, n_atoms, 3) bonded gradient target

    mol_id: str

    classical_parameters: Optional[Parameters] = None

    sequence: Optional[str] = None
    smiles: Optional[str] = None
    mapped_smiles: Optional[str] = None
    pdb: Optional[str] = None

    improper_energy_ref: Optional[np.ndarray] = None
    improper_gradient_ref: Optional[np.ndarray] = None

    ff_energy: Dict[str, np.ndarray] = field(default_factory=dict)
    ff_gradient: Dict[str, np.ndarray] = field(default_factory=dict)
    ff_nonbonded_energy: Dict[str, np.ndarray] = field(default_factory=dict)
    ff_nonbonded_gradient: Dict[str, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        if 'qm' not in self.ff_energy:
            self.ff_energy['qm'] = self.energy
        if 'qm' not in self.ff_gradient:
            self.ff_gradient['qm'] = self.gradient
        if self.classical_parameters is None:
            self.classical_parameters = Parameters.get_nan_params(self.molecule)
        self.mol_id = str(self.mol_id)
        n_confs, n_atoms = self.xyz.shape[0], self.xyz.shape[1]
        assert n_atoms == len(self.molecule.atoms)
        assert self.energy.shape == (n_confs,)
        assert self.energy_ref.shape == (n_confs,)
        assert self.gradient_ref.shape == (n_confs, n_atoms, 3)

    @property
    def n_confs(self) -> int:
        return self.xyz.shape[0]

    # ------------------------------------------------------------------
    @classmethod
    def from_arrays(cls, molecule: Molecule, xyz: np.ndarray,
                    energy: np.ndarray, nonbonded_energy: np.ndarray,
                    gradient: np.ndarray = None,
                    nonbonded_gradient: np.ndarray = None,
                    smiles: str = None, sequence: str = None,
                    mol_id: str = None) -> 'MolData':
        """Build from raw QM + classical-nonbonded arrays; the bonded target
        is energy - nonbonded, mean-centered."""
        energy_ref = energy - nonbonded_energy
        energy_ref = energy_ref - energy_ref.mean()
        # gradient and nonbonded_gradient are independently optional: a
        # missing one means zeros, not a TypeError / a silently discarded
        # provided array
        if gradient is None:
            gradient = np.zeros_like(xyz)
        if nonbonded_gradient is None:
            nonbonded_gradient = np.zeros_like(xyz)
        gradient_ref = gradient - nonbonded_gradient
        if mol_id is None:
            mol_id = smiles or sequence or ''
        return cls(
            molecule=molecule, xyz=xyz, energy=energy, gradient=gradient,
            energy_ref=energy_ref, gradient_ref=gradient_ref, mol_id=mol_id,
            smiles=smiles, sequence=sequence,
            ff_nonbonded_energy={'reference_ff': nonbonded_energy},
            ff_nonbonded_gradient={'reference_ff': nonbonded_gradient},
        )

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, np.ndarray]:
        d = {
            'xyz': self.xyz, 'energy': self.energy, 'gradient': self.gradient,
            'energy_ref': self.energy_ref, 'gradient_ref': self.gradient_ref,
            'mol_id': np.array(str(self.mol_id)),
        }
        for key in ('mapped_smiles', 'pdb', 'smiles', 'sequence'):
            val = getattr(self, key)
            if val is not None:
                d[key] = np.array(str(val))
        if self.improper_energy_ref is not None:
            d['improper_energy_ref'] = self.improper_energy_ref
        if self.improper_gradient_ref is not None:
            d['improper_gradient_ref'] = self.improper_gradient_ref

        d.update(self.molecule.to_dict())
        d.update({k: v for k, v in self.classical_parameters.to_dict().items()
                  if k not in _TUPLE_KEYS})
        for name, v in self.ff_energy.items():
            d[f'energy_{name}'] = v
        for name, v in self.ff_gradient.items():
            d[f'gradient_{name}'] = v
        for name, v in self.ff_nonbonded_energy.items():
            d[f'nonbonded_energy_{name}'] = v
        for name, v in self.ff_nonbonded_gradient.items():
            d[f'nonbonded_gradient_{name}'] = v
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, np.ndarray]) -> 'MolData':
        def as_str(key):
            v = d.get(key)
            return str(v) if v is not None else None

        mol_keys = {
            k: v for k, v in d.items()
            if k not in _PARAM_KEYS and k not in _STR_KEYS
            and k != 'xyz' and 'energy' not in k and 'gradient' not in k
        }
        molecule = Molecule.from_dict(mol_keys)
        params = Parameters.from_dict(
            {k: d[k] for k in (*_PARAM_KEYS, *_TUPLE_KEYS) if k in d})

        ff_energy = {k[len('energy_'):]: v for k, v in d.items()
                     if k.startswith('energy_') and k != 'energy_ref'}
        ff_gradient = {k[len('gradient_'):]: v for k, v in d.items()
                       if k.startswith('gradient_') and k != 'gradient_ref'}
        ff_nb_energy = {k[len('nonbonded_energy_'):]: v for k, v in d.items()
                        if k.startswith('nonbonded_energy_')}
        ff_nb_gradient = {k[len('nonbonded_gradient_'):]: v for k, v in d.items()
                          if k.startswith('nonbonded_gradient_')}

        return cls(
            molecule=molecule, xyz=d['xyz'], energy=d['energy'],
            gradient=d['gradient'], energy_ref=d['energy_ref'],
            gradient_ref=d['gradient_ref'], mol_id=as_str('mol_id'),
            classical_parameters=params,
            sequence=as_str('sequence'), smiles=as_str('smiles'),
            mapped_smiles=as_str('mapped_smiles'), pdb=as_str('pdb'),
            improper_energy_ref=d.get('improper_energy_ref'),
            improper_gradient_ref=d.get('improper_gradient_ref'),
            ff_energy=ff_energy, ff_gradient=ff_gradient,
            ff_nonbonded_energy=ff_nb_energy,
            ff_nonbonded_gradient=ff_nb_gradient,
        )

    def save(self, path: Union[str, Path]):
        np.savez(path, **self.to_dict())

    @classmethod
    def load(cls, path: Union[str, Path]) -> 'MolData':
        with np.load(path, allow_pickle=False) as data:
            return cls.from_dict(dict(data))
