"""The framework's input data class: a molecular graph with per-atom features.

Schema-compatible with the reference input class (reference:
src/grappa/data/Molecule.py:17-689): atoms are identified by ids (not
necessarily contiguous), bonds/angles/propers are canonically ordered, and
every improper torsion is stored as three independent cyclic versions with
the central atom at ``constants.IMPROPER_CENTRAL_IDX``. The npz / json
serialization layout matches the reference so datasets interchange freely.

Featurization (ring membership, degree, masses, charge-model one-hot) is
computed with pure numpy (grappa_tpu_torch.graph_features) instead of RDKit.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from grappa_tpu_torch import constants, topology
from grappa_tpu_torch.graph_features import degree_encoding, ring_encoding

_CORE_KEYS = ('atoms', 'bonds', 'angles', 'propers', 'impropers',
              'atomic_numbers', 'partial_charges')


class Molecule:
    """A molecular graph: atoms, bonds, interaction tuples, atom features."""

    def __init__(
        self,
        atoms: Union[Sequence[int], np.ndarray],
        bonds: Union[Sequence[Tuple[int, int]], np.ndarray],
        impropers: Union[Sequence[Tuple[int, int, int, int]], np.ndarray],
        atomic_numbers: Sequence[int],
        partial_charges: Sequence[float],
        additional_features: Optional[Dict[str, np.ndarray]] = None,
        angles: Optional[Union[Sequence, np.ndarray]] = None,
        propers: Optional[Union[Sequence, np.ndarray]] = None,
        improper_in_correct_format: bool = False,
        add_ring_encoding: bool = True,
        add_degree: bool = True,
        add_mass_encoding: bool = True,
        charge_model: str = 'amber99',
    ):
        self.atoms = np.asarray(atoms, dtype=np.int64)
        self.bonds = np.asarray(topology.canonicalize_bonds(bonds),
                                dtype=np.int64).reshape(-1, 2)
        self.atomic_numbers = np.asarray(atomic_numbers, dtype=np.int64)
        self.partial_charges = np.asarray(partial_charges, dtype=np.float32)
        self.additional_features = dict(additional_features or {})
        self.charge_model = charge_model

        if charge_model not in constants.CHARGE_MODELS:
            raise ValueError(
                f"charge_model must be one of {constants.CHARGE_MODELS}, "
                f"got {charge_model}")

        self._neighbor_map = topology.neighbor_map(self.bonds)

        # enumerate angles/propers from bonds if not given
        if angles is None or propers is None:
            auto_angles, auto_propers = topology.enumerate_angles_propers_fast(
                self.bonds)
            if angles is None:
                angles = auto_angles
            if propers is None:
                propers = auto_propers
        self.angles = np.asarray(angles, dtype=np.int64).reshape(-1, 3)
        self.propers = np.asarray(propers, dtype=np.int64).reshape(-1, 4)

        # canonicalize impropers into the 3-cyclic-versions convention
        impropers = np.asarray(impropers, dtype=np.int64).reshape(-1, 4)
        if not improper_in_correct_format and len(impropers) > 0:
            impropers = np.asarray(
                topology.canonical_impropers_from_sets(
                    impropers, self._neighbor_map),
                dtype=np.int64).reshape(-1, 4)
        self.impropers = impropers

        # default features
        n = len(self.atoms)
        if 'charge_model' not in self.additional_features:
            onehot = np.array(
                [cm == self.charge_model for cm in constants.CHARGE_MODELS],
                dtype=np.float32)
            self.additional_features['charge_model'] = np.tile(onehot, (n, 1))
        if 'is_radical' not in self.additional_features:
            self.additional_features['is_radical'] = np.zeros(n, np.float32)

        idx_bonds = self.bonds_by_index()
        if add_mass_encoding and 'mass' not in self.additional_features:
            masses = np.array(
                [constants.ATOMIC_MASSES[int(z)] for z in self.atomic_numbers],
                dtype=np.float32)
            self.additional_features['mass'] = np.stack(
                (masses, np.log(masses)), axis=1)
        if add_ring_encoding and 'ring_encoding' not in self.additional_features:
            self.additional_features['ring_encoding'] = ring_encoding(
                idx_bonds, n)
        if add_degree and 'degree' not in self.additional_features:
            self.additional_features['degree'] = degree_encoding(idx_bonds, n)

        self._validate()

    # ------------------------------------------------------------------
    def _validate(self):
        n = len(self.atoms)
        assert len(self.atomic_numbers) == n and len(self.partial_charges) == n
        if len(np.unique(self.atoms)) != n:
            raise ValueError("atom ids must be unique")
        for name, feat in self.additional_features.items():
            if len(feat) != n:
                raise ValueError(
                    f"feature {name} has {len(feat)} rows, expected {n}")
        if len(self.impropers) % 3 != 0:
            raise ValueError(
                "impropers must come in 3 cyclic versions per atom set")

    @property
    def neighbor_map(self) -> Dict[int, List[int]]:
        return self._neighbor_map

    def index_of(self) -> Dict[int, int]:
        """Mapping atom id -> index into self.atoms."""
        return {int(a): i for i, a in enumerate(self.atoms)}

    def _ids_to_idx(self, tuples: np.ndarray) -> np.ndarray:
        if tuples.size == 0:
            return tuples.astype(np.int32)
        # vectorized id->index via searchsorted (a python dict + vectorize
        # costs O(N) dict build + a python call per element — noticeable at
        # macromolecule scale where this runs 4x per graph build)
        order = np.argsort(self.atoms, kind='stable')
        pos = np.searchsorted(self.atoms[order], tuples)
        pos = np.minimum(pos, len(order) - 1)
        idx = order[pos]
        if not np.array_equal(self.atoms[idx], np.asarray(tuples)):
            missing = np.asarray(tuples)[self.atoms[idx]
                                         != np.asarray(tuples)]
            raise KeyError(f"unknown atom ids in tuples: {missing[:5]}")
        return idx.astype(np.int32)

    def bonds_by_index(self) -> np.ndarray:
        return self._ids_to_idx(self.bonds)

    def tuple_indices(self) -> Dict[str, np.ndarray]:
        """All interaction tuples as 0-based indices into self.atoms.

        Keys: n2 (bonds), n3 (angles), n4 (propers), n4_improper.
        """
        return {
            'n2': self._ids_to_idx(self.bonds),
            'n3': self._ids_to_idx(self.angles),
            'n4': self._ids_to_idx(self.propers),
            'n4_improper': self._ids_to_idx(self.impropers),
        }

    def input_features(self, max_element: int = constants.MAX_ELEMENT,
                       exclude: Sequence[str] = ()) -> Dict[str, np.ndarray]:
        """Per-atom input feature arrays keyed by feature name.

        atomic_number is one-hot encoded over 1..max_element; partial_charge
        stays scalar (shape (n,)). Additional features pass through.
        """
        if self.atomic_numbers.min() < 1 or self.atomic_numbers.max() > max_element:
            raise ValueError(
                f"atomic numbers must be in [1, {max_element}], got range "
                f"[{self.atomic_numbers.min()}, {self.atomic_numbers.max()}]")
        onehot = np.zeros((len(self.atoms), max_element), dtype=np.float32)
        onehot[np.arange(len(self.atoms)), self.atomic_numbers - 1] = 1.0
        feats = {
            'atomic_number': onehot,
            'partial_charge': self.partial_charges.astype(np.float32),
        }
        for k, v in self.additional_features.items():
            if k not in exclude:
                feats[k] = np.asarray(v, dtype=np.float32)
        return feats

    def sort(self):
        """Canonicalize tuple directions: first id < last id (impropers untouched)."""
        self.bonds = np.sort(self.bonds, axis=1)
        flip = self.angles[:, 0] > self.angles[:, 2]
        self.angles[flip] = self.angles[flip][:, ::-1]
        flip = self.propers[:, 0] > self.propers[:, 3]
        self.propers[flip] = self.propers[flip][:, ::-1]

    # ------------------------------------------------------------------
    # serialization (npz layout matches the reference for interchange)
    def to_dict(self) -> Dict[str, np.ndarray]:
        assert all(k not in _CORE_KEYS for k in self.additional_features)
        return {
            'atoms': self.atoms.astype(np.int64),
            'bonds': self.bonds.astype(np.int64),
            'angles': self.angles.astype(np.int64),
            'propers': self.propers.astype(np.int64),
            'impropers': self.impropers.astype(np.int64),
            'atomic_numbers': self.atomic_numbers.astype(np.int64),
            'partial_charges': self.partial_charges.astype(np.float32),
            **{k: np.asarray(v) for k, v in self.additional_features.items()},
        }

    @classmethod
    def from_dict(cls, d: Dict[str, np.ndarray]) -> 'Molecule':
        extra = {k: np.asarray(d[k]) for k in d.keys() if k not in _CORE_KEYS}
        charge_model = 'amber99'
        if 'charge_model' in extra and len(extra['charge_model']) > 0:
            row = np.asarray(extra['charge_model'])[0]
            for i, cm in enumerate(constants.CHARGE_MODELS):
                if i < len(row) and row[i] > 0.5:
                    charge_model = cm
        return cls(
            atoms=d['atoms'], bonds=d['bonds'], angles=d['angles'],
            propers=d['propers'], impropers=d['impropers'],
            atomic_numbers=d['atomic_numbers'],
            partial_charges=d['partial_charges'],
            additional_features=extra,
            improper_in_correct_format=True,
            charge_model=charge_model,
        )

    def save(self, path: Union[str, Path]):
        np.savez(path, **self.to_dict())

    @classmethod
    def load(cls, path: Union[str, Path]) -> 'Molecule':
        with np.load(path) as data:
            return cls.from_dict(dict(data))

    def to_json(self, path: Union[str, Path]):
        with open(path, 'w') as f:
            json.dump({k: v.tolist() for k, v in self.to_dict().items()}, f)

    @classmethod
    def from_json(cls, path: Union[str, Path]) -> 'Molecule':
        with open(path) as f:
            d = json.load(f)
        return cls.from_dict({k: np.array(v) for k, v in d.items()})

    # ------------------------------------------------------------------
    def set_radical_flags(self, is_radical: Union[Sequence[bool], np.ndarray]):
        arr = np.asarray(is_radical, dtype=np.float32).reshape(-1)
        assert len(arr) == len(self.atoms)
        self.additional_features['is_radical'] = arr

    def __len__(self):
        return len(self.atoms)

    def __repr__(self):
        return (f"<grappa_tpu_torch Molecule ({len(self.atoms)} atoms, "
                f"{len(self.bonds)} bonds, {len(self.angles)} angles, "
                f"{len(self.propers)} propers, {len(self.impropers) // 3} "
                f"impropers)>")

    # ------------------------------------------------------------------
    @classmethod
    def random(cls) -> 'Molecule':
        """Tiny fixed toy molecule (A-B-C-D chain plus E on B)."""
        return cls(
            atoms=[0, 1, 2, 3, 4],
            bonds=[(0, 1), (1, 2), (2, 3), (1, 4)],
            impropers=[(0, 2, 1, 4)],
            atomic_numbers=[1, 6, 7, 8, 1],
            partial_charges=[0.0, 0.2, 0.3, -0.5, 0.0],
        )

    @classmethod
    def random_chain(cls, n_atoms: int = 12, seed: int = 0,
                     charge_model: str = 'amber99') -> 'Molecule':
        """Random tree-shaped molecule for tests/benchmarks (deterministic)."""
        rng = np.random.default_rng(seed)
        bonds = []
        for i in range(1, n_atoms):
            parent = int(rng.integers(max(0, i - 3), i))
            bonds.append((parent, i))
        zs = rng.choice([1, 6, 7, 8, 16], size=n_atoms)
        charges = rng.normal(0, 0.3, size=n_atoms).astype(np.float32)
        charges -= charges.mean()
        return cls(
            atoms=np.arange(n_atoms), bonds=bonds, impropers=[],
            atomic_numbers=zs, partial_charges=charges,
            improper_in_correct_format=True, charge_model=charge_model,
        )
