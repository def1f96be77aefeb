"""Output data class: classical MM bonded parameters for one molecule.

Field layout and conventions match the reference output class (reference:
src/grappa/data/Parameters.py:21-140): tuples are atom *ids* in the same
order as the Molecule's tuple lists; torsion phases are restricted to
{0, pi} and can be folded into the sign of k ("signed k"); eq-value sanity
checks guard against collapsed geometries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from grappa_tpu_torch import constants
from grappa_tpu_torch.data.molecule import Molecule


@dataclass
class Parameters:
    atoms: np.ndarray

    bonds: np.ndarray          # (B, 2) atom ids
    bond_k: np.ndarray         # (B,) kcal/mol/A^2
    bond_eq: np.ndarray        # (B,) A

    angles: np.ndarray         # (A, 3) atom ids
    angle_k: np.ndarray        # (A,) kcal/mol/rad^2
    angle_eq: np.ndarray       # (A,) rad

    propers: np.ndarray        # (P, 4) atom ids
    proper_ks: np.ndarray      # (P, n_periodicity) kcal/mol, >= 0
    proper_phases: np.ndarray  # (P, n_periodicity) in {0, pi}

    impropers: Optional[np.ndarray] = None
    improper_ks: Optional[np.ndarray] = None
    improper_phases: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    @staticmethod
    def to_signed_k(k: np.ndarray, phase: np.ndarray) -> np.ndarray:
        """Fold phase {0, pi} into the sign of k (phase pi => negative k)."""
        k = np.asarray(k)
        # normalize into [0, 2pi) so physically identical phases (e.g.
        # -pi == +pi, common in engine-exported torsions) are accepted
        phase = np.mod(np.asarray(phase, np.float64), 2 * np.pi)
        valid = (np.asarray(k >= 0) | np.isnan(k))
        assert np.all(valid), "force constants must be non-negative"
        near0 = np.isclose(phase, 0, atol=1e-2) | np.isclose(
            phase, 2 * np.pi, atol=1e-2)
        nearpi = np.isclose(phase, np.pi, atol=1e-2)
        if not np.all(near0 | nearpi | np.isnan(phase)):
            raise ValueError("phases must be 0, pi or 2pi")
        return np.where(near0, k, -k)

    @staticmethod
    def from_signed_k(signed_k: np.ndarray):
        """Split signed k into (k >= 0, phase in {0, pi})."""
        signed_k = np.asarray(signed_k)
        phases = np.where(signed_k >= 0, 0.0, np.pi).astype(signed_k.dtype)
        return np.abs(signed_k), phases

    # ------------------------------------------------------------------
    @classmethod
    def from_prediction(cls, molecule: Molecule,
                        pred: Dict[str, np.ndarray],
                        check_eq_values: bool = True) -> 'Parameters':
        """Build Parameters from a model-output dict.

        `pred` keys (per-tuple arrays, indices aligned with the molecule's
        tuple lists): n2_k, n2_eq, n3_k, n3_eq, n4_k (signed),
        n4_improper_k (signed).
        """
        angle_eq = np.asarray(pred['n3_eq'])
        bond_eq = np.asarray(pred['n2_eq'])
        if check_eq_values:
            if np.any(angle_eq < np.pi / 180 * 45):
                raise RuntimeError(
                    f"{np.sum(angle_eq < np.pi / 4)} predicted equilibrium "
                    f"angles below 45 deg (min {angle_eq.min() * 180 / np.pi:.2f} deg); "
                    "this indicates numerical instability.")
            if np.any(bond_eq < 0.5):
                raise RuntimeError(
                    f"{np.sum(bond_eq < 0.5)} predicted equilibrium bond "
                    f"lengths below 0.5 A (min {bond_eq.min():.3f} A); "
                    "this indicates numerical instability.")

        proper_ks, proper_phases = cls.from_signed_k(pred['n4_k'])
        improper_ks, improper_phases = cls.from_signed_k(pred['n4_improper_k'])
        return cls(
            atoms=np.asarray(molecule.atoms),
            bonds=np.asarray(molecule.bonds),
            bond_k=np.asarray(pred['n2_k']),
            bond_eq=bond_eq,
            angles=np.asarray(molecule.angles),
            angle_k=np.asarray(pred['n3_k']),
            angle_eq=angle_eq,
            propers=np.asarray(molecule.propers),
            proper_ks=proper_ks,
            proper_phases=proper_phases,
            impropers=np.asarray(molecule.impropers),
            improper_ks=improper_ks,
            improper_phases=improper_phases,
        )

    @classmethod
    def get_nan_params(cls, mol: Molecule) -> 'Parameters':
        """NaN placeholders in the right shapes (for molecules without
        classical parameters; NaNs are masked out of the parameter loss)."""
        nb, na = len(mol.bonds), len(mol.angles)
        np_, ni = len(mol.propers), len(mol.impropers)
        return cls(
            atoms=np.asarray(mol.atoms, dtype=np.int32),
            bonds=np.asarray(mol.bonds, dtype=np.int32),
            bond_k=np.full(nb, np.nan), bond_eq=np.full(nb, np.nan),
            angles=np.asarray(mol.angles, dtype=np.int32),
            angle_k=np.full(na, np.nan), angle_eq=np.full(na, np.nan),
            propers=np.asarray(mol.propers, dtype=np.int32),
            proper_ks=np.full((np_, constants.N_PERIODICITY_PROPER), np.nan),
            proper_phases=np.full((np_, constants.N_PERIODICITY_PROPER), np.nan),
            impropers=np.asarray(mol.impropers, dtype=np.int32),
            improper_ks=np.full((ni, constants.N_PERIODICITY_IMPROPER), np.nan),
            improper_phases=np.full((ni, constants.N_PERIODICITY_IMPROPER), np.nan),
        )

    # ------------------------------------------------------------------
    def signed_k_dict(self, n_periodicity_proper: int = None,
                      n_periodicity_improper: int = None) -> Dict[str, np.ndarray]:
        """Training-target arrays in signed-k convention, padded/truncated to
        the requested periodicities. Keys: n2_k, n2_eq, n3_k, n3_eq, n4_k,
        n4_improper_k. NaN parameters propagate (masked later)."""
        npp = n_periodicity_proper or constants.N_PERIODICITY_PROPER
        npi = n_periodicity_improper or constants.N_PERIODICITY_IMPROPER

        def fit(x, cols):
            x = np.asarray(x, dtype=np.float32)
            if x.size == 0:       # no tuples: reshape(0, -1) is ambiguous
                return np.zeros((len(x), cols), np.float32)
            x = x.reshape(len(x), -1)
            if x.shape[1] < cols:
                pad = np.zeros((x.shape[0], cols - x.shape[1]), x.dtype)
                if np.isnan(x).all():
                    pad[:] = np.nan
                x = np.concatenate([x, pad], axis=1)
            return x[:, :cols]

        def signed(ks, phases):
            ks = np.asarray(ks, dtype=np.float32)
            if np.isnan(ks).all():
                return ks
            return self.to_signed_k(ks, phases).astype(np.float32)

        return {
            'n2_k': np.asarray(self.bond_k, dtype=np.float32),
            'n2_eq': np.asarray(self.bond_eq, dtype=np.float32),
            'n3_k': np.asarray(self.angle_k, dtype=np.float32),
            'n3_eq': np.asarray(self.angle_eq, dtype=np.float32),
            'n4_k': fit(signed(self.proper_ks, self.proper_phases), npp),
            'n4_improper_k': fit(
                signed(self.improper_ks, self.improper_phases), npi)
            if self.impropers is not None and len(self.impropers) else
            np.zeros((0, npi), np.float32),
        }

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, np.ndarray]:
        d = {
            'atoms': self.atoms, 'bonds': self.bonds, 'bond_k': self.bond_k,
            'bond_eq': self.bond_eq, 'angles': self.angles,
            'angle_k': self.angle_k, 'angle_eq': self.angle_eq,
            'propers': self.propers, 'proper_ks': self.proper_ks,
            'proper_phases': self.proper_phases,
        }
        if self.impropers is not None:
            d['impropers'] = self.impropers
            d['improper_ks'] = self.improper_ks
            d['improper_phases'] = self.improper_phases
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, np.ndarray]) -> 'Parameters':
        return cls(**{k: np.asarray(v) for k, v in d.items()})

    def __len__(self):
        return len(self.atoms)

    @classmethod
    def random(cls, seed: int = 0) -> 'Parameters':
        """Plausible random parameters for the toy molecule (for tests)."""
        rng = np.random.default_rng(seed)
        mol = Molecule.random()
        p = cls.get_nan_params(mol)
        p.bond_k = rng.normal(100, 3, len(p.bonds))
        p.bond_eq = rng.normal(1.3, 0.1, len(p.bonds))
        p.angle_k = rng.normal(10, 1, len(p.angles))
        p.angle_eq = rng.normal(1.9, 0.1, len(p.angles))
        p.proper_ks = np.abs(rng.normal(0, 1, p.proper_ks.shape))
        p.improper_ks = np.abs(rng.normal(0, 1, p.improper_ks.shape))
        p.proper_phases = np.zeros_like(p.proper_ks)
        p.improper_phases = np.zeros_like(p.improper_ks)
        return p

