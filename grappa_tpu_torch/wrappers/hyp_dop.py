"""Hydroxyproline (HYP) / dihydroxyphenylalanine (DOP) residue support
(optional, openmm-gated). Counterpart of `grappa_tpu.wrappers.hyp_dop`.

Counterpart of the reference utility (reference: src/grappa/utils/
hyp_dop_utility.py:9-238 + amber99sbildn-star_.xml): PDB files with these
non-standard residues lack the template bonds, so an amber99sbildn-style
force field cannot type them. This module adds the missing intra-residue
bonds (and the standard backbone peptide bonds to neighboring residues) to
an openmm Topology so downstream parametrization works.

The bond templates below encode the heavy-atom + hydrogen connectivity of
the two residues by atom name.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Set, Tuple

# atom-name bond templates (intra-residue), derived from the residue
# template data of the star force field (reference amber99sbildn-star_.xml
# residue entries; atom naming matches the reference exactly)
from grappa_tpu_torch.wrappers.star_forcefield import (
    residue_bond_templates)

RESIDUE_BONDS: Dict[str, List[Tuple[str, str]]] = residue_bond_templates()
HYP_BONDS: List[Tuple[str, str]] = RESIDUE_BONDS['HYP']
DOP_BONDS: List[Tuple[str, str]] = RESIDUE_BONDS['DOP']


def _require_openmm():
    if importlib.util.find_spec('openmm') is None:
        raise ImportError("openmm is required for HYP/DOP topology repair")


def add_nonstandard_residue_bonds(openmm_topology,
                                  residue_names: Set[str] = frozenset(
                                      RESIDUE_BONDS)) -> int:
    """Add missing intra-residue bonds for HYP/DOP residues and the peptide
    bond to the preceding/following residue. Returns the number of bonds
    added. Operates in place on the topology."""
    _require_openmm()

    existing = {frozenset((a.index, b.index))
                for a, b in openmm_topology.bonds()}
    added = 0

    def add(a, b):
        nonlocal added
        key = frozenset((a.index, b.index))
        if key not in existing:
            openmm_topology.addBond(a, b)
            existing.add(key)
            added += 1

    for chain in openmm_topology.chains():
        residues = list(chain.residues())
        for i, res in enumerate(residues):
            name = res.name.upper().strip()
            if name not in residue_names or name not in RESIDUE_BONDS:
                continue
            atoms = {a.name: a for a in res.atoms()}
            for n1, n2 in RESIDUE_BONDS[name]:
                if n1 in atoms and n2 in atoms:
                    add(atoms[n1], atoms[n2])
            # backbone peptide bonds to neighbors
            if i > 0:
                prev_atoms = {a.name: a for a in residues[i - 1].atoms()}
                if 'C' in prev_atoms and 'N' in atoms:
                    add(prev_atoms['C'], atoms['N'])
            if i + 1 < len(residues):
                next_atoms = {a.name: a for a in residues[i + 1].atoms()}
                if 'C' in atoms and 'N' in next_atoms:
                    add(atoms['C'], next_atoms['N'])
    return added
