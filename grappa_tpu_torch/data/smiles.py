"""First-party mapped-SMILES parser (connectivity only).

Counterpart of `grappa_tpu.data.smiles` (the port's own copy).

The espaloma benchmark archives identify molecules by openff mapped SMILES
(every atom bracketed with a map index, hydrogens explicit). The reference
rebuilds connectivity through openff/rdkit (reference: src/grappa/utils/
openff_utils.py:53-135); here a small pure-python parser extracts atoms and
bonds directly, so the archive -> dataset conversion needs no chem toolkit.

Only connectivity is extracted: bond orders, stereo markers and chirality
are irrelevant for the grappa graph (the model sees atomic numbers, bonds,
rings, degrees and charges). Supported: bracket atoms (isotope, symbol,
chirality, H-count, charge, map), organic-subset atoms, aromatic lowercase,
bond symbols - = # $ : / \\, branches, ring closures (incl. %nn), dots.

For mapped SMILES with explicit hydrogens the returned atom order follows
the map indices (map i -> position i-1), matching the xyz/charge array
order of the espaloma records.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

# periodic table through element 53 + a few beyond for robustness
_SYMBOLS = (
    'H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co '
    'Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb '
    'Te I Xe Cs Ba'
).split()
ATOMIC_NUMBER: Dict[str, int] = {s: i + 1 for i, s in enumerate(_SYMBOLS)}

_ORGANIC = ('Cl', 'Br', 'B', 'C', 'N', 'O', 'P', 'S', 'F', 'I')
_AROMATIC = {'b': 'B', 'c': 'C', 'n': 'N', 'o': 'O', 'p': 'P', 's': 'S'}

_BRACKET = re.compile(
    r'^(?P<isotope>\d+)?'
    r'(?P<symbol>[A-Z][a-z]?|[bcnops]|se|as)'
    r'(?P<chiral>@{1,2}(?:TH\d|AL\d|SP\d|TB\d\d?|OH\d\d?)?)?'
    r'(?P<hcount>H\d*)?'
    r'(?P<charge>\+{1,3}|-{1,3}|[+-]\d+)?'
    r'(?:\:(?P<map>\d+))?$'
)

_BOND_CHARS = '-=#$:/\\'


class SmilesError(ValueError):
    pass


def parse_mapped_smiles(smiles: str) -> Tuple[np.ndarray, np.ndarray,
                                              Optional[np.ndarray]]:
    """Parse a (mapped) SMILES string.

    Returns (atomic_numbers (N,), bonds (B, 2) 0-based, map_order or None).
    If every atom carries a map index, atoms/bonds are re-ordered so atom i
    is the atom with map index i+1 (the espaloma array order); map_order is
    then the permutation applied. Unmapped SMILES keep parse order.
    """
    atoms: List[int] = []            # atomic numbers, parse order
    maps: List[Optional[int]] = []
    bonds: List[Tuple[int, int]] = []
    ring_open: Dict[str, int] = {}
    stack: List[int] = []
    prev: Optional[int] = None
    pending_dot = False

    def add_atom(z: int, map_idx: Optional[int]):
        nonlocal prev, pending_dot
        idx = len(atoms)
        atoms.append(z)
        maps.append(map_idx)
        if prev is not None and not pending_dot:
            bonds.append((prev, idx))
        pending_dot = False
        prev = idx

    def close_ring(label: str):
        if prev is None:
            raise SmilesError(
                f"ring-closure digit {label!r} before any atom")
        if label in ring_open:
            other = ring_open.pop(label)
            if other == prev:
                raise SmilesError(f"ring bond to self at label {label}")
            bonds.append((other, prev))
        else:
            ring_open[label] = prev

    i, n = 0, len(smiles)
    while i < n:
        c = smiles[i]
        if c == '[':
            j = smiles.find(']', i)
            if j < 0:
                raise SmilesError(f"unclosed bracket at {i}: {smiles}")
            m = _BRACKET.match(smiles[i + 1:j])
            if not m:
                raise SmilesError(f"bad bracket atom '{smiles[i+1:j]}'")
            sym = m.group('symbol')
            sym = _AROMATIC.get(sym, sym[0].upper() + sym[1:])
            if sym not in ATOMIC_NUMBER:
                raise SmilesError(f"unknown element '{sym}'")
            map_idx = m.group('map')
            add_atom(ATOMIC_NUMBER[sym],
                     int(map_idx) if map_idx is not None else None)
            i = j + 1
        elif c == '(':
            if prev is None:
                raise SmilesError("branch with no preceding atom")
            stack.append(prev)
            i += 1
        elif c == ')':
            if not stack:
                raise SmilesError("unbalanced ')'")
            prev = stack.pop()
            i += 1
        elif c in _BOND_CHARS:
            i += 1                       # connectivity only; order ignored
        elif c == '.':
            pending_dot = True
            i += 1
        elif c == '%':
            if i + 2 >= n or not smiles[i + 1:i + 3].isdigit():
                raise SmilesError(f"bad ring label at {i}")
            close_ring(smiles[i + 1:i + 3])
            i += 3
        elif c.isdigit():
            close_ring(c)
            i += 1
        elif c.isalpha() or c == '*':
            if c == '*':
                raise SmilesError("wildcard atoms not supported")
            two = smiles[i:i + 2]
            if two in _ORGANIC:
                add_atom(ATOMIC_NUMBER[two], None)
                i += 2
            elif c.upper() in _ORGANIC or c in _AROMATIC:
                sym = _AROMATIC.get(c, c.upper())
                add_atom(ATOMIC_NUMBER[sym], None)
                i += 1
            else:
                raise SmilesError(f"unexpected atom char '{c}' at {i}")
        else:
            raise SmilesError(f"unexpected char '{c}' at {i}")

    if ring_open:
        raise SmilesError(f"unclosed ring bonds: {sorted(ring_open)}")
    if stack:
        raise SmilesError("unbalanced '('")

    atomic_numbers = np.asarray(atoms, np.int64)
    bond_arr = np.asarray(bonds, np.int64).reshape(-1, 2)

    if maps and all(m is not None for m in maps):
        order = np.asarray(maps, np.int64)
        if sorted(order) != list(range(1, len(atoms) + 1)):
            raise SmilesError(
                f"map indices must be a permutation of 1..{len(atoms)}")
        # position in output = map - 1
        perm = np.empty(len(atoms), np.int64)
        perm[order - 1] = np.arange(len(atoms))
        inv = order - 1                   # parse idx -> output idx
        atomic_numbers = atomic_numbers[perm]
        if bond_arr.size:
            bond_arr = inv[bond_arr]
        return atomic_numbers, bond_arr, perm
    return atomic_numbers, bond_arr, None
