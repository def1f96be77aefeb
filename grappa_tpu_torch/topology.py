"""Molecular-graph topology algorithms: enumeration of bonded interaction
tuples from the bond list, and canonicalization of improper torsions.

These functions define the *parameter semantics* of the whole framework: which
tuples exist, their canonical atom order, and the convention that each
improper torsion is stored as three independent cyclic permutations with the
central atom pinned at ``constants.IMPROPER_CENTRAL_IDX``.

Behavioral parity with the reference (reference: src/grappa/utils/
tuple_indices.py:7-216):
  * bonds are canonicalized to (a, b) with a < b
  * angles (a, b, c) satisfy a < c
  * propers (a, b, c, d) satisfy a < d
  * an improper is a tuple with one atom bonded to all three others; the three
    stored versions are cyclic permutations of the outer atoms (only 3 of the
    3! outer-atom permutations are independent because the dihedral is
    antisymmetric under exchange of first/last and of second/third atom).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from grappa_tpu_torch.constants import IMPROPER_CENTRAL_IDX


def neighbor_map(bonds: Iterable[Tuple[int, int]]) -> Dict[int, List[int]]:
    """Build a sorted adjacency map atom_id -> sorted list of neighbor ids."""
    nbrs: Dict[int, List[int]] = {}
    for bond in bonds:
        a, b = int(bond[0]), int(bond[1])
        if a == b:
            raise ValueError(f"self-bond encountered: {bond}")
        nbrs.setdefault(a, []).append(b)
        nbrs.setdefault(b, []).append(a)
    for k in nbrs:
        nbrs[k].sort()
    return nbrs


def enumerate_angles_propers(
    bonds: Sequence[Tuple[int, int]],
    nbrs: Optional[Dict[int, List[int]]] = None,
) -> Tuple[List[Tuple[int, int, int]], List[Tuple[int, int, int, int]]]:
    """Enumerate all angles and proper torsions from the bond list.

    Each angle appears once with angle[0] < angle[2]; each proper appears once
    with proper[0] < proper[3].
    """
    if nbrs is None:
        nbrs = neighbor_map(bonds)

    angles: List[Tuple[int, int, int]] = []
    propers: List[Tuple[int, int, int, int]] = []

    for a in sorted(nbrs.keys()):
        for b in nbrs[a]:
            for c in nbrs[b]:
                if c == a:
                    continue
                if a < c:
                    angles.append((a, b, c))
                # propers: walk one step further; enforce d < a so each
                # proper is produced exactly once as (d, c, b, a) with d < a.
                for d in nbrs[c]:
                    if d >= a:
                        break  # neighbor lists are sorted ascending
                    if d == b:
                        continue
                    propers.append((d, c, b, a))
    return angles, propers


def enumerate_angles_propers_fast(bonds: Sequence[Tuple[int, int]]):
    """Like enumerate_angles_propers but returns int arrays. The JAX
    package may take its native C++ path here; the canonical order is the
    same (loading that library is queued for the port)."""
    import numpy as np
    angles, propers = enumerate_angles_propers(bonds)
    return (np.asarray(angles, dtype=np.int64).reshape(-1, 3),
            np.asarray(propers, dtype=np.int64).reshape(-1, 4))


def canonicalize_bonds(bonds: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    return [(int(a), int(b)) if a < b else (int(b), int(a)) for a, b in bonds]


def improper_center(
    torsion: Sequence[int], nbrs: Dict[int, List[int]]
) -> Optional[int]:
    """If `torsion` is an improper, return the position of its central atom
    (the atom bonded to all three others), else None.

    Positions are tried in the order (2, 1, 0, 3) so that amber-style input
    (central atom third) resolves without search.
    """
    for pos in (2, 1, 0, 3):
        center = torsion[pos]
        center_nbrs = nbrs.get(center, ())
        if all(atom in center_nbrs for atom in torsion if atom != center):
            return pos
    return None


def is_proper_torsion(torsion: Sequence[int], nbrs: Dict[int, List[int]]) -> bool:
    """True iff consecutive atoms of the tuple are bonded (a-b, b-c, c-d)."""
    return (
        torsion[0] in nbrs.get(torsion[1], ())
        and torsion[1] in nbrs.get(torsion[2], ())
        and torsion[2] in nbrs.get(torsion[3], ())
    )


def classify_torsions(
    torsions: Iterable[Sequence[int]],
    nbrs: Dict[int, List[int]],
    central_position: int = IMPROPER_CENTRAL_IDX,
) -> Tuple[List[Tuple[int, int, int, int]], List[Tuple[int, int, int, int]]]:
    """Split a list of 4-tuples into propers and canonicalized impropers.

    Propers keep their input order (deduplicated by atom set, reversal-
    invariant). Each improper atom set is emitted as THREE tuples: the outer
    atoms cyclically permuted, the central atom fixed at `central_position`.
    A torsion that is both proper and improper (4-ring) counts as proper.
    """
    propers: List[Tuple[int, int, int, int]] = []
    impropers: List[Tuple[int, int, int, int]] = []
    seen: set = set()

    for torsion in torsions:
        torsion = tuple(int(x) for x in torsion)
        key = tuple(sorted(torsion))
        if key in seen:
            continue

        center_pos = improper_center(torsion, nbrs)
        proper = is_proper_torsion(torsion, nbrs)
        if proper:
            center_pos = None  # proper wins for 4-rings
        if center_pos is None and not proper:
            raise ValueError(
                f"torsion {torsion} is neither proper nor improper")

        seen.add(key)
        if center_pos is None:
            propers.append(torsion)
        else:
            center = torsion[center_pos]
            outer = [torsion[i] for i in range(4) if i != center_pos]
            for cyc in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
                ordered = [outer[i] for i in cyc]
                version = (
                    ordered[:central_position]
                    + [center]
                    + ordered[central_position:]
                )
                impropers.append(tuple(version))
    return propers, impropers


def canonical_impropers_from_sets(
    improper_sets: Iterable[Sequence[int]],
    nbrs: Dict[int, List[int]],
    central_position: int = IMPROPER_CENTRAL_IDX,
) -> List[Tuple[int, int, int, int]]:
    """Canonicalize improper torsions given only their atom sets."""
    _, impropers = classify_torsions(improper_sets, nbrs, central_position)
    return impropers


def check_connected(bonds: Sequence[Tuple[int, int]], n_atoms: int) -> bool:
    """True iff the bond graph is connected over atoms 0..n_atoms-1."""
    if n_atoms == 0:
        return True
    nbrs = neighbor_map(bonds)
    if len(nbrs) < n_atoms:
        return False
    seen = {next(iter(nbrs))}
    stack = list(seen)
    while stack:
        a = stack.pop()
        for b in nbrs[a]:
            if b not in seen:
                seen.add(b)
                stack.append(b)
    return len(seen) == n_atoms
