"""Pure-Python/numpy graph featurizers: ring membership and node degree.

The reference obtains these features from RDKit (reference:
src/grappa/utils/rdkit_utils.py:6-67 — one-hot ring membership for ring
sizes 3..8 plus an any-ring flag, and one-hot degree 1..6). This module
computes the same encodings directly from the bond list, removing the RDKit
dependency from the core path.

Ring detection: an atom is "in a ring of size s" iff there exists a simple
cycle of length s through it. We first reduce the graph to its 2-core
(iteratively strip degree-<2 atoms — cycles only live there), then run a
bounded DFS per 2-core atom. For molecular graphs the 2-core is small and
sparse, so this is fast. NOTE: for unusual fused polycyclics this "all simple
cycles <= 8" definition can mark more ring sizes than RDKit's SSSR-based
ring info (e.g. norbornane's 6-ring); for standard organic chemistry the
encodings agree.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

MAX_RING_SIZE = 8
MIN_RING_SIZE = 3


def degree_encoding(bonds: Sequence[Tuple[int, int]], n_atoms: int) -> np.ndarray:
    """One-hot degree encoding of shape (n_atoms, 6) for degrees 1..6."""
    deg = np.zeros(n_atoms, dtype=np.int64)
    for a, b in bonds:
        deg[a] += 1
        deg[b] += 1
    enc = np.zeros((n_atoms, 6), dtype=np.float32)
    for i, d in enumerate(deg):
        if 1 <= d <= 6:
            enc[i, d - 1] = 1.0
    return enc


def _two_core(adj: Dict[int, set]) -> Dict[int, set]:
    """Iteratively remove atoms of degree < 2; returns the 2-core adjacency."""
    adj = {k: set(v) for k, v in adj.items()}
    changed = True
    while changed:
        changed = False
        for a in list(adj.keys()):
            if len(adj[a]) < 2:
                for b in adj[a]:
                    adj[b].discard(a)
                del adj[a]
                changed = True
    return adj


def ring_membership_sizes(
    bonds: Sequence[Tuple[int, int]], n_atoms: int,
    max_size: int = MAX_RING_SIZE,
) -> List[set]:
    """For each atom, the set of simple-cycle lengths (3..max_size) through it."""
    adj: Dict[int, set] = {i: set() for i in range(n_atoms)}
    for a, b in bonds:
        adj[int(a)].add(int(b))
        adj[int(b)].add(int(a))

    core = _two_core(adj)
    sizes: List[set] = [set() for _ in range(n_atoms)]
    if not core:
        return sizes

    # DFS for simple cycles: only count cycles whose minimal atom is the
    # start atom, so each cycle is found from exactly one root.
    for start in core:
        path = [start]
        on_path = {start}

        def dfs(current: int):
            depth = len(path)
            for nxt in core[current]:
                if nxt == start and depth >= MIN_RING_SIZE:
                    for atom in path:
                        sizes[atom].add(depth)
                elif nxt > start and nxt not in on_path and depth < max_size:
                    path.append(nxt)
                    on_path.add(nxt)
                    dfs(nxt)
                    path.pop()
                    on_path.discard(nxt)

        dfs(start)
    return sizes


def ring_encoding(bonds: Sequence[Tuple[int, int]], n_atoms: int) -> np.ndarray:
    """One-hot ring encoding of shape (n_atoms, 7):
    column 0 = in any ring, columns 1..6 = in ring of size 3..8."""
    sizes = ring_membership_sizes(bonds, n_atoms)
    enc = np.zeros((n_atoms, 7), dtype=np.float32)
    for i, s in enumerate(sizes):
        if s:
            enc[i, 0] = 1.0
            for size in s:
                if MIN_RING_SIZE <= size <= MAX_RING_SIZE:
                    enc[i, size - MIN_RING_SIZE + 1] = 1.0
    return enc

