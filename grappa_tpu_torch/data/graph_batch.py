"""Flat, padded batch of molecular graphs as torch tensors.

A molecule is a set of flat numpy arrays (`MolGraph`); a batch is one
concatenation into preallocated padded buffers (`collate`) with

  * per-node / per-tuple boolean masks for padding,
  * int32 segment ids (`*_mol`) mapping nodes/tuples to their molecule,
  * a padded fixed-width neighbor list for message passing,
  * a conformer axis of fixed length with a per-molecule conf mask.

Padded tuples point at node 0 and are masked; padded conformers replicate the
last valid conformer so that all geometry stays non-degenerate. The arrays
equal the JAX package's `grappa_tpu.data.graph_batch.collate` element for
element; only the container (torch tensors on a chosen device) differs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from grappa_tpu_torch import constants
from grappa_tpu_torch.data.moldata import MolData
from grappa_tpu_torch.data.molecule import Molecule
from grappa_tpu_torch.utils import resolve_device

TERMS = ('n2', 'n3', 'n4', 'n4_improper')
TERM_ARITY = {'n2': 2, 'n3': 3, 'n4': 4, 'n4_improper': 4}


# ----------------------------------------------------------------------
# host-side, per-molecule arrays (numpy, unpadded)
@dataclass
class MolGraph:
    """One molecule as flat numpy arrays, ready for collation."""

    feats: Dict[str, np.ndarray]            # name -> (N, d) or (N,)
    neighbors: np.ndarray                   # (N, MAX_NEIGHBORS) int32
    neighbor_mask: np.ndarray               # (N, MAX_NEIGHBORS) bool
    tuple_idxs: Dict[str, np.ndarray]       # term -> (T, arity) int32
    xyz: np.ndarray                         # (N, C, 3) float32
    energy_ref: np.ndarray                  # (C,) float32 (centered)
    gradient_ref: np.ndarray                # (N, C, 3) float32
    k_ref: Dict[str, np.ndarray]            # n2_k, n2_eq, ..., n4_improper_k
    atom_ids: np.ndarray                    # (N,) original atom ids
    mol_id: str = ''
    ds_name: str = ''

    @property
    def n_atoms(self) -> int:
        return self.xyz.shape[0]

    @property
    def n_confs(self) -> int:
        return self.xyz.shape[1]

    @classmethod
    def from_moldata(cls, md: MolData, ds_name: str = '',
                     n_periodicity_proper: int =
                     constants.N_PERIODICITY_PROPER,
                     n_periodicity_improper: int =
                     constants.N_PERIODICITY_IMPROPER,
                     max_neighbors: int = constants.MAX_NEIGHBORS,
                     exclude_feats: Sequence[str] = ()) -> 'MolGraph':
        """Training-path construction: conformers, targets (each
        molecule's energy_ref centred again in float32) and the classical
        parameters in the signed-k convention."""
        mol = md.molecule
        neighbors, neighbor_mask = build_neighbor_list(
            mol.bonds_by_index(), len(mol.atoms), max_neighbors)
        energy_ref = np.asarray(md.energy_ref, dtype=np.float32)
        if len(energy_ref):
            energy_ref = energy_ref - energy_ref.mean()
        return cls(
            feats=mol.input_features(exclude=exclude_feats),
            neighbors=neighbors, neighbor_mask=neighbor_mask,
            tuple_idxs=mol.tuple_indices(),
            xyz=np.asarray(md.xyz, dtype=np.float32).transpose(1, 0, 2),
            energy_ref=energy_ref,
            gradient_ref=np.asarray(
                md.gradient_ref, dtype=np.float32).transpose(1, 0, 2),
            k_ref=md.classical_parameters.signed_k_dict(
                n_periodicity_proper, n_periodicity_improper),
            atom_ids=np.asarray(mol.atoms, dtype=np.int64),
            mol_id=md.mol_id, ds_name=ds_name,
        )

    @classmethod
    def from_molecule(cls, mol: Molecule, xyz: Optional[np.ndarray] = None,
                      max_neighbors: int = constants.MAX_NEIGHBORS,
                      exclude_feats: Sequence[str] = ()) -> 'MolGraph':
        """Inference-path construction: no targets, optional conformers
        (xyz in (n_confs, n_atoms, 3))."""
        n = len(mol.atoms)
        feats = mol.input_features(exclude=exclude_feats)
        neighbors, neighbor_mask = build_neighbor_list(
            mol.bonds_by_index(), n, max_neighbors)
        if xyz is None:
            xyz = np.zeros((1, n, 3), np.float32)
            xyz[0, :, 0] = np.arange(n, dtype=np.float32)
        c = xyz.shape[0]
        tuple_idxs = mol.tuple_indices()
        nan = lambda *shape: np.full(shape, np.nan, np.float32)
        return cls(
            feats=feats, neighbors=neighbors, neighbor_mask=neighbor_mask,
            tuple_idxs=tuple_idxs,
            xyz=np.asarray(xyz, np.float32).transpose(1, 0, 2),
            energy_ref=np.zeros(c, np.float32),
            gradient_ref=np.zeros((n, c, 3), np.float32),
            k_ref={
                'n2_k': nan(len(mol.bonds)), 'n2_eq': nan(len(mol.bonds)),
                'n3_k': nan(len(mol.angles)), 'n3_eq': nan(len(mol.angles)),
                'n4_k': nan(len(tuple_idxs['n4']),
                            constants.N_PERIODICITY_PROPER),
                'n4_improper_k': nan(len(tuple_idxs['n4_improper']),
                                     constants.N_PERIODICITY_IMPROPER),
            },
            atom_ids=np.asarray(mol.atoms, dtype=np.int64),
        )


def build_neighbor_list(bonds_idx: np.ndarray, n_atoms: int,
                        max_neighbors: int = constants.MAX_NEIGHBORS
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-width padded neighbor list from 0-based bond indices (sorted
    neighbor ids per atom), from the native library when available."""
    if len(np.asarray(bonds_idx).reshape(-1)):
        from grappa_tpu_torch import native
        result = native.neighbor_list(bonds_idx, n_atoms, max_neighbors)
        if result is not None:
            return result
    lists: List[List[int]] = [[] for _ in range(n_atoms)]
    for a, b in np.asarray(bonds_idx).reshape(-1, 2):
        lists[int(a)].append(int(b))
        lists[int(b)].append(int(a))
    deg = max((len(l) for l in lists), default=0)
    if deg > max_neighbors:
        raise ValueError(
            f"atom degree {deg} exceeds MAX_NEIGHBORS={max_neighbors}")
    neighbors = np.zeros((n_atoms, max_neighbors), np.int32)
    mask = np.zeros((n_atoms, max_neighbors), bool)
    for i, l in enumerate(lists):
        neighbors[i, :len(l)] = sorted(l)
        mask[i, :len(l)] = True
    return neighbors, mask


# ----------------------------------------------------------------------
# device-side batch
@dataclass
class TermBatch:
    idxs: torch.Tensor    # (T, arity) int64, batch-level node indices
    mask: torch.Tensor    # (T,) bool
    mol: torch.Tensor     # (T,) int32 segment ids (padded -> num_mols)
    k_ref: torch.Tensor   # (T,) or (T, n_per) float32 (NaN if unknown)
    eq_ref: Optional[torch.Tensor] = None  # (T,) for n2/n3


@dataclass
class GraphBatch:
    feats: Dict[str, torch.Tensor]
    node_mask: torch.Tensor        # (N,) bool
    node_mol: torch.Tensor         # (N,) int32
    neighbors: torch.Tensor        # (N, D) int64
    neighbor_mask: torch.Tensor    # (N, D) bool
    xyz: torch.Tensor              # (N, C, 3) float32
    conf_mask: torch.Tensor        # (M, C) bool
    energy_ref: torch.Tensor       # (M, C) float32
    gradient_ref: torch.Tensor     # (N, C, 3) float32
    terms: Dict[str, TermBatch]
    num_mols: int
    # an atom-sharded batch's `parallel.sp.AtomShard` (the node- and
    # tuple-indexed tensors then hold one rank's rows); None otherwise
    shard: Optional[object] = None

    def atoms_per_mol(self) -> torch.Tensor:
        """Real atoms of each molecule (M,) as float32."""
        out = self.node_mask.new_zeros(self.num_mols + 1,
                                       dtype=torch.float32)
        return out.index_add(0, self.node_mol.long(),
                             self.node_mask.to(torch.float32))[:self.num_mols]

    def _map(self, fn) -> 'GraphBatch':
        terms = {t: TermBatch(idxs=fn(b.idxs), mask=fn(b.mask), mol=fn(b.mol),
                              k_ref=fn(b.k_ref),
                              eq_ref=None if b.eq_ref is None
                              else fn(b.eq_ref))
                 for t, b in self.terms.items()}
        return GraphBatch(
            feats={k: fn(v) for k, v in self.feats.items()},
            node_mask=fn(self.node_mask), node_mol=fn(self.node_mol),
            neighbors=fn(self.neighbors),
            neighbor_mask=fn(self.neighbor_mask), xyz=fn(self.xyz),
            conf_mask=fn(self.conf_mask), energy_ref=fn(self.energy_ref),
            gradient_ref=fn(self.gradient_ref), terms=terms,
            num_mols=self.num_mols, shard=self.shard)

    def to(self, device, non_blocking: bool = False) -> 'GraphBatch':
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> 'GraphBatch':
        return self._map(lambda t: t.pin_memory())

    def shapes(self) -> tuple:
        """Every tensor's shape, in a fixed order."""
        shapes = []

        def record(t):
            shapes.append(tuple(t.shape))
            return t
        self._map(record)
        return tuple(shapes)


def stack_batches(batches: Sequence[GraphBatch]) -> GraphBatch:
    """Stack same-shape batches along a new leading axis: the batch cache
    of a data-parallel epoch (`parallel.dp`), slot i holding batches[i]
    (the JAX package's stack_batches, there a device axis)."""
    if len({b.num_mols for b in batches}) != 1 or len(
            {b.shapes() for b in batches}) != 1:
        raise ValueError("stack_batches needs batches of one padded shape "
                         "and molecule count (a loader with fixed_pad=True)")
    leaves = []
    for b in batches:
        mine = []
        b._map(lambda t: mine.append(t) or t)
        leaves.append(mine)
    stacked = iter([torch.stack(xs) for xs in zip(*leaves)])
    return batches[0]._map(lambda _: next(stacked))


def _round_up(x: int, mult: int, minimum: int) -> int:
    return max(minimum, ((x + mult - 1) // mult) * mult)


@dataclass
class PadSpec:
    """Target padded sizes for one batch."""
    n_nodes: int
    n_tuples: Dict[str, int]
    n_confs: int

    @classmethod
    def for_graphs(cls, graphs: Sequence[MolGraph], n_confs: int,
                   node_mult: int = 64, tuple_mult: int = 128) -> 'PadSpec':
        n_nodes = _round_up(sum(g.n_atoms for g in graphs), node_mult,
                            node_mult)
        n_tuples = {
            t: _round_up(sum(len(g.tuple_idxs[t]) for g in graphs),
                         tuple_mult, tuple_mult)
            for t in TERMS
        }
        return cls(n_nodes=n_nodes, n_tuples=n_tuples, n_confs=n_confs)


def conf_draw(g: MolGraph, n_confs: int,
              rng: Optional[np.random.Generator]) -> Optional[np.ndarray]:
    """The conformer columns collate keeps of a molecule: None (all) if it
    has at most n_confs, else a sorted draw without replacement from `rng`
    (the first n_confs without one). A loader that skips a batch draws
    this alone, so its RNG stays where collating would leave it."""
    c = g.n_confs
    if c <= n_confs:
        return None
    if rng is None:
        return np.arange(n_confs)
    return np.sort(rng.choice(c, size=n_confs, replace=False))


def _subsample_confs(g: MolGraph, n_confs: int,
                     rng: Optional[np.random.Generator]):
    """Pick conformer columns: subsample without replacement if too many,
    keep all (padding happens later) if fewer."""
    sel = conf_draw(g, n_confs, rng)
    if sel is None:
        return g.xyz, g.energy_ref, g.gradient_ref, g.n_confs
    return (g.xyz[:, sel], g.energy_ref[sel], g.gradient_ref[:, sel], n_confs)


def collate(graphs: Sequence[MolGraph], pad: Optional[PadSpec] = None,
            n_confs: Optional[int] = None,
            device: Optional[Union[str, torch.device]] = None,
            rng: Optional[np.random.Generator] = None) -> GraphBatch:
    """Concatenate molecules into one padded GraphBatch on `device` (CUDA
    unless the caller asks for another).

    Index offsets are applied to tuple indices and neighbor lists exactly like
    the reference's idx-offset batching (reference: src/grappa/utils/
    dgl_utils.py:11-60), but into preallocated padded buffers. A molecule
    with more conformers than `pad.n_confs` keeps the first ones, or a
    sorted draw without replacement from `rng` (the JAX package's draw).
    """
    if not graphs:
        raise ValueError("collate needs at least one graph")
    device = resolve_device(device)
    if n_confs is None:
        n_confs = max(g.n_confs for g in graphs)
    if pad is None:
        pad = PadSpec.for_graphs(graphs, n_confs)

    m = len(graphs)
    n_pad, c_pad = pad.n_nodes, pad.n_confs
    d = graphs[0].neighbors.shape[1]
    feature_names = list(graphs[0].feats.keys())

    feats = {}
    for name in feature_names:
        f0 = graphs[0].feats[name]
        shape = (n_pad,) if f0.ndim == 1 else (n_pad, f0.shape[1])
        feats[name] = np.zeros(shape, np.float32)

    node_mask = np.zeros(n_pad, bool)
    node_mol = np.full(n_pad, m, np.int32)
    neighbors = np.zeros((n_pad, d), np.int64)
    neighbor_mask = np.zeros((n_pad, d), bool)
    xyz = np.zeros((n_pad, c_pad, 3), np.float32)
    # padded nodes: distinct positions to keep all geometry non-degenerate
    xyz[:, :, 0] = np.arange(n_pad, dtype=np.float32)[:, None]
    conf_mask = np.zeros((m, c_pad), bool)
    energy_ref = np.zeros((m, c_pad), np.float32)
    gradient_ref = np.zeros((n_pad, c_pad, 3), np.float32)

    term_bufs = {}
    for t in TERMS:
        tp = pad.n_tuples[t]
        kr = graphs[0].k_ref[f'{t}_k']
        k_shape = (tp,) if kr.ndim == 1 else (tp, kr.shape[1])
        term_bufs[t] = {
            'idxs': np.zeros((tp, TERM_ARITY[t]), np.int64),
            'mask': np.zeros(tp, bool),
            'mol': np.full(tp, m, np.int32),
            'k_ref': np.full(k_shape, np.nan, np.float32),
            'eq_ref': (np.full(tp, np.nan, np.float32)
                       if t in ('n2', 'n3') else None),
            'fill': 0,
        }

    node_offset = 0
    for i, g in enumerate(graphs):
        n = g.n_atoms
        if node_offset + n > n_pad:
            raise ValueError(
                f"PadSpec too small: {node_offset + n} > {n_pad} nodes")
        sl = slice(node_offset, node_offset + n)
        for name in feature_names:
            feats[name][sl] = g.feats[name]
        node_mask[sl] = True
        node_mol[sl] = i
        neighbors[sl] = g.neighbors + node_offset
        neighbor_mask[sl] = g.neighbor_mask

        g_xyz, g_en, g_grad, c = _subsample_confs(g, c_pad, rng)
        xyz[sl, :c] = g_xyz
        # pad conformers by replicating the last valid one (masked out)
        if c < c_pad:
            xyz[sl, c:] = g_xyz[:, -1:]
        conf_mask[i, :c] = True
        energy_ref[i, :c] = g_en
        gradient_ref[sl, :c] = g_grad

        for t in TERMS:
            buf = term_bufs[t]
            idxs = g.tuple_idxs[t]
            nt = len(idxs)
            if nt == 0:
                continue
            f = buf['fill']
            if f + nt > pad.n_tuples[t]:
                raise ValueError(f"PadSpec too small for term {t}: "
                                 f"{f + nt} > {pad.n_tuples[t]}")
            buf['idxs'][f:f + nt] = idxs + node_offset
            buf['mask'][f:f + nt] = True
            buf['mol'][f:f + nt] = i
            buf['k_ref'][f:f + nt] = g.k_ref[f'{t}_k']
            if buf['eq_ref'] is not None:
                buf['eq_ref'][f:f + nt] = g.k_ref[f'{t}_eq']
            buf['fill'] = f + nt
        node_offset += n

    to = lambda a: torch.from_numpy(a).to(device)
    terms = {
        t: TermBatch(idxs=to(b['idxs']), mask=to(b['mask']),
                     mol=to(b['mol']), k_ref=to(b['k_ref']),
                     eq_ref=None if b['eq_ref'] is None else to(b['eq_ref']))
        for t, b in term_bufs.items()
    }
    return GraphBatch(
        feats={k: to(v) for k, v in feats.items()},
        node_mask=to(node_mask), node_mol=to(node_mol),
        neighbors=to(neighbors), neighbor_mask=to(neighbor_mask),
        xyz=to(xyz), conf_mask=to(conf_mask), energy_ref=to(energy_ref),
        gradient_ref=to(gradient_ref), terms=terms, num_mols=m,
    )
