"""Atom-sharded (sequence-parallel analog) path for macromolecules.

Counterpart of `grappa_tpu.parallel.sp`: the node and tuple axes of one
large molecule's GraphBatch are split over the ranks of a mesh, so a
molecule past one card's memory still predicts, trains and runs MD. Where
GSPMD places the collectives for the JAX package, here they are placed by
hand (`dp.all_gather_rows` / `dp.all_reduce_sum`, differentiable):

  * before each neighbour gather of the GNN (`models.gnn`): the node rows
    are all-gathered, and K1 / K1b (or the eager block) run on the rank's
    rows with the gathered neighbours;
  * before the writers gather atom embeddings by tuple indices: the GNN's
    output rows are all-gathered once, and K2 / K2b, K3 / K3b run on the
    rank's tuples;
  * in the MM energy (`mm_energy.sharded_energy_and_gradient`): the rank's
    tuple energies on all-gathered positions, the per-molecule sums
    all-reduced; dE/dx of the rank's tuples all-reduced and the rank's rows
    taken;
  * in the loss (`train.loss`): every per-molecule sum over nodes or
    tuples all-reduced; the parameter gradients all-reduced (and divided by
    the world size: every rank seeds its replicated loss with 1) before
    AdamClip;
  * with a bf16 compute dtype, in the backward: a bf16 Dense on the rank's
    rows sums its weight and bias gradients over the ranks in float32 and
    rounds them once (`layers.shard_dense`), and each writer's projection
    of the gathered rows takes the ranks' whole output gradient before its
    bf16 backward (`AtomShard.whole_grad`), so the bf16 roundings are the
    unsharded step's.

Every dropout mask on a sharded axis draws the bits of the unsharded
tensor's elements (`ops.philox`, K1 / K2's row offset), and every rank
draws the same seeds, so a sharded run equals the unsharded one.

Usage (every rank):
    mesh = make_mesh()
    pad = atom_sharded_pad_spec([graph], n_confs, mesh)
    batch = collate([graph], pad=pad, device=mesh.device)
    fwd = make_atom_sharded_forward(model, mesh)
    energy, gradient = fwd(shard_batch_by_atoms(batch, mesh))
energy is the whole molecules' on every rank, gradient the rank's rows.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from grappa_tpu_torch.data.graph_batch import (GraphBatch, MolGraph, PadSpec,
                                               TERMS, TermBatch, _round_up)
from grappa_tpu_torch.models import mm_energy
from grappa_tpu_torch.parallel.dp import (Mesh, all_gather_rows,
                                          all_reduce_sum, mean_over_ranks,
                                          whole_grad)
from grappa_tpu_torch.train.loss import LossWeights


class AtomShard:
    """A rank's place in an atom-sharded batch, which the model, the MM
    energy, the loss and MD read from `batch.shard`: the mesh, the global
    node count and, for the rank's rows, (first, total) of the nodes and of
    each term's tuples."""

    def __init__(self, mesh: Mesh, n_nodes: int, n_tuples: Dict[str, int]):
        self.mesh, self.n_nodes = mesh, int(n_nodes)
        w, r = mesh.size, mesh.rank
        self.node_rows: Tuple[int, int] = (r * (self.n_nodes // w),
                                           self.n_nodes)
        self.tuple_rows: Dict[str, Tuple[int, int]] = {
            t: (r * (int(n) // w), int(n)) for t, n in n_tuples.items()}

    def gather_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """All the nodes' rows of a node-indexed tensor (differentiable)."""
        return all_gather_rows(x, self.mesh)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' sum (differentiable)."""
        return all_reduce_sum(x, self.mesh)

    def whole_grad(self, x: torch.Tensor) -> torch.Tensor:
        """x, a tensor every rank computes whole, with the whole tensor's
        gradient on every rank (`dp.whole_grad`)."""
        return whole_grad(x, self.mesh)

    def local_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a whole node-indexed tensor."""
        first = self.node_rows[0]
        return x[first:first + self.n_nodes // self.mesh.size]


def atom_sharded_pad_spec(graphs: Sequence[MolGraph], n_confs: int,
                          mesh: Mesh) -> PadSpec:
    """PadSpec whose node and tuple counts are multiples of the mesh size."""
    w = mesh.size
    base = PadSpec.for_graphs(graphs, n_confs)
    return PadSpec(
        n_nodes=_round_up(base.n_nodes, w, w),
        n_tuples={t: _round_up(base.n_tuples[t], w, w) for t in TERMS},
        n_confs=n_confs)


def shard_batch_by_atoms(batch: GraphBatch, mesh: Mesh) -> GraphBatch:
    """The rank's part of a whole batch: rows [r N / W, (r + 1) N / W) of
    every node-indexed tensor and the same slice of every tuple-indexed
    one (their indices stay global), the molecule-level tensors whole,
    and `shard` set. Raises when an axis does not divide by the mesh
    size."""
    w = mesh.size
    n = batch.node_mask.shape[0]
    if n % w != 0:
        raise ValueError(
            f"node axis ({n}) must be divisible by the mesh size ({w}); use "
            f"atom_sharded_pad_spec")
    for t in TERMS:
        nt = batch.terms[t].idxs.shape[0]
        if nt % w != 0:
            raise ValueError(
                f"tuple axis of {t} ({nt}) must be divisible by the mesh "
                f"size ({w}); use atom_sharded_pad_spec")
    shard = AtomShard(mesh, n, {t: b.idxs.shape[0]
                                for t, b in batch.terms.items()})
    node = shard.local_nodes

    def rows(t, x):
        first, total = shard.tuple_rows[t]
        return x[first:first + total // w]

    terms = {t: TermBatch(idxs=rows(t, b.idxs), mask=rows(t, b.mask),
                          mol=rows(t, b.mol), k_ref=rows(t, b.k_ref),
                          eq_ref=None if b.eq_ref is None
                          else rows(t, b.eq_ref))
             for t, b in batch.terms.items()}
    return GraphBatch(
        feats={k: node(v) for k, v in batch.feats.items()},
        node_mask=node(batch.node_mask), node_mol=node(batch.node_mol),
        neighbors=node(batch.neighbors),
        neighbor_mask=node(batch.neighbor_mask), xyz=node(batch.xyz),
        conf_mask=batch.conf_mask, energy_ref=batch.energy_ref,
        gradient_ref=node(batch.gradient_ref), terms=terms,
        num_mols=batch.num_mols, shard=shard)


def _check_sharded(batch: GraphBatch, mesh: Mesh) -> None:
    if batch.shard is None or batch.shard.mesh != mesh:
        raise ValueError("the batch is not sharded over this mesh: pass "
                         "shard_batch_by_atoms(batch, mesh)")


def make_atom_sharded_forward(model: torch.nn.Module, mesh: Mesh
                              ) -> Callable:
    """fwd(sharded_batch) -> (energy (M, C), the rank's rows of dE/dx):
    the model's prediction in eval mode, then the MM energy and its
    gradient, on every rank of the mesh."""

    def fwd(batch: GraphBatch):
        _check_sharded(batch, mesh)
        model.eval()
        with torch.no_grad():
            pred = model(batch)
        return mm_energy.energy_and_gradient(batch, pred)

    return fwd


def make_atom_sharded_train_step(model: torch.nn.Module, optimizer,
                                 mesh: Mesh) -> Callable:
    """One training step (the loss through dE/dx) on an atom-sharded
    batch: step(sharded_batch, weights, lr, generator) -> (loss, aux), the
    loss and aux the whole batch's on every rank. Every rank passes the
    same weights and a generator in the same state (the dropout seeds are
    the same on every rank; the masks are the unsharded ones). The
    parameter gradients are all-reduced in one flat buffer and divided by
    the world size, so AdamClip updates every rank's parameters alike."""
    from grappa_tpu_torch.train.trainer import loss_gradients
    params = dict(model.named_parameters())

    def step(batch: GraphBatch, weights: LossWeights, lr,
             generator: torch.Generator):
        _check_sharded(batch, mesh)
        loss, aux, grads = loss_gradients(model, batch, weights, generator)
        optimizer.step(params, mean_over_ranks(list(grads.values()), mesh),
                       lr)
        return loss, aux

    return step
