"""Batch loader: weighted sampling + conformer strategy + bucketed padding.

Counterpart of `grappa_tpu.data.loader` (reference: src/grappa/data/
GraphDataLoader.py:12-148): per-subdataset sampling weights with a
balance_factor interpolation toward equal-dataset sampling, and a per-batch
conformer count strategy. Padded sizes are rounded up a geometric ladder, so
the set of padded shapes stays small while padding waste stays bounded
(~25%). The sampling and conformer draws come from one numpy generator in
the JAX package's order, so the same seed gives the same batches.

Batches are collated on the host by a producer thread, one batch ahead, and
reach the loader's device on the consumer's thread: the thread that iterates
the loader (the Trainer) issues the copy, from pinned memory when the device
is a card, so it is queued behind the work already on the device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np

from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.data.graph_batch import (
    GraphBatch, MolGraph, PadSpec, TERMS, collate)
from grappa_tpu_torch.utils import resolve_device


def bucket_size(x: int, base: int, ratio: float = 1.25) -> int:
    """Smallest ladder value >= x; ladder = base, then *ratio rounded to 8.
    Always advances by at least 8 per rung so ratio <= 1.0 cannot hang."""
    s = base
    while s < x:
        s = max(int(np.ceil(s * ratio / 8) * 8), s + 8)
    return s


def bucketed_pad_spec(graphs: Sequence[MolGraph], n_confs: int,
                      node_base: int = 64, tuple_base: int = 64,
                      ratio: float = 1.25) -> PadSpec:
    n_nodes = bucket_size(sum(g.n_atoms for g in graphs), node_base, ratio)
    n_tuples = {
        t: bucket_size(max(1, sum(len(g.tuple_idxs[t]) for g in graphs)),
                       tuple_base, ratio)
        for t in TERMS
    }
    return PadSpec(n_nodes=n_nodes, n_tuples=n_tuples, n_confs=n_confs)


class GraphLoader:
    """Iterable over (GraphBatch, ds_names) with epoch-level shuffling."""

    def __init__(self, dataset: Dataset, batch_size: int = 32,
                 conf_strategy: Union[str, int] = 32,
                 shuffle: bool = True,
                 weights: Optional[Dict[str, float]] = None,
                 balance_factor: float = 0.0,
                 seed: int = 0,
                 drop_last: bool = False,
                 conf_bucket_base: int = 8,
                 pad_ratio: float = 1.25,
                 fixed_pad: bool = None,
                 device=None):
        """fixed_pad: use ONE PadSpec (worst case over the dataset) for every
        batch. Default for shuffled (training) loaders, whose random draws
        would otherwise give many padded-shape combinations; sequential
        loaders default to per-batch buckets (less padding).

        device: where the batches go (CUDA unless the caller asks for
        another)."""
        assert 0.0 <= balance_factor <= 1.0
        if pad_ratio < 1.0:
            raise ValueError(f"pad_ratio must be >= 1.0, got {pad_ratio}")
        if (weights or balance_factor > 0.0) and not shuffle:
            # weighted/balanced draws sample WITH replacement, which means
            # nothing for a sequential loader (the reference only balances
            # shuffled training loaders, GraphDataLoader.py:101)
            raise ValueError(
                "sampling weights / balance_factor require shuffle=True")
        self.dataset = dataset
        self.batch_size = batch_size
        self.conf_strategy = conf_strategy
        self.shuffle = shuffle
        self.weights = dict(weights or {})
        self.balance_factor = balance_factor
        self.drop_last = drop_last
        self.conf_bucket_base = conf_bucket_base
        self.pad_ratio = pad_ratio
        self.fixed_pad = shuffle if fixed_pad is None else fixed_pad
        self.device = resolve_device(device)
        self._fixed_spec: Optional[PadSpec] = None
        self._fixed_confs: Optional[int] = None
        self._rng = np.random.default_rng(seed)
        self._sample_weights = self._compute_sample_weights()

    def _fixed_pad_spec(self, n_confs: int) -> PadSpec:
        """Worst-case batch PadSpec, bucket-rounded (computed once per
        loader). Uniform sampling: the batch_size largest DISTINCT
        molecules per axis. Weighted/balanced sampling draws WITH
        replacement, so a batch can hold the largest molecule several
        times: the worst case is then batch_size copies of the largest."""
        if self._fixed_spec is None or self._fixed_spec.n_confs != n_confs:
            graphs = [self.dataset.graph(i) for i in range(len(self.dataset))]
            bs = min(self.batch_size, max(1, len(graphs)))
            with_replacement = self._sample_weights is not None
            if with_replacement:
                atoms = [max(g.n_atoms for g in graphs)] * bs
            else:
                atoms = sorted((g.n_atoms for g in graphs), reverse=True)[:bs]
            n_nodes = bucket_size(sum(atoms), 64, self.pad_ratio)
            n_tuples = {}
            for t in TERMS:
                if with_replacement:
                    counts = [max(len(g.tuple_idxs[t]) for g in graphs)] * bs
                else:
                    counts = sorted((len(g.tuple_idxs[t]) for g in graphs),
                                    reverse=True)[:bs]
                n_tuples[t] = bucket_size(max(1, sum(counts)), 64,
                                          self.pad_ratio)
            self._fixed_spec = PadSpec(n_nodes=n_nodes, n_tuples=n_tuples,
                                       n_confs=n_confs)
        return self._fixed_spec

    def _compute_sample_weights(self) -> Optional[np.ndarray]:
        if not self.weights and self.balance_factor == 0.0:
            return None
        names = self.dataset.ds_names
        w = np.array([self.weights.get(n, 1.0) for n in names], float)
        if self.balance_factor > 0:
            counts = {n: names.count(n) for n in set(names)}
            ratios = {n: c / len(names) for n, c in counts.items()}
            balanced = 1.0 / len(ratios)
            used = {n: (1 - self.balance_factor) * balanced
                    + self.balance_factor * ratios[n] for n in ratios}
            w = w * np.array([1.0 / used[n] for n in names])
        return w / w.sum()

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        if self._sample_weights is not None:
            return self._rng.choice(n, size=n, replace=True,
                                    p=self._sample_weights)
        if self.shuffle:
            return self._rng.permutation(n)
        return np.arange(n)

    def _fixed_conf_count(self) -> int:
        """Dataset-wide conformer count for fixed-pad mode (one value for
        every batch of this loader, cached: the scan is O(n) host time)."""
        if self._fixed_confs is None:
            max_confs = max((self.dataset.graph(i).n_confs
                             for i in range(len(self.dataset))), default=1)
            s = self.conf_strategy
            n = min(s, max_confs) if isinstance(s, int) else max_confs
            self._fixed_confs = bucket_size(max(1, n), self.conf_bucket_base,
                                            self.pad_ratio)
        return self._fixed_confs

    def _batch_conf_count(self, graphs: Sequence[MolGraph]) -> int:
        confs = [g.n_confs for g in graphs]
        s = self.conf_strategy
        if isinstance(s, int):
            n = min(s, max(confs))
        elif s == 'min':
            n = min(confs)
        elif s in ('max', 'all'):
            n = max(confs)
        elif s == 'mean':
            n = int(np.mean(confs))
        else:
            raise ValueError(f"unknown conf_strategy: {s}")
        return bucket_size(max(1, n), self.conf_bucket_base, self.pad_ratio)

    def _make_batch(self, idxs) -> Tuple[GraphBatch, Tuple[str, ...]]:
        """One batch collated on the host (pinned when bound for a card)."""
        graphs = [self.dataset.graph(int(i)) for i in idxs]
        names = tuple(self.dataset.ds_names[int(i)] for i in idxs)
        if self.fixed_pad:
            n_confs = self._fixed_conf_count()
            pad = self._fixed_pad_spec(n_confs)
        else:
            n_confs = self._batch_conf_count(graphs)
            pad = bucketed_pad_spec(graphs, n_confs, ratio=self.pad_ratio)
        batch = collate(graphs, pad=pad, n_confs=n_confs, device='cpu',
                        rng=self._rng)
        if self.device.type == 'cuda':
            batch = batch.pin_memory()
        return batch, names

    def __iter__(self) -> Iterator[Tuple[GraphBatch, Tuple[str, ...]]]:
        """Iterate with one-batch-ahead host prefetch: collation (numpy
        copies) overlaps the device step."""
        order = self._epoch_order()
        bs = self.batch_size
        n_batches = len(order) // bs if self.drop_last else len(self)
        chunks = [order[b * bs:(b + 1) * bs] for b in range(n_batches)
                  if len(order[b * bs:(b + 1) * bs])]
        if not chunks:
            return

        q: 'queue.Queue' = queue.Queue(maxsize=2)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone: an
            abandoned epoch iterator must not leave a thread blocked on a
            full queue, holding batches and racing the next epoch's
            producer on the shared RNG."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idxs in chunks:
                    if stop.is_set() or not put(self._make_batch(idxs)):
                        return
            except BaseException as exc:   # surfaced to the consumer
                put(exc)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, daemon=True,
                                  name='grappa-loader')
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                batch, names = item
                yield batch.to(self.device, non_blocking=True), names
        finally:
            # normal end, consumer break, or GeneratorExit: release the
            # producer and wait for it so the next epoch starts clean
            stop.set()
            thread.join(timeout=10.0)
