"""Dataset container: a list of molecules with conformer data, organized by
sub-dataset names, with molecule-identity-aware splitting.

Counterpart of `grappa_tpu.data.dataset`, with the same on-disk layout, so
a directory saved by either package loads in the other. Mirrors the
reference Dataset semantics (reference: src/grappa/data/
Dataset.py:16-296 and src/grappa/utils/torch_utils.py:12-352): entries carry
(molecule, subdataset name); splits partition *molecule ids* so the same
molecule appearing in several subdatasets lands in exactly one split; save/
load is a directory of npz entries + a json manifest.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from grappa_tpu_torch.data.graph_batch import MolGraph
from grappa_tpu_torch.data.moldata import MolData


class Dataset:
    """List of (MolData, subdataset_name) with cached MolGraphs."""

    def __init__(self, entries: Sequence[MolData],
                 ds_names: Sequence[str]):
        assert len(entries) == len(ds_names)
        self.entries: List[MolData] = list(entries)
        self.ds_names: List[str] = [str(n) for n in ds_names]
        self._graphs: List[Optional[MolGraph]] = [None] * len(self.entries)

    # ------------------------------------------------------------------
    @classmethod
    def from_moldata(cls, entries: Sequence[MolData],
                     ds_name: str = 'dataset') -> 'Dataset':
        return cls(entries, [ds_name] * len(entries))

    @classmethod
    def from_tag(cls, tag: str) -> 'Dataset':
        """Load a dataset by zoo tag or filesystem path (offline-first:
        the tag must resolve to a local directory, see zoo)."""
        from grappa_tpu_torch.zoo import dataset_path_from_tag
        path = dataset_path_from_tag(tag)
        ds = cls.load(path)
        if ds.ds_names and all(n in ('dataset', '') for n in ds.ds_names):
            ds.ds_names = [Path(str(tag)).name] * len(ds)
        return ds

    def __len__(self):
        return len(self.entries)

    def __add__(self, other: 'Dataset') -> 'Dataset':
        return Dataset(self.entries + other.entries,
                       self.ds_names + other.ds_names)

    def __getitem__(self, i: int) -> Tuple[MolData, str]:
        return self.entries[i], self.ds_names[i]

    @property
    def mol_ids(self) -> List[str]:
        return [e.mol_id for e in self.entries]

    def graph(self, i: int) -> MolGraph:
        if self._graphs[i] is None:
            self._graphs[i] = MolGraph.from_moldata(
                self.entries[i], ds_name=self.ds_names[i])
        return self._graphs[i]

    def graphs(self) -> List[MolGraph]:
        return [self.graph(i) for i in range(len(self))]

    def subsampled(self, factor: float, seed: int = 0) -> 'Dataset':
        """Keep a random `factor` fraction of entries."""
        if factor is None or factor >= 1.0:
            return self
        rng = np.random.default_rng(seed)
        keep = rng.permutation(len(self))[:max(1, int(len(self) * factor))]
        return Dataset([self.entries[i] for i in keep],
                       [self.ds_names[i] for i in keep])

    def where(self, ds_name: str) -> 'Dataset':
        keep = [i for i, n in enumerate(self.ds_names) if n == ds_name]
        return Dataset([self.entries[i] for i in keep],
                       [self.ds_names[i] for i in keep])

    def shuffled(self, seed: int = 0) -> 'Dataset':
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self))
        return Dataset([self.entries[i] for i in order],
                       [self.ds_names[i] for i in order])

    def remove_uncommon_features(self) -> 'Dataset':
        """Strip per-atom features that are not present in every molecule so
        all entries are batchable together.

        Entries are shared by reference across views (split/where/shuffled/
        concat), so the molecules are NOT mutated in place — affected
        entries get a shallow copy with their own feature dict, leaving
        sibling views (and their graph caches) consistent."""
        import copy as _copy

        common = None
        for e in self.entries:
            keys = set(e.molecule.additional_features.keys())
            common = keys if common is None else common & keys
        for i, e in enumerate(self.entries):
            extra = [k for k in e.molecule.additional_features
                     if k not in common]
            if not extra:
                continue
            entry = _copy.copy(e)
            entry.molecule = _copy.copy(e.molecule)
            entry.molecule.additional_features = {
                k: v for k, v in e.molecule.additional_features.items()
                if k in common}
            self.entries[i] = entry
            self._graphs[i] = None   # only modified entries' caches reset
        return self

    # ------------------------------------------------------------------
    def split(self, train_ids: Sequence[str], val_ids: Sequence[str],
              test_ids: Sequence[str],
              check_disjoint: bool = True
              ) -> Tuple['Dataset', 'Dataset', 'Dataset']:
        train_ids, val_ids, test_ids = set(train_ids), set(val_ids), set(test_ids)
        if check_disjoint:
            assert not (train_ids & val_ids), "train/val leak"
            assert not (train_ids & test_ids), "train/test leak"
            assert not (val_ids & test_ids), "val/test leak"
        out = {'train': ([], []), 'val': ([], []), 'test': ([], [])}
        for e, n in zip(self.entries, self.ds_names):
            if e.mol_id in train_ids:
                key = 'train'
            elif e.mol_id in val_ids:
                key = 'val'
            elif e.mol_id in test_ids:
                key = 'test'
            else:
                continue
            out[key][0].append(e)
            out[key][1].append(n)
        return (Dataset(*out['train']), Dataset(*out['val']),
                Dataset(*out['test']))

    # ------------------------------------------------------------------
    def save(self, path: Union[str, Path]):
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        manifest = []
        for i, (e, name) in enumerate(zip(self.entries, self.ds_names)):
            fname = f'mol_{i:06d}.npz'
            e.save(path / fname)
            manifest.append({'file': fname, 'ds_name': name,
                             'mol_id': e.mol_id})
        with open(path / 'manifest.json', 'w') as f:
            json.dump({'version': 1, 'entries': manifest}, f, indent=1)

    @classmethod
    def load(cls, path: Union[str, Path]) -> 'Dataset':
        path = Path(path)
        if not (path / 'manifest.json').exists():
            # flat directory of per-molecule npz files (the published
            # MolData layout and the dataset_creation tool output)
            files = sorted(path.glob('*.npz'))
            if not files:
                raise FileNotFoundError(
                    f'{path}: neither manifest.json nor *.npz files')
            entries = [MolData.load(f) for f in files]
            return cls(entries, [path.name] * len(entries))
        with open(path / 'manifest.json') as f:
            manifest = json.load(f)
        entries, names = [], []
        for item in manifest['entries']:
            entries.append(MolData.load(path / item['file']))
            names.append(item['ds_name'])
        return cls(entries, names)


# ----------------------------------------------------------------------
def calc_split_ids(mol_ids_by_ds: Dict[str, Sequence[str]],
                   partition: Union[Sequence[float],
                                    Dict[str, Sequence[float]]] = (0.8, 0.1, 0.1),
                   seed: int = 0,
                   existing_split: Optional[Dict[str, List[str]]] = None
                   ) -> Dict[str, List[str]]:
    """Assign molecule ids to train/val/test per subdataset.

    Duplicate mol_ids (the same molecule in several subdatasets) receive one
    consistent assignment. `partition` is either one (tr, vl, te) triple or a
    dict dsname->triple (with a 'default'). An `existing_split` is extended:
    ids already assigned keep their assignment.
    """
    assignment: Dict[str, str] = {}
    if existing_split:
        for key in ('train', 'val', 'test'):
            for mid in existing_split.get(key, []):
                assignment[mid] = key

    rng = np.random.default_rng(seed)
    for ds_name in sorted(mol_ids_by_ds.keys()):
        ids = [i for i in dict.fromkeys(mol_ids_by_ds[ds_name])
               if i not in assignment]
        if isinstance(partition, dict):
            frac = partition.get(ds_name, partition.get('default', (0.8, 0.1, 0.1)))
        else:
            frac = partition
        assert abs(sum(frac) - 1.0) < 1e-6, f"partition must sum to 1: {frac}"
        order = rng.permutation(len(ids))
        n_tr = int(round(frac[0] * len(ids)))
        n_vl = int(round(frac[1] * len(ids)))
        if frac[2] == 0.0:
            n_vl = len(ids) - n_tr
        for j, idx in enumerate(order):
            key = ('train' if j < n_tr else
                   'val' if j < n_tr + n_vl else 'test')
            assignment[ids[idx]] = key

    split = {'train': [], 'val': [], 'test': []}
    for mid, key in assignment.items():
        split[key].append(mid)

    # invariants: disjoint + complete
    all_ids = {i for ids in mol_ids_by_ds.values() for i in ids}
    assigned = set(split['train']) | set(split['val']) | set(split['test'])
    assert all_ids <= assigned, "some molecule ids were not assigned"
    assert (len(split['train']) + len(split['val']) + len(split['test'])
            == len(assigned)), "split overlap detected"
    return split


def save_split(split: Dict[str, List[str]], path: Union[str, Path]):
    with open(path, 'w') as f:
        json.dump(split, f, indent=1)


def load_split(path: Union[str, Path]) -> Dict[str, List[str]]:
    with open(path) as f:
        return json.load(f)


def k_fold_split_ids(mol_ids: Union[Sequence[str], Dict[str, Sequence[str]]],
                     k: int, seed: int = 0) -> List[Dict[str, List[str]]]:
    """k folds: each fold is test once, val is the next fold, rest train.

    Pass a dict dsname->ids (like calc_split_ids) for per-subdataset
    stratification; a mol_id occurring in several subdatasets is assigned to
    exactly ONE fold (the reference's duplicate-consistent k-fold,
    torch_utils.py:12-352), so overlapping subdatasets cannot leak a
    molecule across the train/test boundary of any fold."""
    rng = np.random.default_rng(seed)
    folds: List[List[str]] = [[] for _ in range(k)]
    if isinstance(mol_ids, dict):
        assigned: set = set()
        for ds_name in sorted(mol_ids.keys()):
            ids = [i for i in dict.fromkeys(mol_ids[ds_name])
                   if i not in assigned]
            assigned.update(ids)
            order = rng.permutation(len(ids))
            offset = int(rng.integers(k))
            for j, idx in enumerate(order):
                folds[(j + offset) % k].append(ids[idx])
    else:
        ids = list(dict.fromkeys(mol_ids))
        order = rng.permutation(len(ids))
        folds = [[ids[i] for i in order[j::k]] for j in range(k)]
    splits = []
    for j in range(k):
        test = folds[j]
        val = folds[(j + 1) % k]
        train = [i for f in range(k) if f not in (j, (j + 1) % k)
                 for i in folds[f]]
        splits.append({'train': train, 'val': val, 'test': test})
    return splits
