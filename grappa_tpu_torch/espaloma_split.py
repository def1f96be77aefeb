"""Espaloma benchmark split reconstruction.

Counterpart of `grappa_tpu.espaloma_split` (the port's own copy; plain
Python, no device). The published benchmark trains with espaloma's
train/val/test partition of molecule smiles (reference: dataset_creation/
get_espaloma_split/save_split.py:1-52 builds {'train': [...], 'val':
[...], 'test': [...]} from shipped te_smiles.json / vl_smiles.json). This
utility rebuilds the same split json from a dataset plus those two files
(pass paths to the reference's shipped jsons or your own lists).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Union


def build_espaloma_split(all_mol_ids: Iterable[str],
                         te_smiles: Union[str, Path, List[str]],
                         vl_smiles: Union[str, Path, List[str]]
                         ) -> Dict[str, List[str]]:
    """train = all ids not in the given test/val lists (espaloma semantics)."""
    def load(x):
        if isinstance(x, (str, Path)):
            with open(x) as f:
                return json.load(f)
        return list(x)

    te = set(load(te_smiles))
    vl = set(load(vl_smiles))
    overlap = te & vl
    if overlap:
        raise ValueError(f"{len(overlap)} ids in both test and val lists")
    all_ids = list(dict.fromkeys(all_mol_ids))
    train = [i for i in all_ids if i not in te and i not in vl]
    return {
        'train': train,
        'val': [i for i in all_ids if i in vl],
        'test': [i for i in all_ids if i in te],
    }


def save_espaloma_split(split: Dict[str, List[str]],
                        path: Union[str, Path] = 'espaloma_split.json'):
    with open(path, 'w') as f:
        json.dump(split, f, indent=1)
