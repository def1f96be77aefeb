"""Espaloma benchmark-archive -> dataset conversion pipeline.

Counterpart of `grappa_tpu.data.espaloma_pipeline` on the port's mapped
SMILES parser, topology, MolData and Dataset (plain numpy, no device):
`python -m grappa_tpu_torch.data.espaloma_pipeline {to-moldata,unmerge,
to-dataset} ...`. Mirrors the reference's dataset_creation/
benchmark_datasets converters (reference: to_grappa.py:1-87, to_dgl.py:1-66, unmerge_duplicates.py:1-81,
README.md:1-17) without requiring openff/rdkit/dgl:

  record npz (espaloma archive layout: xyz, energy_qm, gradient_qm,
  energy_ref/gradient_ref, am1bcc_elf_charges, atomic_numbers,
  mapped_smiles, smiles, energy_<ff>/gradient_<ff>)
    --convert_espaloma_dir-->  MolData npz dir
    --assemble_dataset_dir-->  Dataset dir (manifest.json + mol npzs)

plus `unmerge_duplicates`, which copies the molecules espaloma merged
across datasets back into each source dataset (our split logic keys on
mol_id, so duplicates are handled consistently; reference README.md:9-11).

Connectivity comes from the mapped SMILES via the first-party parser
(grappa_tpu_torch.data.smiles) instead of openff. Deviations from the
reference converter, both documented here:
  * classical parameters are NaN unless openff is installed (the reference
    computes them with openff_unconstrained-2.0.0; our loss/statistics are
    NaN-aware, reference to_grappa.py allow_nan_params=True does the same
    when openff fails), and
  * impropers are detected at every atom with exactly three neighbors (a
    superset of the force field's sp2-center impropers; the gated torsion
    head predicts ~0 for spurious ones). With openff installed the exact
    reference behavior is available through wrappers.openff_utils.
"""
from __future__ import annotations

import argparse
import shutil
import traceback
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from grappa_tpu_torch import topology
from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.data.moldata import MolData
from grappa_tpu_torch.data.molecule import Molecule
from grappa_tpu_torch.data.smiles import parse_mapped_smiles


def molecule_from_mapped_smiles(
        mapped_smiles: str,
        partial_charges: np.ndarray,
        charge_model: str = 'am1BCC',
        atomic_numbers: Optional[np.ndarray] = None) -> Molecule:
    """Molecule (atoms, bonds, tuples, features) from a mapped SMILES.

    Impropers: every atom bonded to exactly three others becomes an improper
    center (canonicalized into the 3-cyclic-versions convention)."""
    z, bonds, _ = parse_mapped_smiles(mapped_smiles)
    if atomic_numbers is not None:
        if not np.array_equal(np.asarray(atomic_numbers, np.int64), z):
            raise ValueError(
                'parsed atomic numbers disagree with the record; '
                'mapped smiles and arrays are inconsistent')
    nbrs = topology.neighbor_map(bonds)
    improper_sets = []
    for center, nb in nbrs.items():
        if len(nb) == 3:
            improper_sets.append((nb[0], nb[1], center, nb[2]))
    return Molecule(
        atoms=np.arange(len(z)),
        bonds=bonds,
        impropers=np.asarray(improper_sets, np.int64).reshape(-1, 4),
        atomic_numbers=z,
        partial_charges=np.asarray(partial_charges, np.float32),
        charge_model=charge_model,
    )


def moldata_from_espaloma_record(
        record: Dict[str, np.ndarray],
        partial_charge_key: str = 'am1bcc_elf_charges',
        charge_model: str = 'am1BCC') -> MolData:
    """Espaloma-archive record dict -> MolData (reference
    MolData.from_data_dict semantics, MolData.py:356-417, minus the openff
    classical-parameter step — parameters stay NaN)."""
    def as_str(key):
        v = record.get(key)
        if v is None:
            return None
        return str(v.reshape(-1)[0]) if isinstance(v, np.ndarray) else str(v)

    mapped_smiles = as_str('mapped_smiles')
    if mapped_smiles is None:
        raise ValueError('record has no mapped_smiles')
    smiles = as_str('smiles')
    mol_id = as_str('mol_id') or smiles
    if mol_id is None:
        raise ValueError('record has neither mol_id nor smiles')

    xyz = np.asarray(record['xyz'], np.float32)
    energy = np.asarray(record['energy_qm'], np.float32)
    gradient = np.asarray(record['gradient_qm'], np.float32)
    energy_ref = np.asarray(record['energy_ref'], np.float32)
    energy_ref = energy_ref - energy_ref.mean()
    gradient_ref = np.asarray(record['gradient_ref'], np.float32)

    molecule = molecule_from_mapped_smiles(
        mapped_smiles, record[partial_charge_key], charge_model,
        atomic_numbers=record.get('atomic_numbers'))

    ff_energy = {k[len('energy_'):]: np.asarray(v, np.float32)
                 for k, v in record.items()
                 if k.startswith('energy_') and k != 'energy_ref'}
    ff_gradient = {k[len('gradient_'):]: np.asarray(v, np.float32)
                   for k, v in record.items()
                   if k.startswith('gradient_') and k != 'gradient_ref'}

    return MolData(
        molecule=molecule, xyz=xyz, energy=energy, gradient=gradient,
        energy_ref=energy_ref, gradient_ref=gradient_ref, mol_id=mol_id,
        smiles=smiles, mapped_smiles=mapped_smiles,
        ff_energy=ff_energy, ff_gradient=ff_gradient,
    )


def convert_espaloma_dir(source_path: Union[str, Path],
                         target_path: Union[str, Path],
                         partial_charge_key: str = 'am1bcc_elf_charges',
                         charge_model: str = 'am1BCC') -> Dict[str, int]:
    """Archive-record npz dir -> MolData npz dir (reference to_grappa.py)."""
    source_path, target_path = Path(source_path), Path(target_path)
    target_path.mkdir(exist_ok=True, parents=True)
    stats = {'total': 0, 'success': 0, 'errors': 0, 'confs': 0}
    for molfile in sorted(source_path.iterdir()):
        if molfile.is_dir() or molfile.suffix != '.npz':
            continue
        stats['total'] += 1
        try:
            with np.load(molfile, allow_pickle=False) as data:
                record = dict(data)
            md = moldata_from_espaloma_record(record, partial_charge_key,
                                              charge_model)
            md.save(target_path / molfile.name)
            stats['success'] += 1
            stats['confs'] += int(md.n_confs)
        except Exception as exc:
            stats['errors'] += 1
            print(f"error processing {molfile}: {exc}\n"
                  f"{traceback.format_exc()}")
    return stats


def unmerge_duplicates(duplicates_path: Union[str, Path],
                       target_path: Union[str, Path]) -> Dict[str, int]:
    """Copy espaloma's merged-out duplicate molecules back into their source
    datasets (reference unmerge_duplicates.py). Layout:
    duplicates_path/{n}/{ds_name}/<one molecule entry (file or dir)>;
    each entry lands in target_path/{ds_name}/ unless already present."""
    duplicates_path, target_path = Path(duplicates_path), Path(target_path)
    ds_names = {p.name for p in target_path.iterdir() if p.is_dir()}
    stats = {'copied': 0, 'already_there': 0}
    for subdir in sorted(duplicates_path.iterdir()):
        if not subdir.is_dir():
            continue
        for ds_dir in sorted(subdir.iterdir()):
            if not ds_dir.is_dir():
                continue
            if ds_dir.name not in ds_names:
                raise ValueError(
                    f"dataset {ds_dir.name} not found in {target_path}")
            entries = list(ds_dir.iterdir())
            if len(entries) != 1:
                raise ValueError(
                    f"{ds_dir} must hold exactly one molecule entry, "
                    f"found {len(entries)}")
            src = entries[0]
            dst = target_path / ds_dir.name / src.name
            if dst.exists():
                stats['already_there'] += 1
            elif src.is_dir():
                shutil.copytree(src, dst)
                stats['copied'] += 1
            else:
                shutil.copy2(src, dst)
                stats['copied'] += 1
    return stats


def assemble_dataset_dir(source_path: Union[str, Path],
                         target_path: Union[str, Path],
                         ds_name: Optional[str] = None) -> Dataset:
    """MolData npz dir -> Dataset dir (reference to_dgl.py; ours stores a
    manifest.json + per-molecule npzs instead of a graphs.bin)."""
    source_path, target_path = Path(source_path), Path(target_path)
    ds_name = ds_name or source_path.stem
    mols = []
    for molfile in sorted(source_path.iterdir()):
        if molfile.is_dir() or molfile.suffix != '.npz':
            continue
        mols.append(MolData.load(molfile))
    if not mols:
        raise ValueError(f"no molecules found in {source_path}")
    ds = Dataset.from_moldata(mols, ds_name=ds_name)
    ds.save(target_path)
    return ds


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='espaloma archive -> grappa_tpu_torch dataset conversion')
    sub = parser.add_subparsers(dest='cmd', required=True)

    p = sub.add_parser('to-moldata', help='record npz dir -> MolData npz dir')
    p.add_argument('--source_path', required=True)
    p.add_argument('--target_path', required=True)
    p.add_argument('--partial_charge_key', default='am1bcc_elf_charges')
    p.add_argument('--charge_model', default='am1BCC')

    p = sub.add_parser('unmerge', help='copy duplicates back into datasets')
    p.add_argument('--duplpath', required=True)
    p.add_argument('--targetpath', required=True)

    p = sub.add_parser('to-dataset', help='MolData npz dir -> Dataset dir')
    p.add_argument('--source_path', required=True)
    p.add_argument('--target_path', required=True)
    p.add_argument('--ds_name', default=None)

    args = parser.parse_args(argv)
    if args.cmd == 'to-moldata':
        stats = convert_espaloma_dir(args.source_path, args.target_path,
                                     args.partial_charge_key,
                                     args.charge_model)
        print(stats)
    elif args.cmd == 'unmerge':
        print(unmerge_duplicates(args.duplpath, args.targetpath))
    else:
        ds = assemble_dataset_dir(args.source_path, args.target_path,
                                  args.ds_name)
        print(f"saved dataset with {len(ds)} molecules")


if __name__ == '__main__':
    main()
