"""Dataset-creation tools beyond the espaloma pipeline.

Counterpart of `grappa_tpu.data.dataset_creation` on the port's MolData,
constants and OpenMM wrappers: plain numpy and file work, no device; the
files it writes load in either package. Counterparts of the reference's
`dataset_creation/` scripts:

  * add_charge_model_feature  — dataset_creation/add_charge_model_feat.py:
    stamp the 2-dim charge-model one-hot onto every molecule of a saved
    dataset directory, inferring amber99 vs am1BCC from the dataset name.
  * moldata_dirs_to_dataset   — dataset_creation/radical_datasets/
    ds_from_dirs.py: folder/<molname>/moldata.npz trees (the radical data
    layout) -> a flat <molname>.npz MolData directory with the charge-model
    feature, optionally recomputing classical energies with openmm.
  * peptide_dataset_from_pdb_npz — dataset_creation/peptide_datasets/
    ds_from_pdb.py (forcefield_type='openmm'): per-molecule npz files with
    the spice-style key layout ('n1 xyz', 'n1 grad_qm', 'g u_qm', 'pdb',
    'sequence') -> MolData npz dataset, typing each PDB with an openmm
    force field (incl. 'amber99sbildn*' for HYP/DOP peptides).

openmm-dependent paths are import-gated (grappa_tpu_torch.wrappers) and
need openmm at run time.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from grappa_tpu_torch.constants import CHARGE_MODELS

# dataset names that carry classical (amber99) charges — everything else in
# the published collection uses am1BCC (reference add_charge_model_feat.py)
CLASSICAL_CHARGE_DATASETS = (
    'AA_radical', 'Capped_AA_opt_rad', 'Capped_AA_rad', 'Capped_AA_scan_rad',
    'dipeptide_rad', 'hyp-dop_amber99sbildn', 'AA_bondbreak_rad_amber99sbildn',
)
CLASSICAL_CHARGE_TAGS = ('amber99',)


def infer_charge_model(dataset_name: str) -> str:
    name = Path(dataset_name).name
    if name in CLASSICAL_CHARGE_DATASETS or any(
            tag in name for tag in CLASSICAL_CHARGE_TAGS):
        return 'amber99'
    return 'am1BCC'


def charge_model_one_hot(charge_model: str, n_atoms: int) -> np.ndarray:
    if charge_model not in CHARGE_MODELS:
        raise ValueError(
            f'charge model {charge_model!r} not in {CHARGE_MODELS}')
    row = np.asarray([cm == charge_model for cm in CHARGE_MODELS],
                     np.float32)
    return np.tile(row, (n_atoms, 1))


def add_charge_model_feature(dataset_dir, charge_model: Optional[str] = None,
                             overwrite: bool = True) -> int:
    """Stamp the charge-model one-hot onto every molecule of a saved
    Dataset directory (in place). Returns the number of molecules updated.

    charge_model=None infers amber99/am1BCC from the directory name the way
    the reference script does for the published dataset collection.
    """
    from grappa_tpu_torch.data.moldata import MolData

    dataset_dir = Path(dataset_dir)
    if charge_model is None:
        charge_model = infer_charge_model(dataset_dir.name)
    if (dataset_dir / 'manifest.json').exists():
        manifest = json.loads((dataset_dir / 'manifest.json').read_text())
        files = [item['file'] for item in manifest['entries']]
    else:                      # flat npz layout
        files = sorted(p.name for p in dataset_dir.glob('*.npz'))
    updated = 0
    for fname in files:
        path = dataset_dir / fname
        md = MolData.load(path)
        feats = md.molecule.additional_features
        if not overwrite and 'charge_model' in feats:
            continue
        feats['charge_model'] = charge_model_one_hot(
            charge_model, len(md.molecule.atoms))
        md.save(path)
        updated += 1
    return updated


def moldata_dirs_to_dataset(source_path, target_path,
                            charge_model: str = 'amber99',
                            openmm_forcefield=None,
                            forcefield_name: str = 'openmm_ff',
                            skip: Sequence[str] = ()) -> int:
    """folder/<molname>/moldata.npz -> target/<molname>.npz (radical data
    layout). Stamps the charge-model feature; when an openmm force field is
    given and the MolData carries a pdb, classical energies are recomputed
    and stored under `forcefield_name`. Returns the number of molecules.
    """
    from grappa_tpu_torch.data.moldata import MolData

    source_path, target_path = Path(source_path), Path(target_path)
    target_path.mkdir(parents=True, exist_ok=True)
    count = 0
    for moldir in sorted(source_path.iterdir()):
        if not moldir.is_dir():
            shutil.copy(moldir, target_path)     # README etc.
            continue
        molname = moldir.name
        if molname in skip:
            continue
        md = MolData.load(moldir / 'moldata.npz')
        if md.xyz.shape[0] == 0:
            continue
        md.molecule.additional_features['charge_model'] = \
            charge_model_one_hot(charge_model, len(md.molecule.atoms))
        if openmm_forcefield is not None and md.pdb is not None:
            from grappa_tpu_torch.wrappers.openmm_wrapper import get_energies
            from grappa_tpu_torch.wrappers.star_forcefield import topology_from_pdb
            top = topology_from_pdb(md.pdb)
            system = openmm_forcefield.createSystem(top)
            e, g = get_energies(system, md.xyz)
            md.ff_energy[forcefield_name] = np.asarray(e, np.float32)
            md.ff_gradient[forcefield_name] = np.asarray(g, np.float32)
        md.save(target_path / f'{molname}.npz')
        count += 1
    return count


def peptide_dataset_from_pdb_npz(source_path, target_path,
                                 forcefield: str = 'amber99sbildn*',
                                 skip_residues: Sequence[str] = (),
                                 charge_model: str = 'amber99',
                                 with_params: bool = True) -> dict:
    """spice-style per-molecule npz files -> MolData npz dataset directory.

    Input key layout (reference ds_from_pdb.py:34-45): 'n1 xyz' and
    'n1 grad_qm' shaped (n_atoms, n_confs, 3) [transposed on read],
    'g u_qm' (1, n_confs) in kcal/mol, 'pdb' (line list), 'sequence'.
    Each PDB is typed with the named openmm force field ('amber99sbildn*'
    supports HYP/DOP peptides via the star patch).
    """
    from grappa_tpu_torch.data.parameters import Parameters
    from grappa_tpu_torch.wrappers.openmm_wrapper import moldata_from_openmm_system
    from grappa_tpu_torch.wrappers.star_forcefield import (get_openmm_forcefield,
                                                     topology_from_pdb)

    source_path, target_path = Path(source_path), Path(target_path)
    target_path.mkdir(parents=True, exist_ok=True)
    ff = get_openmm_forcefield(forcefield)
    # suffix removal, NOT rstrip (which strips a character set and would
    # mangle names ending in '-', 's', 't', 'a', or 'r')
    ff_name = forcefield.removesuffix('*').removesuffix('-star')
    stats = {'total': 0, 'written': 0, 'skipped': 0, 'errors': 0,
             'confs': 0}
    for molfile in sorted(source_path.iterdir()):
        if molfile.is_dir() or molfile.suffix != '.npz':
            continue
        stats['total'] += 1
        data = dict(np.load(molfile, allow_pickle=True))
        sequence = str(data['sequence'])
        if any(res in sequence for res in skip_residues):
            stats['skipped'] += 1
            continue
        try:
            xyz = np.asarray(data['n1 xyz']).transpose(1, 0, 2)
            gradient = np.asarray(data['n1 grad_qm']).transpose(1, 0, 2)
            energy = np.asarray(data['g u_qm'])[0]
            pdbstring = ''.join(np.asarray(data['pdb']).tolist())
            topology = topology_from_pdb(pdbstring)
            system = ff.createSystem(topology)
            md = moldata_from_openmm_system(
                system, topology, xyz=xyz, energy=energy, gradient=gradient,
                mol_id=sequence, charge_model=charge_model, ff_name=ff_name)
            md.sequence = sequence
            md.pdb = pdbstring
            if not with_params:
                md.classical_parameters = Parameters.get_nan_params(
                    md.molecule)
            md.save(target_path / f'{molfile.stem}.npz')
            stats['written'] += 1
            stats['confs'] += int(energy.shape[0])
        except Exception as exc:       # mirror the reference: keep going
            stats['errors'] += 1
            print(f'error on {molfile.name}: {exc}')
    return stats


def split_export(dataset_dirs: Sequence, split, target_path,
                 pure_train_dirs: Sequence = (),
                 pure_val_dirs: Sequence = (),
                 pure_test_dirs: Sequence = (),
                 stamp_charge_model: bool = True) -> dict:
    """Save the train/val/test partitions of a dataset collection as
    separate per-molecule npz directories for publication
    (reference dataset_creation/split_datasets_for_publication.py).

    `dataset_dirs` are saved Dataset directories (manifest or flat npz
    layout); every molecule is routed by its mol_id through `split`
    (a {'train','val','test'} -> ids dict or a path to such a json) into
    target/<split>/<ds_name>/<stem>.npz. A molecule missing from the split
    raises, like the reference. `pure_*_dirs` go wholesale into their
    respective partition. Missing charge-model one-hots are stamped the
    way the reference script does (inferred from the dataset name) unless
    stamp_charge_model=False. Returns per-partition molecule counts.
    """
    from grappa_tpu_torch.data.moldata import MolData

    if not isinstance(split, dict):
        split = json.loads(Path(split).read_text())
    membership = {}
    for part in ('train', 'val', 'test'):
        for mol_id in split.get(part, ()):
            membership[mol_id] = part
    target_path = Path(target_path)
    counts = {'train': 0, 'val': 0, 'test': 0}

    def _mol_files(ds_dir: Path):
        if (ds_dir / 'manifest.json').exists():
            manifest = json.loads((ds_dir / 'manifest.json').read_text())
            return [ds_dir / item['file'] for item in manifest['entries']]
        return sorted(ds_dir.glob('*.npz'))

    def _export(ds_dir, part_of):
        ds_dir = Path(ds_dir)
        charge_model = infer_charge_model(ds_dir.name)
        for molfile in _mol_files(ds_dir):
            md = MolData.load(molfile)
            part = part_of(md)
            feats = md.molecule.additional_features
            if stamp_charge_model and 'charge_model' not in feats:
                feats['charge_model'] = charge_model_one_hot(
                    charge_model, len(md.molecule.atoms))
            out = target_path / part / ds_dir.name / f'{molfile.stem}.npz'
            out.parent.mkdir(parents=True, exist_ok=True)
            md.save(out)
            counts[part] += 1

    def _routed(md):
        part = membership.get(md.mol_id)
        if part is None:
            raise ValueError(
                f'molecule {md.mol_id} not found in any split partition')
        return part

    for ds_dir in dataset_dirs:
        _export(ds_dir, _routed)
    for dirs, part in ((pure_train_dirs, 'train'), (pure_val_dirs, 'val'),
                       (pure_test_dirs, 'test')):
        for ds_dir in dirs:
            _export(ds_dir, lambda md, p=part: p)
    return counts
