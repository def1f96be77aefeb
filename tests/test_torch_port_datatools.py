"""The port's data tools (grappa_tpu_torch.data.dataset_creation,
espaloma_pipeline, espaloma_split, the `dataset` command, the laplacian
positional encoding and the bucketed geometry minimiser) against the JAX
package's, on the CPU.

The tools are numpy and file work in both packages: every file the two
write from the same input is compared byte for byte (np.savez writes no
time stamp), and directories either package writes load in the other's
Dataset with every array equal. tests/test_dataset_creation.py,
test_espaloma_pipeline.py and test_espaloma_format.py are ported here;
`from-pdb-npz` runs through the openmm double (tests/openmm_double.py),
as tests/test_torch_port_openmm.py runs the wrappers. The bucketed
minimiser is held to tests/test_energy.py:138-171's rules: in float64 its
positions within 5e-4 A of the port's 'torch' path (and the energies at
rtol 1e-6), in float32 the energy at the minimum within max(0.02 |E|,
0.5) of the 'torch' path's, beside the JAX package's 'jax' path.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import openmm_double
from test_espaloma_format import golden_record
from test_openmm_wrapper import _capped_hyp_pdb

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu import cli as jcli
from grappa_tpu import espaloma_split as jsplit
from grappa_tpu.data import dataset_creation as jdc
from grappa_tpu.data import espaloma_pipeline as jep
from grappa_tpu.data import synthetic as jsyn
from grappa_tpu.data.dataset import Dataset as JaxDataset
from grappa_tpu.graph_features import (
    laplacian_positional_encoding as jax_laplacian)
from grappa_tpu_torch import cli
from grappa_tpu_torch import espaloma_split as tsplit
from grappa_tpu_torch.data import dataset_creation as tdc
from grappa_tpu_torch.data import espaloma_pipeline as tep
from grappa_tpu_torch.data import synthetic as tsyn
from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.data.moldata import MolData
from grappa_tpu_torch.graph_features import laplacian_positional_encoding

ROOT = Path(__file__).resolve().parents[1]
ETHANOL = '[C:1]([H:4])([H:5])([H:6])[C:2]([H:7])([H:8])[O:3][H:9]'
FORMAMIDE = '[C:1](=[O:2])([N:3]([H:5])[H:6])[H:4]'
BENZENE = ('[c:1]1([H:7])[c:2]([H:8])[c:3]([H:9])[c:4]([H:10])'
           '[c:5]([H:11])[c:6]1[H:12]')
DIPEPTIDE = ('[C:1]([H:7])([H:8])([H:9])[C:2](=[O:3])[N:4]([H:10])'
             '[C:5]([H:11])([H:12])[H:6]')


def _same_tree(a: Path, b: Path):
    """The same relative file names under a and b, each file equal byte
    for byte."""
    files = sorted(p.relative_to(a) for p in a.rglob('*') if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob('*')
                           if p.is_file())
    assert files
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def _same_datasets(path: Path):
    """`path` loads in both packages' Dataset with every array equal."""
    jds, tds = JaxDataset.load(path), Dataset.load(path)
    assert jds.ds_names == tds.ds_names and len(tds) == len(jds) > 0
    for je, te in zip(jds.entries, tds.entries):
        jd, td = je.to_dict(), te.to_dict()
        assert list(jd) == list(td)
        for k in jd:
            assert np.asarray(jd[k]).dtype == np.asarray(td[k]).dtype, k
            np.testing.assert_array_equal(jd[k], td[k], err_msg=k)
    return tds


def _radical_tree(tmp_path, n=4):
    src = tmp_path / 'radical_src'
    for i in range(n):
        md = tsyn.make_moldata(seed=100 + i, n_confs=3)
        flags = np.zeros(len(md.molecule.atoms), bool)
        flags[0] = True
        md.molecule.set_radical_flags(flags)
        d = src / f'mol_{i}'
        d.mkdir(parents=True)
        md.save(d / 'moldata.npz')
    (src / 'README').write_text('radical molecules\n')
    return src


# ---------------------------------------------------------- dataset tools
def test_charge_model_helpers_equal():
    for name in ('spice-pubchem', 'AA_radical', 'hyp-dop_amber99sbildn',
                 'tripeptides_amber99sbildn', '/x/y/Capped_AA_rad', 'gen2'):
        assert tdc.infer_charge_model(name) == jdc.infer_charge_model(name)
    assert tdc.infer_charge_model('AA_radical') == 'amber99'
    assert tdc.infer_charge_model('spice-pubchem') == 'am1BCC'
    for cm in ('am1BCC', 'amber99'):
        got = tdc.charge_model_one_hot(cm, 5)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jdc.charge_model_one_hot(cm, 5))
    with pytest.raises(ValueError, match='not in'):
        tdc.charge_model_one_hot('gasteiger', 3)
    assert tdc.CLASSICAL_CHARGE_DATASETS == jdc.CLASSICAL_CHARGE_DATASETS


@pytest.mark.parametrize('layout', ['manifest', 'flat'])
def test_add_charge_model_matches_jax(tmp_path, capsys, layout):
    """`dataset add-charge-model` in both packages on copies of one
    dataset: the same files and counts (inferred, explicit, keep-existing),
    and the result loads in both packages' Dataset."""
    src = tmp_path / 'src' / 'spice-like'
    mols = tsyn.make_dataset(n_mols=3, n_confs=2, seed=0)
    if layout == 'manifest':
        Dataset.from_moldata(mols, 'syn').save(src)
    else:
        src.mkdir(parents=True)
        for i, md in enumerate(mols):
            md.save(src / f'm{i}.npz')
    counts = {}
    for pkg, main in (('jax', jcli.main), ('port', cli.main)):
        d = tmp_path / pkg / 'spice-like'
        shutil.copytree(src, d)
        got = []
        for extra in ([], ['-c', 'amber99'],
                      ['-c', 'am1BCC', '--keep-existing']):
            main(['dataset', 'add-charge-model', '-d', str(d)] + extra)
            got.append(json.loads(capsys.readouterr().out)['updated'])
        counts[pkg] = got
    assert counts['port'] == counts['jax'] == [3, 3, 0]
    _same_tree(tmp_path / 'jax', tmp_path / 'port')
    ds = _same_datasets(tmp_path / 'port' / 'spice-like')
    for md, _ in ds:
        np.testing.assert_array_equal(
            md.molecule.additional_features['charge_model'],
            tdc.charge_model_one_hot('amber99', len(md.molecule.atoms)))


def test_cli_radical_dataset_builds_and_trains(tmp_path, capsys):
    """`dataset from-moldata-dirs` (`python -m grappa_tpu_torch.cli`, and
    the JAX package's command in process) on a radical tree: the same
    flat MolData directory file for file, radical flags and the amber99
    one-hot in it; then one epoch of `cli train` on it with --device
    cpu."""
    src = _radical_tree(tmp_path, n=5)
    target = tmp_path / 'port' / 'AA_radical'
    out = subprocess.run(
        [sys.executable, '-m', 'grappa_tpu_torch.cli', 'dataset',
         'from-moldata-dirs', '-s', str(src), '-t', str(target),
         '-c', 'amber99', '--skip', 'mol_4'],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])['written'] == 4
    assert jcli.main(['dataset', 'from-moldata-dirs', '-s', str(src), '-t',
                      str(tmp_path / 'jax' / 'AA_radical'), '-c', 'amber99',
                      '--skip', 'mol_4']) in (None, 0)
    _same_tree(tmp_path / 'jax', tmp_path / 'port')
    assert (target / 'README').read_text() == 'radical molecules\n'
    ds = _same_datasets(target)
    assert len(ds) == 4 and ds.ds_names[0] == 'AA_radical'
    for md, _ in ds:
        assert md.molecule.additional_features['is_radical'][0] == 1.0
        np.testing.assert_array_equal(
            md.molecule.additional_features['charge_model'],
            tdc.charge_model_one_hot('amber99', len(md.molecule.atoms)))

    from grappa_tpu_torch.models.grappa_model import get_small_model_config
    from grappa_tpu_torch.train.config import default_config
    config = default_config()
    config['model_config'] = get_small_model_config()
    config['data_config'].update(
        datasets=[str(target)], conf_strategy=3, val_conf_strategy=3,
        train_batch_size=2, val_batch_size=2, partition=[0.5, 0.25, 0.25],
        pure_train_datasets=[], pure_val_datasets=[], weights={}, seed=0)
    config['lit_model_config'].update(lr=2e-4, start_qm_epochs=0,
                                      warmup_steps=1)
    config['trainer_config'].update(max_epochs=1, checkpoint_every=1)
    cfg_path = tmp_path / 'radical.json'
    cfg_path.write_text(json.dumps(config))
    capsys.readouterr()
    cli.main(['train', '-c', str(cfg_path), '-p', str(tmp_path / 'runs'),
              '-n', 'radical', '--device', 'cpu'])
    run_dir = Path(json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1])['run_dir'])
    meta = json.loads((run_dir / 'last.ckpt' / 'meta.json').read_text())
    assert meta['epoch'] == 1
    assert (run_dir / 'model.npz').exists()
    metrics = (run_dir / 'metrics.jsonl').read_text().splitlines()
    losses = [v for line in metrics for k, v in json.loads(line).items()
              if 'loss' in k and isinstance(v, float)]
    assert losses and np.isfinite(losses).all()


def test_pdb_npz_matches_jax(tmp_path, capsys):
    """`dataset from-pdb-npz` through the openmm double (a HYP peptide,
    one entry skipped by residue, --no-params on a second run): both
    packages write the same files and statistics; the HYP ring is typed
    by the star force field."""
    rng = np.random.default_rng(0)
    src = tmp_path / 'pdb_npz'
    src.mkdir()
    pdb = _capped_hyp_pdb()
    n_atoms, n_confs = 27, 2
    for name, seq in (('ACE-HYP-NME', 'ACE-HYP-NME'),
                      ('skipme', 'ACE-HID-NME')):
        np.savez(src / f'{name}.npz', **{
            'n1 xyz': rng.uniform(0, 20, (n_atoms, n_confs, 3)),
            'n1 grad_qm': rng.normal(0, 1, (n_atoms, n_confs, 3)),
            'g u_qm': rng.normal(0, 1, (1, n_confs)),
            'pdb': np.asarray([line + '\n' for line in pdb.splitlines()]),
            'sequence': seq})
    openmm_double.install()
    try:
        stats = {}
        for pkg, main in (('jax', jcli.main), ('port', cli.main)):
            got = []
            for name, extra in (('peptides', []),
                                ('no_params', ['--no-params'])):
                main(['dataset', 'from-pdb-npz', '-s', str(src), '-t',
                      str(tmp_path / pkg / name), '--skip-residues', 'HID']
                     + extra)
                line = json.loads(capsys.readouterr().out)
                got.append({k: v for k, v in line.items() if k != 'target'})
            stats[pkg] = got
    finally:
        openmm_double.uninstall()
    assert stats['port'] == stats['jax']
    assert stats['port'][0] == {'total': 2, 'written': 1, 'skipped': 1,
                                'errors': 0, 'confs': 2}
    _same_tree(tmp_path / 'jax', tmp_path / 'port')
    md = MolData.load(tmp_path / 'port' / 'peptides' / 'ACE-HYP-NME.npz')
    assert md.sequence == 'ACE-HYP-NME' and len(md.molecule.bonds) == 27
    assert 'amber99sbildn' in md.ff_energy
    assert not np.isnan(md.classical_parameters.bond_k).any()
    md = MolData.load(tmp_path / 'port' / 'no_params' / 'ACE-HYP-NME.npz')
    assert np.isnan(md.classical_parameters.bond_k).all()


def test_split_export_matches_jax(tmp_path, capsys):
    """The espaloma split built by both packages, then `dataset
    split-export` in both: the same publication tree file for file and
    the same counts; every id in exactly one partition; pure datasets go
    wholesale; a molecule outside the split raises in both."""
    names = ('spice-des-monomers', 'tripeptides_amber99sbildn',
             'rna-trinucleotide')
    sets = {}
    for seed, name, n in zip((50, 51, 52), names, (4, 3, 2)):
        ds = Dataset.from_moldata(
            tsyn.make_dataset(n_mols=n, n_confs=2, seed=seed), name)
        ds.save(tmp_path / name)
        sets[name] = ds
    ids = sets[names[0]].mol_ids + sets[names[1]].mol_ids
    te, vl = ids[6:] + ['not-in-data'], ids[4:6]
    split = tsplit.build_espaloma_split(ids + ids[:2], te, vl)
    assert split == jsplit.build_espaloma_split(ids + ids[:2], te, vl)
    assert split['train'] == ids[:4]
    with pytest.raises(ValueError, match='in both'):
        tsplit.build_espaloma_split(ids, ids[:2], ids[1:3])
    for pkg, mod in (('jax', jsplit), ('port', tsplit)):
        mod.save_espaloma_split(split, tmp_path / f'{pkg}_split.json')
    assert (tmp_path / 'jax_split.json').read_bytes() == \
        (tmp_path / 'port_split.json').read_bytes()
    te_file = tmp_path / 'te.json'
    te_file.write_text(json.dumps(te))
    assert tsplit.build_espaloma_split(ids, te_file, vl) == \
        tsplit.build_espaloma_split(ids, te, vl)

    counts = {}
    for pkg, main in (('jax', jcli.main), ('port', cli.main)):
        main(['dataset', 'split-export', '-d', str(tmp_path / names[0]),
              str(tmp_path / names[1]), '--split',
              str(tmp_path / 'port_split.json'), '-t',
              str(tmp_path / 'out' / pkg), '--pure-test',
              str(tmp_path / names[2])])
        counts[pkg] = json.loads(capsys.readouterr().out)
        counts[pkg].pop('target')
    assert counts['port'] == counts['jax'] == {'train': 4, 'val': 2,
                                               'test': 3}
    _same_tree(tmp_path / 'out' / 'jax', tmp_path / 'out' / 'port')
    seen = {}
    for part in ('train', 'val', 'test'):
        for f in sorted((tmp_path / 'out' / 'port').glob(f'{part}/*/*.npz')):
            md = MolData.load(f)
            assert md.mol_id not in seen
            seen[md.mol_id] = part
            cm = np.asarray(md.molecule.additional_features['charge_model'])
            np.testing.assert_array_equal(cm.sum(axis=1), 1.0)
    for part in ('train', 'val'):
        assert all(seen[i] == part for i in split[part])
    assert all(seen[i] == 'test' for i in sets[names[2]].mol_ids)
    for mod in (jdc, tdc):
        with pytest.raises(ValueError, match='not found in any split'):
            mod.split_export([tmp_path / names[2]], split,
                             tmp_path / 'out2')


# ------------------------------------------------------ espaloma pipeline
def _record(mapped_smiles, seed=0, n_confs=4):
    """tests/test_espaloma_pipeline.py's archive record."""
    from grappa_tpu_torch.data.smiles import parse_mapped_smiles
    z, _, _ = parse_mapped_smiles(mapped_smiles)
    rng = np.random.default_rng(seed)
    n = len(z)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return {
        'mapped_smiles': np.array([mapped_smiles]),
        'smiles': np.array([mapped_smiles.replace(':', 'x')]),
        'atomic_numbers': z,
        'am1bcc_elf_charges': (0.3 * f32(n)).astype(np.float32),
        'xyz': f32(n_confs, n, 3), 'energy_qm': f32(n_confs),
        'gradient_qm': f32(n_confs, n, 3), 'energy_ref': f32(n_confs),
        'gradient_ref': f32(n_confs, n, 3),
        'energy_gaff-2.11': f32(n_confs),
        'gradient_gaff-2.11': f32(n_confs, n, 3)}


def test_molecule_and_record_match_jax():
    for smiles in (FORMAMIDE, BENZENE, ETHANOL):
        got = tep.molecule_from_mapped_smiles(smiles, np.zeros(12)[
            :len(smiles.split(':')) - 1], 'am1BCC').to_dict()
        want = jep.molecule_from_mapped_smiles(smiles, np.zeros(12)[
            :len(smiles.split(':')) - 1], 'am1BCC').to_dict()
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mol = tep.molecule_from_mapped_smiles(FORMAMIDE, np.zeros(6))
    # C (O,N,H) and N (C,H,H): two centres x three versions, centre at 2
    assert len(mol.impropers) == 6 and len(mol.bonds) == 5
    assert set(mol.impropers[:, 2].tolist()) == {0, 2}

    rec = _record(FORMAMIDE, seed=1)
    md = tep.moldata_from_espaloma_record(rec)
    want = jep.moldata_from_espaloma_record(rec).to_dict()
    got = md.to_dict()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert md.n_confs == 4 and abs(md.energy_ref.mean()) < 1e-5
    assert {'gaff-2.11', 'qm'} <= set(md.ff_energy)
    assert np.isnan(md.classical_parameters.bond_k).all()
    assert md.mol_id == str(rec['smiles'][0])
    bad = dict(rec, atomic_numbers=np.roll(rec['atomic_numbers'], 1))
    with pytest.raises(ValueError, match='disagree'):
        tep.moldata_from_espaloma_record(bad)
    with pytest.raises(ValueError, match='mapped_smiles'):
        tep.moldata_from_espaloma_record(
            {k: v for k, v in rec.items() if k != 'mapped_smiles'})


def _raw_tree(root: Path):
    """Two archive datasets sharing ethanol as an espaloma-merged
    duplicate, one golden-layout record (tests/test_espaloma_format.py)
    and a broken one."""
    src_a, src_b = root / 'raw' / 'ds_a', root / 'raw' / 'ds_b'
    src_a.mkdir(parents=True)
    src_b.mkdir(parents=True)
    np.savez(src_a / 'mol0.npz', **_record(FORMAMIDE, seed=2))
    np.savez(src_a / 'mol1.npz', **_record(BENZENE, seed=3))
    np.savez_compressed(src_a / 'mol2.npz',
                        **golden_record(DIPEPTIDE, seed=7,
                                        with_amber14=True))
    np.savez(src_b / 'mol0.npz', **_record(ETHANOL, seed=4))
    bad = _record(ETHANOL, seed=5)
    bad['atomic_numbers'] = np.roll(bad['atomic_numbers'], 1)
    np.savez(src_b / 'mol1.npz', **bad)
    dup = root / 'dup' / '0' / 'ds_a'
    dup.mkdir(parents=True)
    np.savez(dup / 'mol_ethanol.npz', **_record(ETHANOL, seed=4))


def test_pipeline_matches_jax(tmp_path):
    """unmerge -> to-moldata -> to-dataset in both packages (the port's
    through `python -m grappa_tpu_torch.data.espaloma_pipeline`'s main):
    the same statistics and files; the datasets load in both packages and
    collate end to end."""
    stats = {}
    for pkg, mod in (('jax', jep), ('port', tep)):
        root = tmp_path / pkg
        _raw_tree(root)
        got = [mod.unmerge_duplicates(root / 'dup', root / 'raw'),
               mod.unmerge_duplicates(root / 'dup', root / 'raw')]
        for name in ('ds_a', 'ds_b'):
            got.append(mod.convert_espaloma_dir(root / 'raw' / name,
                                                root / 'moldata' / name))
            if pkg == 'port':
                tep.main(['to-dataset', '--source_path',
                          str(root / 'moldata' / name), '--target_path',
                          str(root / 'ds' / name), '--ds_name', name])
            else:
                mod.assemble_dataset_dir(root / 'moldata' / name,
                                         root / 'ds' / name, ds_name=name)
        stats[pkg] = got
    assert stats['port'] == stats['jax']
    assert stats['port'][:2] == [{'copied': 1, 'already_there': 0},
                                 {'copied': 0, 'already_there': 1}]
    assert stats['port'][2] == {'total': 4, 'success': 4, 'errors': 0,
                                'confs': 4 * 3 + 5}
    assert stats['port'][3]['errors'] == 1
    _same_tree(tmp_path / 'jax', tmp_path / 'port')
    full = (_same_datasets(tmp_path / 'port' / 'ds' / 'ds_a')
            + _same_datasets(tmp_path / 'port' / 'ds' / 'ds_b'))
    assert len(full) == 5
    golden = MolData.load(tmp_path / 'port' / 'moldata' / 'ds_a' /
                          'mol2.npz')
    assert {'amber14', 'openff-2.0.0', 'gaff-2.11'} <= set(golden.ff_energy)
    from grappa_tpu_torch.data import MolGraph, collate
    batch = collate([MolGraph.from_moldata(e) for e, _ in full],
                    device='cpu')
    assert batch.num_mols == 5 and torch.isfinite(batch.xyz).all()
    with pytest.raises(ValueError, match='no molecules'):
        tep.assemble_dataset_dir(tmp_path / 'port' / 'dup', tmp_path / 'x')
    with pytest.raises(ValueError, match='not found'):
        tep.unmerge_duplicates(tmp_path / 'port' / 'dup',
                               tmp_path / 'port' / 'moldata' / 'ds_b')


def test_jax_written_datasets_load_in_the_port(tmp_path):
    """A directory the JAX package's Dataset.save wrote loads in the
    port's, and the port's in the JAX package's, with every array equal."""
    mols = jsyn.make_dataset(n_mols=3, n_confs=2, seed=9)
    JaxDataset.from_moldata(mols, 'jax-side').save(tmp_path / 'jax')
    _same_datasets(tmp_path / 'jax')
    Dataset.from_moldata(tsyn.make_dataset(n_mols=3, n_confs=2, seed=9),
                         'jax-side').save(tmp_path / 'port')
    _same_datasets(tmp_path / 'port')
    _same_tree(tmp_path / 'jax', tmp_path / 'port')


# ------------------------------------------------- features and minimiser
def test_laplacian_pe_bit_equal():
    """tests/test_misc_features.py:34's 4-ring, and a chain, a star, a
    disconnected pair and a synthetic molecule, at several k."""
    mol = tsyn.random_molecule(seed=3)
    graphs = [([(0, 1), (1, 2), (2, 3), (3, 0)], 4),
              ([(0, 1), (1, 2), (2, 3), (3, 4)], 5),
              ([(0, 1), (0, 2), (0, 3)], 4),
              ([(0, 1), (2, 3)], 5),
              (mol.bonds_by_index().tolist(), len(mol.atoms))]
    for bonds, n in graphs:
        for k in (1, 3, 5, 8):
            got = laplacian_positional_encoding(bonds, n, k=k)
            want = jax_laplacian(bonds, n, k=k)
            assert got.dtype == want.dtype == np.float32
            assert got.shape == (n, k)
            assert got.tobytes() == want.tobytes(), (bonds, k)


def _minimum_case(seed):
    """tests/test_energy.py:138-171's molecule, parameters and start."""
    mol = tsyn.random_molecule(seed, elements=[1, 1, 6, 6, 7, 8],
                               atom_range=(12, 20))
    params = tsyn.environment_parameters(mol)
    xyz = tsyn.embed_conformers(mol, 1, seed, noise=0.08, params=params)
    return mol, params, xyz[0]


def test_bucketed_minimizer_float64_matches_torch():
    mol, params, xyz = _minimum_case(977)
    xt = tsyn.minimize_geometry(mol, params, xyz, method='torch')
    xb = tsyn.minimize_geometry(mol, params, xyz, method='bucketed',
                                device='cpu', dtype=torch.float64)
    assert xb.dtype == np.float32 and xb.shape == xyz.shape
    np.testing.assert_allclose(xb, xt, rtol=0, atol=5e-4)
    et, _ = tsyn.torch_bonded_energy(mol, params, xt[None])
    eb, _ = tsyn.torch_bonded_energy(mol, params, xb[None])
    np.testing.assert_allclose(eb, et, rtol=1e-6)


@pytest.mark.parametrize('seed', [978, 3, 11])
def test_bucketed_minimizer_float32_energy_rule(seed, monkeypatch):
    """float32 on the CPU against the 'torch' path and the JAX package's
    'jax' path: each minimum's energy within max(0.02 |E|, 0.5) of the
    'torch' one; GRAPPA_TPU_MINIMIZER=jax selects the bucketed path."""
    mol, params, xyz = _minimum_case(seed)
    jmol = jsyn.random_molecule(seed, elements=[1, 1, 6, 6, 7, 8],
                                atom_range=(12, 20))
    jparams = jsyn.environment_parameters(jmol)
    xt = tsyn.minimize_geometry(mol, params, xyz, method='torch')
    xb = tsyn.minimize_geometry(mol, params, xyz, method='bucketed',
                                device='cpu')
    xj = jsyn.minimize_geometry(jmol, jparams, xyz, method='jax')
    monkeypatch.setenv('GRAPPA_TPU_MINIMIZER', 'jax')
    np.testing.assert_array_equal(
        tsyn.minimize_geometry(mol, params, xyz, device='cpu'), xb)
    energy = lambda x: float(tsyn.torch_bonded_energy(mol, params,
                                                      x[None])[0][0])
    et = energy(xt)
    for x in (xb, xj):
        assert abs(energy(x) - et) < max(0.02 * abs(et), 0.5)
    assert energy(xb) < energy(xyz)


def test_minimizer_device_and_methods(monkeypatch):
    mol, params, xyz = _minimum_case(5)
    with pytest.raises(ValueError, match="'bucketed'"):
        tsyn.minimize_geometry(mol, params, xyz, method='scipy')
    with pytest.raises(ValueError, match='float32 or float64'):
        tsyn.minimize_geometry(mol, params, xyz, method='bucketed',
                               device='cpu', dtype=torch.bfloat16)
    # the default path is the CPU's float64 one; the bucketed path runs on
    # the card unless asked for another device
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    tsyn.minimize_geometry(mol, params, xyz, n_steps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.minimize_geometry(mol, params, xyz, n_steps=2,
                               method='bucketed')
