"""The port's zoo, Grappa.from_tag and command line (grappa_tpu_torch.zoo,
api, cli) against the JAX package's, on the CPU, on fixtures in the layout
of a release.

The cache (a temporary GRAPPA_TPU_CACHE) holds a JAX-exported model dict
as models/grappa-1.2.pth, one dataset as a directory, one as the release's
zip with a nested top directory and the espaloma_split tag directory, as
tests/test_ingest_release.py builds it. `_download` is patched to raise in
every test: nothing here reaches a network. Results of the two packages'
commands agree at rtol 1e-4 (the evaluation's tolerance,
tests/test_torch_port_eval.py); verdicts, exit codes, audit lists and
listings are equal; an exported checkpoint equals the run's model.npz bit
for bit.
"""
import json
import shutil
import zipfile

import jax
import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu import cli as jcli
from grappa_tpu.api import Grappa as JaxGrappa
from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.dataset import Dataset as JaxDataset
from grappa_tpu.data.dataset import save_split
from grappa_tpu.data.synthetic import make_moldata, random_molecule
from grappa_tpu.models import grappa_model as jgm
from grappa_tpu.train import export as jexport
from grappa_tpu import zoo as jzoo
from grappa_tpu_torch import Grappa, Molecule, cli, zoo
from grappa_tpu_torch.train import config as tconfig
from grappa_tpu_torch.train import export as texport
from grappa_tpu_torch.train import run as trun

RTOL = 1e-4
TAGS = ('spice-dipeptide', 'rna-diverse')


def _no_download(url, target):
    raise AssertionError(f'a test tried to download {url}')


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    monkeypatch.setattr(zoo, '_download', _no_download)
    monkeypatch.setattr(jzoo, '_download', _no_download)


def _zip_dir(src, zip_path, top):
    zip_path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(zip_path, 'w') as zf:
        for f in src.rglob('*'):
            zf.write(f, f'{top}/{f.relative_to(src)}')


@pytest.fixture(scope='module')
def release_template(tmp_path_factory):
    """A cache populated like a release placed by hand: the model .pth, one
    extracted dataset, one zipped, and the espaloma_split directory."""
    root = tmp_path_factory.mktemp('release')
    cache = root / 'cache'
    cfg = jgm.get_small_model_config()
    jm = jgm.make_model(cfg)
    batch = jax_collate([JaxMolGraph.from_moldata(make_moldata(seed=0,
                                                               n_confs=2))])
    params = jax.jit(jm.init)(jax.random.key(3), batch)
    md = jexport.build_model_dict(params, {'model_config': cfg}, model=jm)
    jexport.save_model_dict(md, cache / 'models' / 'grappa-1.2.pth')

    split = {'train': [], 'val': [], 'test': []}
    for tag, seed in zip(TAGS, (100, 200)):
        mds = [make_moldata(seed=seed + i, n_confs=3, ds_name=tag,
                            atom_range=(6, 14)) for i in range(6)]
        for m in mds:
            m.ff_energy['amber99'] = m.energy_ref + np.float32(0.5)
            m.ff_gradient['amber99'] = m.gradient_ref * np.float32(1.1)
        ds = JaxDataset.from_moldata(mds, tag)
        if tag == 'spice-dipeptide':
            ds.save(cache / 'datasets' / tag)
        else:
            ds.save(root / 'staging' / tag)
            _zip_dir(root / 'staging' / tag,
                     cache / 'datasets' / f'{tag}.zip', tag)
        ids = sorted(ds.mol_ids)
        split['test'] += ids[-2:]
        split['val'] += ids[-3:-2]
        split['train'] += ids[:-3]
    (cache / 'datasets' / 'espaloma_split').mkdir(parents=True)
    save_split(split, cache / 'datasets' / 'espaloma_split'
               / 'espaloma_split.json')
    return cache


@pytest.fixture()
def release_cache(release_template, tmp_path, monkeypatch):
    """A fresh copy of the release cache for each test, as GRAPPA_TPU_CACHE
    (the zip is still unextracted)."""
    cache = tmp_path / 'cache'
    shutil.copytree(release_template, cache)
    monkeypatch.setenv('GRAPPA_TPU_CACHE', str(cache))
    return cache


def test_zoo_resolution(tmp_path, monkeypatch):
    monkeypatch.setenv('GRAPPA_TPU_CACHE', str(tmp_path))
    root = tmp_path / 'datasets'
    # a cached directory, and any existing path, resolve as they are
    (root / 'gen2').mkdir(parents=True)
    assert zoo.dataset_path_from_tag('gen2') == root / 'gen2'
    assert zoo.dataset_path_from_tag(str(tmp_path)) == tmp_path
    # a cached zip with a nested top directory is extracted and flattened
    (tmp_path / 'src').mkdir()
    (tmp_path / 'src' / 'manifest.json').write_text('{}')
    _zip_dir(tmp_path / 'src', root / 'pepconf-dlc.zip', 'pepconf-dlc')
    got = zoo.dataset_path_from_tag('pepconf-dlc')
    assert got == root / 'pepconf-dlc'
    assert (got / 'manifest.json').read_text() == '{}'
    assert not (root / 'pepconf-dlc.extract').exists()
    # a corrupt zip is removed, so the next resolution fetches it again
    (root / 'gen2-torsion.zip').write_bytes(b'not a zip')
    with pytest.raises(RuntimeError, match='corrupt'):
        zoo.dataset_path_from_tag('gen2-torsion')
    assert not (root / 'gen2-torsion.zip').exists()
    # ... and that fetch is a download, which the tests refuse
    with pytest.raises(AssertionError, match='download'):
        zoo.dataset_path_from_tag('gen2-torsion')
    with pytest.raises(AssertionError, match='download'):
        zoo.model_path_from_tag('grappa-1.1')
    for fn in (zoo.dataset_path_from_tag, zoo.model_path_from_tag):
        with pytest.raises(KeyError, match='no-such-tag'):
            fn('no-such-tag')
    assert zoo.MODEL_TAGS == jzoo.MODEL_TAGS
    assert zoo.DATASET_TAGS == jzoo.DATASET_TAGS


def test_from_tag_predicts_like_jax(release_cache):
    assert zoo.model_path_from_tag('grappa-1.2') == \
        release_cache / 'models' / 'grappa-1.2.pth'
    mols = [random_molecule(seed=s, atom_range=(8, 20)) for s in range(3)]
    want = JaxGrappa.from_tag('grappa-1.2').predict_many(
        mols, check_eq_values=False)
    got = Grappa.from_tag('grappa-1.2', device='cpu').predict_many(
        [Molecule.from_dict(m.to_dict()) for m in mols],
        check_eq_values=False)
    for g, w in zip(got, want):
        for name in ('bond_k', 'bond_eq', 'angle_k', 'angle_eq'):
            np.testing.assert_allclose(getattr(g, name), getattr(w, name),
                                       rtol=3e-4, atol=3e-5, err_msg=name)


def _close(got, want, path=''):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, (bool, str, type(None))):
        assert got == want, path
    elif isinstance(want, list) and want and isinstance(want[0], str):
        assert got == want, path
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=path)


def test_ingest_release_matches_jax(release_cache, tmp_path):
    reports = {}
    for name, main in (('jax', jcli.main), ('port', cli.main)):
        out = tmp_path / name / 'report'
        out.parent.mkdir()
        argv = ['ingest-release', '-d', *TAGS, '--n-bootstrap', '20',
                '-o', str(out)]
        rc = main(argv + (['--device', 'cpu'] if name == 'port' else []))
        report = json.loads((out.parent / 'report.json').read_text())
        assert (out.parent / 'report.md').exists()
        assert (out.parent / 'report.tex').exists()
        reports[name] = (rc, report)
    (jrc, want), (rc, got) = reports['jax'], reports['port']
    # seeded weights: parity fails, and the exit code says so
    assert rc == jrc == 1 and got['parity']['pass'] is False
    assert got['checkpoint_audit'] == want['checkpoint_audit']
    assert got['checkpoint_audit']['missing_vs_expected'] == []
    assert got['checkpoint_audit']['unexpected_in_file'] == []
    assert got['checkpoint_audit']['import_warnings'] == []
    _close(got['results'], want['results'])
    _close(got['parity'], want['parity'])
    assert got['datasets'] == want['datasets'] == list(TAGS)
    assert (release_cache / 'datasets' / 'rna-diverse').is_dir()


def test_eval_command_matches_jax(release_cache, tmp_path):
    results = {}
    for name, main in (('jax', jcli.main), ('port', cli.main)):
        model = tmp_path / f'{name}.pth'
        shutil.copy(release_cache / 'models' / 'grappa-1.2.pth', model)
        out = tmp_path / f'{name}.json'
        argv = ['eval', '-t', str(model), '-d', *TAGS, '--set', 'all',
                '--classical', '--n-bootstrap', '20', '-o', str(out)]
        main(argv + (['--device', 'cpu'] if name == 'port' else []))
        results[name] = json.loads(out.read_text())
        # written back into the model file, under the set's name
        stored = jexport.load_model_dict(model)['results']['all']
        _close(stored, results[name])
    assert set(results['port']) == {'grappa_tpu', 'amber99'}
    _close(results['port'], results['jax'])
    # the port's file with results still loads in both packages
    texport.model_from_dict(texport.load_model_dict(tmp_path / 'port.pth'))
    jexport.model_from_dict(jexport.load_model_dict(tmp_path / 'port.pth'))


def test_eval_refuses_a_set_without_a_split(release_cache):
    with pytest.raises(SystemExit, match='needs a split'):
        cli.main(['eval', '-t', 'grappa-1.2', '-d', TAGS[0], '--set', 'test',
                  '--no-write', '--device', 'cpu'])


def test_main_answers_unknown_commands(capsys):
    assert cli.main(['no-such-command']) == 2
    assert 'available' in capsys.readouterr().out
    assert cli.main([]) == 0
    assert 'ingest-release' in capsys.readouterr().out
    # gmx is a command now: without its required flags argparse exits 2
    with pytest.raises(SystemExit) as exc:
        cli.main(['gmx'])
    assert exc.value.code == 2 and 'gmx' in cli.COMMANDS


def test_dataset_command(tmp_path, capsys):
    """`dataset` is a command with the JAX package's four actions: each
    without its required flags exits 2 from argparse, as the JAX package's
    does; `add-charge-model` on a saved dataset answers as the JAX
    package's (tests/test_torch_port_datatools.py holds every action
    against it file for file)."""
    assert 'dataset' in cli.COMMANDS
    for argv in (['dataset'], ['dataset', 'add-charge-model'],
                 ['dataset', 'from-moldata-dirs', '-s', 'x'],
                 ['dataset', 'split-export', '-d', 'x'],
                 ['dataset', 'from-pdb-npz', '-t', 'x'],
                 ['dataset', 'no-such-action']):
        for main in (jcli.main, cli.main):
            with pytest.raises(SystemExit) as exc:
                main(argv)
            assert exc.value.code == 2, argv
    capsys.readouterr()
    outs = []
    for name, main in (('jax', jcli.main), ('port', cli.main)):
        path = tmp_path / name / 'AA_radical'
        JaxDataset.from_moldata([make_moldata(seed=7, n_confs=2)],
                                'syn').save(path)
        assert main(['dataset', 'add-charge-model', '-d', str(path)]) == 0
        outs.append(capsys.readouterr().out)
        assert (path / 'mol_000000.npz').read_bytes() == (
            tmp_path / 'jax' / 'AA_radical' / 'mol_000000.npz').read_bytes()
    assert outs[0] == outs[1] == '{"updated": 1}\n'


def _run_config(ds_dir):
    config = tconfig.default_config()
    tconfig.overwrite_config({
        'model_config': jgm.get_small_model_config(),
        'data_config': {
            'datasets': [str(ds_dir)], 'conf_strategy': 3,
            'val_conf_strategy': 3, 'train_batch_size': 2,
            'val_batch_size': 4, 'partition': [0.6, 0.2, 0.2],
            'pure_train_datasets': [], 'pure_val_datasets': [],
            'weights': {}, 'seed': 1,
        },
        'lit_model_config': {'lr': 2e-4, 'start_qm_epochs': 0,
                             'warmup_steps': 1},
        'trainer_config': {'max_epochs': 1, 'checkpoint_every': 1,
                           'name': 'run'},
    }, config)
    return config


def test_export_and_resume_all(tmp_path, capsys):
    ds_dir = tmp_path / 'data'
    JaxDataset.from_moldata([make_moldata(seed=300 + i, n_confs=3,
                                          atom_range=(6, 12))
                             for i in range(5)], 'syn').save(ds_dir)
    project = tmp_path / 'runs'
    out = trun.do_trainrun(_run_config(ds_dir), project_dir=str(project),
                           device='cpu')
    run_dir = out['run_dir']
    exported = tmp_path / 'exported.npz'
    assert cli.main(['export', run_dir, '-o', str(exported)]) == 0
    got = texport.load_model_dict(exported)
    want = texport.load_model_dict(out['model_dict_path'])
    assert set(got['state_dict']) == set(want['state_dict'])
    for key, v in want['state_dict'].items():
        a = got['state_dict'][key]
        assert a.dtype == v.dtype and a.tobytes() == v.tobytes(), key
    assert got['split_names'] == want['split_names']
    assert got['config'] == json.loads(json.dumps(want['config']))

    # resume-all's listing: the finished run, one without its model file
    # (resumed), one without a checkpoint, one excluded
    shutil.copytree(run_dir, project / 'unfinished')
    (project / 'unfinished' / 'model.npz').unlink()
    (project / 'empty').mkdir()
    shutil.copytree(run_dir, project / 'skip-me')
    listings = []
    for main in (jcli.main, cli.main):
        capsys.readouterr()
        main(['resume-all', str(project), '--except', 'skip-me',
              '--dry-run'])
        listings.append(json.loads(capsys.readouterr().out))
    assert listings[0] == listings[1]
    assert listings[1]['to_resume'] == [
        {'run': 'unfinished', 'epochs_done': 1, 'target': 1}]
    assert {s['run']: s['reason'] for s in listings[1]['skipped']} == {
        'empty': 'no checkpoint', 'run': 'finished', 'skip-me': 'excluded'}
