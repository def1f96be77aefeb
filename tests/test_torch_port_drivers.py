"""The JAX package's last drivers on the port, against the JAX drivers on
the CPU: the espaloma-benchmark driver (grappa_tpu_torch.experiments.
benchmark, experiments/benchmark/train.py), its rehearsal (rehearsal,
experiments/benchmark/rehearsal.py), the synthetic smoke (smoke,
experiments/smoke/synthetic_smoke.py) and the convergence check
(convergence, experiments/smoke/tpu_convergence.py): the configs and run
names each flag set gives, with the JAX drivers' do_trainrun captured;
the -o / -s sampling weights in the weighted loader; the rehearsal's
split and summary; a tiny smoke run. Then the port's examples
(grappa_tpu_torch.examples) run on the CPU at small sizes.

Stand-in datasets are non-learnable make_dataset molecules (two a tag,
two conformers) in a temporary GRAPPA_TPU_CACHE; downloads are patched to
raise.
"""
import importlib
import importlib.util
import json
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu import zoo as jzoo
from grappa_tpu.data import synthetic as jsyn
from grappa_tpu.train import run as jrun
from grappa_tpu_torch import zoo
from grappa_tpu_torch.data import synthetic as tsyn
from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.experiments import (benchmark, convergence, rehearsal,
                                          smoke)
from grappa_tpu_torch.train import run as trun

REPO = Path(__file__).resolve().parent.parent
EXP = REPO / 'experiments'
EXAMPLES = REPO / 'grappa_tpu_torch' / 'examples'
MAKE_DATASET = tsyn.make_dataset


def _no_download(url, target):
    raise RuntimeError(f'no network in tests: {url}')


def _canon(config):
    return json.dumps(config, sort_keys=True)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Captured(Exception):
    pass


def _capture(calls, result=None):
    """A do_trainrun that records its call (and returns `result`, else
    raises Captured)."""
    def fake(config, **kwargs):
        calls.append((json.loads(json.dumps(config)), kwargs))
        if result is None:
            raise Captured()
        return result
    return fake


def _run_jax_main(monkeypatch, module, argv):
    monkeypatch.setattr(sys, 'argv', ['driver.py', *argv])
    try:
        module.main()
    except Captured:
        pass


@pytest.fixture
def no_network(monkeypatch):
    monkeypatch.setattr(zoo, '_download', _no_download)
    monkeypatch.setattr(jzoo, '_download', _no_download)


@pytest.fixture
def jax_capture(monkeypatch, no_network):
    import grappa_tpu.utils as jutils
    monkeypatch.setattr(jutils, 'enable_compilation_cache', lambda: None)
    calls = []
    monkeypatch.setattr(jrun, 'do_trainrun', _capture(calls))
    return calls


BENCHMARK_FLAGS = [[], ['-o', '2'], ['-s', '3'],
                   ['-o', '0.5', '-s', '3', '-tb', '16', '-vb', '8'],
                   ['--splitpath', 'split.json', '-tb', '4']]


@pytest.mark.parametrize('flags', BENCHMARK_FLAGS,
                         ids=[' '.join(f) or 'defaults'
                              for f in BENCHMARK_FLAGS])
def test_benchmark_config_equals_jax_driver(flags, jax_capture, monkeypatch,
                                            tmp_path):
    jdriver = _load(EXP / 'benchmark' / 'train.py', 'jax_benchmark_train')
    argv = [*flags, '--project', str(tmp_path / 'runs')]
    _run_jax_main(monkeypatch, jdriver, argv)
    (want, kwargs), = jax_capture
    got = benchmark.main(argv, dry_run=True)
    assert _canon(got) == _canon(want)
    assert kwargs == {'project_dir': str(tmp_path / 'runs'),
                      'cache_batches': True}
    name = got['trainer_config']['name']
    assert name == 'espaloma-benchmark' + ''.join(
        f'_{k}{float(v):g}' for k, v in (('opt', dict(zip(
            flags, flags[1:])).get('-o', 1)), ('scan', dict(zip(
                flags, flags[1:])).get('-s', 1))) if float(v) != 1.0)


@pytest.fixture(scope='module')
def stand_ins(tmp_path_factory):
    """Two molecules x two conformers under every tag of the benchmark
    yaml (both packages load the port's saved directories)."""
    cache = tmp_path_factory.mktemp('cache')
    config = benchmark.main([], dry_run=True)
    dcfg = config['data_config']
    tags = (dcfg['datasets'] + dcfg['pure_train_datasets']
            + dcfg['pure_val_datasets'])
    ids = {}
    for i, tag in enumerate(tags):
        ds = Dataset.from_moldata(tsyn.make_dataset(
            n_mols=2, n_confs=2, seed=400 + i, atom_range=(6, 12)), tag)
        ds.save(cache / 'datasets' / tag)
        ids[tag] = ds.mol_ids
    return cache, ids


def test_benchmark_split_rebuild_equals_jax(stand_ins, jax_capture,
                                            monkeypatch, tmp_path):
    """--te_smiles / --vl_smiles: both drivers rebuild the same espaloma
    split from the loaded tags (the JAX driver beside its script, here a
    copy; the port in the project directory) and train on it."""
    cache, ids = stand_ins
    monkeypatch.setenv('GRAPPA_TPU_CACHE', str(cache))
    every = [i for v in ids.values() for i in v]
    te, vl = tmp_path / 'te.json', tmp_path / 'vl.json'
    te.write_text(json.dumps(every[::5]))
    vl.write_text(json.dumps(every[1::5]))
    jdir = tmp_path / 'jax_driver'
    jdir.mkdir()
    for f in ('train.py', 'grappa_config.yaml'):
        shutil.copy(EXP / 'benchmark' / f, jdir)
    jdriver = _load(jdir / 'train.py', 'jax_benchmark_train_copy')
    argv = ['--te_smiles', str(te), '--vl_smiles', str(vl), '-o', '2']
    _run_jax_main(monkeypatch, jdriver,
                  argv + ['--project', str(tmp_path / 'jax')])
    (want, _), = jax_capture
    got = benchmark.main(argv + ['--project', str(tmp_path / 'port')],
                         dry_run=True)
    split = Path(got['data_config'].pop('splitpath'))
    assert split == tmp_path / 'port' / 'espaloma_split.json'
    assert json.loads(split.read_text()) == json.loads(
        Path(want['data_config'].pop('splitpath')).read_text())
    assert _canon(got) == _canon(want)
    # a second call finds the rebuilt split in the project directory
    again = benchmark.main(['--project', str(tmp_path / 'port')],
                           dry_run=True)
    assert again['data_config']['splitpath'] == str(split)


def test_scan_weights_reach_the_loader(stand_ins, monkeypatch, tmp_path):
    """-o 2 -s 3: the weighted loader's per-molecule sampling weights and
    its first epoch's draws equal JAX's get_dataloaders' on the same
    config, with the opt / scan tags drawn at 2x / 3x the weight of an
    unweighted tag."""
    cache, ids = stand_ins
    monkeypatch.setenv('GRAPPA_TPU_CACHE', str(cache))
    config = benchmark.main(['-o', '2', '-s', '3'], dry_run=True)
    dcfg = dict(config['data_config'], train_batch_size=4, val_batch_size=4,
                conf_strategy=2, val_conf_strategy=2)
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    want = jrun.get_dataloaders(dict(dcfg), tmp_path / 'jax')
    got = trun.get_dataloaders(dict(dcfg), tmp_path / 'port', device='cpu')
    tl, jl = got[0], want[0]
    np.testing.assert_allclose(tl._sample_weights, jl._sample_weights,
                               rtol=1e-15)
    assert [names for _, names in tl] == [names for _, names in jl]
    w = dict(zip(tl.dataset.ds_names, tl._sample_weights))
    base = w['spice-dipeptide']
    for tag, factor in (('gen2', 2), ('pepconf-dlc', 2), ('gen2-torsion', 3),
                        ('protein-torsion', 3), ('spice-pubchem', 0.8),
                        ('rna-diverse', 3)):
        if tag in w:
            assert w[tag] == pytest.approx(factor * base), tag


def _fast_make_dataset(calls):
    """make_dataset at 1/40 of the molecules, not learnable (no geometry
    minimisation), recording each call."""
    def fake(n_mols=8, n_confs=8, seed=0, **kwargs):
        calls.append(dict(n_mols=n_mols, n_confs=n_confs, seed=seed,
                          **kwargs))
        return MAKE_DATASET(n_mols=max(2, n_mols // 40), n_confs=2,
                            seed=seed, atom_range=(6, 12))
    return fake


HISTORY = [
    {'epoch': 0, 'early_stopping_loss': None, 'metrics': {}},
    {'epoch': 1, 'early_stopping_loss': None, 'metrics': {}},
    {'epoch': 2, 'early_stopping_loss': 9.87654,
     'metrics': {'avg': {'rmse_energies': 3.21, 'rmse_gradients': 4.5678}}},
    {'epoch': 3, 'early_stopping_loss': 5.4321,
     'metrics': {'avg': {'rmse_energies': 2.1234, 'rmse_gradients': 3.0}}},
]


def test_rehearsal_equals_jax_driver(monkeypatch, capsys, no_network,
                                     tmp_path):
    """The three syn-* tags (sizes, conformers, seeds, learnable), the
    espaloma split over their ids, the config and run name handed to
    do_trainrun, and the printed summary of one history."""
    import os
    import tempfile
    import grappa_tpu.utils as jutils
    monkeypatch.setattr(jutils, 'enable_compilation_cache', lambda: None)
    # both drivers' temporary caches under tmp_path; the JAX driver leaves
    # GRAPPA_TPU_CACHE set, the port's puts back what it found
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    monkeypatch.setenv('GRAPPA_TPU_CACHE', str(tmp_path / 'none'))
    jdriver = _load(EXP / 'benchmark' / 'rehearsal.py', 'jax_rehearsal')
    made, calls, splits = {'jax': [], 'port': []}, [], []

    def record_split(config, **kwargs):
        splits.append(json.loads(Path(
            config['data_config']['splitpath']).read_text()))
        return _capture(calls, {'results': {'history': HISTORY}})(
            config, **kwargs)
    monkeypatch.setattr(jsyn, 'make_dataset', _fast_make_dataset(made['jax']))
    monkeypatch.setattr(jrun, 'do_trainrun', record_split)
    monkeypatch.setattr(tsyn, 'make_dataset',
                        _fast_make_dataset(made['port']))
    monkeypatch.setattr(rehearsal, 'do_trainrun', record_split)
    argv = ['--epochs', '7', '--out', str(tmp_path)]
    monkeypatch.setattr(sys, 'argv', ['rehearsal.py', *argv])
    jdriver.main()
    want_out = capsys.readouterr().out
    found = os.environ['GRAPPA_TPU_CACHE']
    summary = rehearsal.main(argv + ['--device', 'cpu'])
    assert os.environ['GRAPPA_TPU_CACHE'] == found
    assert list(tmp_path.glob('rehearsal_cache_*')) == [Path(found)]
    got_out = capsys.readouterr().out
    assert made['port'] == made['jax'] and len(made['port']) == 3
    assert [(c['n_mols'], c['n_confs'], c['seed'], c['learnable'])
            for c in made['port']] == [(240, 12, 11, True), (160, 8, 23, True),
                                        (320, 6, 37, True)]
    assert splits[1] == splits[0] and splits[1]['test']
    (want, wkw), (got, gkw) = calls
    for c in (want, got):
        c['data_config'].pop('splitpath')
    assert _canon(got) == _canon(want)
    assert gkw == dict(wkw, device='cpu')
    assert json.loads(got_out) == json.loads(want_out) == summary
    assert summary['best_epoch'] == 3


def test_rehearsal_fraction_cuts_each_tag(monkeypatch, tmp_path):
    made, calls = [], []
    monkeypatch.setattr(tsyn, 'make_dataset', _fast_make_dataset(made))
    monkeypatch.setattr(rehearsal, 'do_trainrun', _capture(
        calls, {'results': {'history': HISTORY}}))
    summary = rehearsal.main(['--epochs', '2', '--fraction', '0.25',
                              '--out', str(tmp_path)])
    assert [c['n_mols'] for c in made] == [60, 40, 80]
    assert summary['overrides']['fraction'] == 0.25


CONVERGENCE_FLAGS = [[], ['--compute-dtype', 'bfloat16'],
                     ['--gnn-dtype', 'bfloat16', '--heads-dtype', 'float32',
                      '--scan-epochs', '--epochs', '1500', '--name', 'x']]


@pytest.mark.parametrize('flags', CONVERGENCE_FLAGS,
                         ids=[' '.join(f) or 'defaults'
                              for f in CONVERGENCE_FLAGS])
def test_convergence_config_equals_jax_driver(flags, jax_capture,
                                              monkeypatch):
    jdriver = _load(EXP / 'smoke' / 'tpu_convergence.py', 'jax_convergence')
    monkeypatch.setattr(jdriver, 'do_trainrun', _capture(jax_capture))
    made = []
    monkeypatch.setattr(jdriver, 'make_dataset', _fast_make_dataset(made))
    _run_jax_main(monkeypatch, jdriver, flags)
    (want, kwargs), = jax_capture
    got, name = convergence.main(flags, dry_run=True)
    assert _canon(got) == _canon(want)
    assert name == kwargs['run_name']
    assert made[0] == dict(n_mols=96, n_confs=16, seed=7, learnable=True,
                           conf_noise=0.08)
    limited, _ = convergence.main(flags + ['--time_limit', '0.5'],
                                  dry_run=True)
    assert limited['lit_model_config']['session_time_limit'] == 0.5


def test_smoke_config_equals_jax_driver(jax_capture, monkeypatch):
    jdriver = _load(EXP / 'smoke' / 'synthetic_smoke.py', 'jax_smoke')
    monkeypatch.setattr(jdriver, 'do_trainrun', _capture(jax_capture))
    monkeypatch.setattr(jdriver, 'make_dataset', _fast_make_dataset([]))
    _run_jax_main(monkeypatch, jdriver, ['--epochs', '4'])
    (want, kwargs), = jax_capture
    got, name = smoke.main(['--epochs', '4'], dry_run=True)
    assert _canon(got) == _canon(want)
    assert name == kwargs['run_name'] == 'synthetic-smoke'


def test_smoke_runs_on_the_cpu(tmp_path):
    series = smoke.main(['--epochs', '3', '--n-mols', '8', '--out',
                         str(tmp_path), '--device', 'cpu'])
    assert [s['epoch'] for s in series] == [0, 1, 2]
    assert np.isfinite([s['early_stopping_loss'] for s in series]).all()
    assert (tmp_path / 'synthetic-smoke' / 'model.npz').exists()


# -- the examples --------------------------------------------------------

def _example(path):
    return importlib.import_module(f'grappa_tpu_torch.examples.{path}')


@pytest.fixture
def offline_cache(monkeypatch, tmp_path, no_network):
    monkeypatch.setenv('GRAPPA_TPU_CACHE', str(tmp_path / 'cache'))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_examples_layout():
    """One module a script of the JAX package's examples/, and the shell
    script beside them."""
    jax_scripts = sorted(str(p.relative_to(REPO / 'examples'))
                         for p in (REPO / 'examples').rglob('*')
                         if p.suffix in ('.py', '.sh'))
    port = sorted(str(p.relative_to(EXAMPLES))
                  for p in EXAMPLES.rglob('*')
                  if p.suffix in ('.py', '.sh') and p.name != '__init__.py')
    assert port == jax_scripts


def test_example_molecule_creation_as_module():
    out = subprocess.run(
        [sys.executable, '-m',
         'grappa_tpu_torch.examples.usage.molecule_creation'],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'npz/json round-trip OK' in out.stdout


def test_examples_without_a_model_file(offline_cache, capsys):
    """usage/{dataset, inspect_models, molecular_dynamics},
    wrapper_construction/interface on the CPU at small sizes (the released
    tags they try first are not in the cache)."""
    ds, batch = _example('usage.dataset').main(['--n-mols', '4', '--device',
                                                'cpu'])
    assert len(ds) == 4 and batch.xyz.device.type == 'cpu'
    out = _example('usage.inspect_models').main(['--device', 'cpu'])
    assert np.isfinite(out.bond_k).all()
    drift, scale = _example('usage.molecular_dynamics').main(
        ['--steps', '40', '--device', 'cpu'])
    assert drift < 0.05
    params = _example('wrapper_construction.interface').main(
        ['--device', 'cpu'])
    assert len(params.bonds) == 5 and np.isfinite(params.bond_k).all()
    text = capsys.readouterr().out
    assert 'no cached data' in text and 'random small model' in text


def test_examples_train_reproduce_evaluate(offline_cache, monkeypatch):
    """training/train_small, then reproduction/reproduce and
    evaluation/evaluate on its model, on the CPU at small sizes."""
    cache = {}

    def once(**kwargs):
        key = json.dumps(kwargs, sort_keys=True)
        if key not in cache:
            cache[key] = MAKE_DATASET(**kwargs)
        return cache[key]
    train_small = _example('training.train_small')
    monkeypatch.setattr(train_small, 'make_dataset', once)
    monkeypatch.setattr(tsyn, 'make_dataset', once)
    out = train_small.main(['--epochs', '3', '--n-mols', '10', '--device',
                            'cpu'])
    model = Path(out['model_dict_path'])
    assert model == Path('runs/example-train/model.npz') and model.exists()
    rep = _example('reproduction.reproduce').main(
        [str(model), '--epochs', '3', '--n-mols', '10', '--device', 'cpu'])
    assert np.isfinite(rep['results']['best_early_stopping_loss'])
    assert len(cache) == 1
    results = _example('evaluation.evaluate').main(
        [str(model), '--n-mols', '2', '--plots', '', '--device', 'cpu'])
    assert np.isfinite(results['grappa_tpu']['heldout']['rmse_energies'])


def test_example_openmm_wrapper_needs_openmm(monkeypatch):
    monkeypatch.setitem(sys.modules, 'openmm', None)
    with pytest.raises(ImportError):
        _example('usage.openmm_wrapper').main(['--device', 'cpu'])


def test_example_gromacs_script(offline_cache, monkeypatch):
    """Each command of usage/gromacs_wrapper.sh through the port's CLI, on
    a butane topology with a local model file for the tag, on the CPU."""
    from test_gromacs import TOP_TEXT
    from grappa_tpu_torch import cli
    from grappa_tpu_torch.models.grappa_model import (get_small_model_config,
                                                      make_model)
    from grappa_tpu_torch.train.export import (build_model_dict,
                                               save_model_dict)
    cfg = get_small_model_config()
    save_model_dict(build_model_dict(
        make_model(cfg, generator=torch.Generator().manual_seed(0)),
        {'model_config': cfg}), 'model.npz')
    Path('topol.top').write_text(TOP_TEXT)
    script = (EXAMPLES / 'usage' / 'gromacs_wrapper.sh').read_text()
    lines = [line for line in script.replace('\\\n', ' ').splitlines()
             if line.startswith('python')]
    assert len(lines) == 3
    for line in lines:
        argv = shlex.split(line)
        assert argv[:4] == ['python', '-m', 'grappa_tpu_torch.cli', 'gmx']
        argv = ['model.npz' if a == 'grappa-1.2' else a for a in argv[3:]]
        assert cli.main(argv + ['--device', 'cpu']) == 0
    for f in ('topol_grappa.top', 'topol_partial.top', 'parameters.png'):
        assert Path(f).exists(), f
