"""The port's training run (grappa_tpu_torch.train.run: do_trainrun,
resume_trainrun, safe_trainrun, and the config, export and evaluation
modules it writes through) on the CPU, against the JAX package's files and
readers.

The dataset directory is written by the JAX package's Dataset.save. The
split, the statistics and the config file must equal or read back as the
JAX package's exactly. A model.npz written by either package must load in
the other and predict the same parameters within rtol 3e-4 / atol 3e-5, the
tolerance of the default-config parity test (float32 sums in another
order). Bootstrap CIs are equal for equal per-molecule statistics (both draw
from np.random.default_rng(seed)).
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.dataset import Dataset as JaxDataset
from grappa_tpu.data.loader import bucketed_pad_spec as jax_pad_spec
from grappa_tpu.data.synthetic import make_dataset as jax_make_dataset
from grappa_tpu.models import grappa_model as jgm
from grappa_tpu.statistics import param_statistics_from_graphs
from grappa_tpu.train import config as jconfig
from grappa_tpu.train import eval_model as jeval
from grappa_tpu.train import export as jexport
from grappa_tpu.train import run as jrun
from grappa_tpu_torch.data import MolGraph, collate
from grappa_tpu_torch.data.loader import bucketed_pad_spec
from grappa_tpu_torch.data.molecule import Molecule
from grappa_tpu_torch.models.grappa_model import get_small_model_config
from grappa_tpu_torch.train import config as tconfig
from grappa_tpu_torch.train import eval_model as teval
from grappa_tpu_torch.train import export as texport
from grappa_tpu_torch.train import run as trun
from grappa_tpu_torch.train import trainer as trainer_mod
from grappa_tpu_torch.train.trainer import _write_checkpoint

RTOL, ATOL = 3e-4, 3e-5


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; one intra-op
    thread a worker keeps them from oversubscribing the CPU (this file's
    ops are small, so one thread loses nothing)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(ds_dir, max_epochs=2, **lit):
    config = tconfig.default_config()
    tconfig.overwrite_config({
        'model_config': get_small_model_config(),
        'data_config': {
            'datasets': [str(ds_dir)], 'conf_strategy': 4,
            'val_conf_strategy': 4, 'train_batch_size': 2,
            'val_batch_size': 4, 'partition': [0.6, 0.2, 0.2],
            'pure_train_datasets': [], 'pure_val_datasets': [],
            'weights': {}, 'seed': 3,
        },
        'lit_model_config': dict({'lr': 2e-4, 'start_qm_epochs': 1,
                                  'warmup_steps': 2}, **lit),
        'trainer_config': {'max_epochs': max_epochs, 'checkpoint_every': 1,
                           'name': 'run'},
        'test_model': True,
    }, config)
    return config


@pytest.fixture(scope='module')
def ds_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp('data') / 'syn'
    JaxDataset.from_moldata(jax_make_dataset(n_mols=10, n_confs=4, seed=5),
                            'syn').save(path)
    return path


@pytest.fixture(scope='module')
def run(ds_dir, tmp_path_factory):
    project = tmp_path_factory.mktemp('runs')
    out = trun.do_trainrun(_config(ds_dir), project_dir=str(project),
                           device='cpu')
    return out, Path(out['run_dir']), project


def _predict_batch(seeds=(21, 22, 23)):
    from grappa_tpu.data.synthetic import random_molecule
    jms = [random_molecule(seed=s) for s in seeds]
    jg = [JaxMolGraph.from_molecule(m) for m in jms]
    tg = [MolGraph.from_molecule(Molecule.from_dict(m.to_dict())) for m in jms]
    return (jax_collate(jg, pad=jax_pad_spec(jg, 1), n_confs=1),
            collate(tg, pad=bucketed_pad_spec(tg, 1), n_confs=1,
                    device='cpu'))


def _close(got, want):
    for key, w in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def test_do_trainrun_writes_the_run(run, ds_dir, tmp_path):
    out, run_dir, _ = run
    trainer = out['trainer']
    assert trainer.epoch == 2 and trainer.device.type == 'cpu'
    # split.json as the JAX package's get_dataloaders writes it
    jax_dir = tmp_path / 'jax'
    jax_dir.mkdir()
    jtl, _, _, jsplit = jrun.get_dataloaders(
        jconfig.normalize_reference_config(
            json.loads((run_dir / 'grappa_config.yaml').read_text()),
            verbose=False)['data_config'], jax_dir)
    assert json.loads((run_dir / 'split.json').read_text()) == \
        json.loads((jax_dir / 'split.json').read_text()) == jsplit
    stats = json.loads((run_dir / 'param_statistics.json').read_text())
    want = param_statistics_from_graphs(jtl.dataset.graphs())
    for m in ('mean', 'std'):
        for k, v in want[m].items():
            np.testing.assert_array_equal(np.asarray(stats[m][k], np.float32),
                                          v, err_msg=f'{m}/{k}')
    lines = [json.loads(l) for l in
             (run_dir / 'metrics.jsonl').read_text().splitlines()]
    assert [l['epoch'] for l in lines if 'train_loss' in l] == [0, 1]
    assert any('val_metrics/syn/rmse_energies' in l for l in lines)
    assert np.all(np.isfinite([l['train_loss'] for l in lines
                               if 'train_loss' in l]))
    for name in ('best.ckpt', 'last.ckpt'):
        trainer_mod._verify_checkpoint(run_dir / name)
    assert (run_dir / 'last.ckpt' / 'opt_state.pt').exists()
    test = texport.load_model_dict(out['model_dict_path'])['results']['test']
    assert test['syn']['n_mols'] == len(jsplit['test'])
    assert 'rmse_energies_ci' in test['syn']


def test_config_file_reads_in_both_packages(run):
    _, run_dir, _ = run
    path = run_dir / 'grappa_config.yaml'
    json.loads(path.read_text())   # the port writes JSON
    assert jconfig.read_yaml(path) == tconfig.read_yaml(path)
    assert tconfig.read_yaml(path)['trainer_config']['max_epochs'] == 2
    # a YAML file that is not JSON goes through yaml
    yml = run_dir.parent / 'other.yaml'
    jconfig.write_yaml(jconfig.default_config(), yml)
    assert tconfig.read_yaml(yml) == jconfig.read_yaml(yml)


def test_model_npz_loads_in_both_packages(run):
    """The port's model.npz through the JAX package's load_model_dict /
    model_from_dict, and a JAX-written model.npz through the port's: the
    same predictions as the writer's model."""
    out, run_dir, _ = run
    jb, tb = _predict_batch()
    md = jexport.load_model_dict(out['model_dict_path'])
    jmodel, jparams, _ = jexport.model_from_dict(md)
    model, _ = texport.model_from_dict(
        texport.load_model_dict(out['model_dict_path']))
    with torch.no_grad():
        want = model.eval()(tb)
    _close({k: v.numpy() for k, v in want.items()},
           jax.jit(jmodel.apply)(jparams, jb))
    # ... the exported weights are best.ckpt's
    best = torch.load(run_dir / 'best.ckpt' / 'params.pt', weights_only=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, best[k]), k

    cfg = jgm.get_small_model_config()
    jm = jgm.make_model(cfg)
    params = jax.jit(jm.init)(jax.random.key(2), jb)
    d = jexport.build_model_dict(params, {'model_config': cfg}, model=jm)
    for suffix in ('npz', 'pth'):
        path = run_dir.parent / f'jax_model.{suffix}'
        jexport.save_model_dict(d, path)
        port_model, _ = texport.model_from_dict(texport.load_model_dict(path))
        with torch.no_grad():
            got = port_model.eval()(tb)
        _close({k: v.numpy() for k, v in got.items()},
               jax.jit(jm.apply)(params, jb))
    # and the port's .pth in the JAX package
    pth = run_dir.parent / 'port_model.pth'
    texport.save_model_dict(texport.load_model_dict(out['model_dict_path']),
                            pth)
    jm2, jp2, _ = jexport.model_from_dict(jexport.load_model_dict(pth))
    _close({k: v.numpy() for k, v in want.items()},
           jax.jit(jm2.apply)(jp2, jb))


def test_bootstrap_evaluator_matches_jax():
    rng = np.random.default_rng(0)
    stats = [{k: float(rng.uniform(0.5, 2.0)) for k in teval._ACC_KEYS}
             for _ in range(7)]
    jev, tev = jeval.BootstrapEvaluator(), teval.BootstrapEvaluator()
    for i, s in enumerate(stats):
        name = 'a' if i < 4 else 'b'
        jev.add_molecule(name, **s)
        tev.add_molecule(name, **s)
    assert tev.pool(n_bootstrap=100, seed=4) == \
        jev.pool(n_bootstrap=100, seed=4)


def test_resume_epochs_and_elapsed_time(run):
    out, run_dir, _ = run
    meta = json.loads((run_dir / 'last.ckpt' / 'meta.json').read_text())
    t1 = meta['elapsed_time']
    assert meta['epoch'] == 2 and t1 > 0.0
    # max_epochs already reached: the resume trains nothing
    out2 = trun.resume_trainrun(str(run_dir), device='cpu')
    assert out2['trainer'].epoch == 2
    out3 = trun.resume_trainrun(str(run_dir), extra_epochs=1, device='cpu',
                                cache_batches=True)
    assert out3['trainer'].epoch == 3
    meta3 = json.loads((run_dir / 'last.ckpt' / 'meta.json').read_text())
    assert meta3['epoch'] == 3 and meta3['elapsed_time'] > t1
    # the resume is pinned to the run's split
    assert out3['trainer'].full_config['data_config']['splitpath'] == \
        str(run_dir / 'split.json')
    assert texport.load_model_dict(out3['model_dict_path'])['results']['test']


def test_finalize_exports_best_and_falls_back(run, ds_dir, tmp_path):
    """A zeroed best.ckpt is what the export carries; a torn one falls
    back to the last weights."""
    project = tmp_path / 'runs'
    out = trun.do_trainrun(_config(ds_dir, max_epochs=2),
                           project_dir=str(project), device='cpu')
    run_dir = Path(out['run_dir'])
    best = run_dir / 'best.ckpt'
    sd = torch.load(best / 'params.pt', weights_only=True)
    zero = {k: (torch.zeros_like(v) if k.startswith('gnn.')
                and k.endswith('.weight') else v) for k, v in sd.items()}
    _write_checkpoint(best, zero, None,
                      json.loads((best / 'meta.json').read_text()))
    out2 = trun.resume_trainrun(str(run_dir), device='cpu')
    exported = texport.load_model_dict(out2['model_dict_path'])['state_dict']
    weights = [k for k in exported if k.startswith('gnn.')
               and k.endswith('.weight')]
    assert weights and all(np.all(exported[k] == 0) for k in weights)
    (best / 'params.pt').write_bytes(b'torn')
    out3 = trun.resume_trainrun(str(run_dir), device='cpu')
    exported = texport.load_model_dict(out3['model_dict_path'])['state_dict']
    last = out3['trainer'].model.state_dict()
    assert all(np.array_equal(exported[k], last[k].numpy()) for k in last)


def test_safe_trainrun_recovers_from_a_crash(ds_dir, tmp_path, monkeypatch):
    real_fit = trainer_mod.Trainer.fit
    calls = {'n': 0}

    def crashing_fit(self, max_epochs=None):
        calls['n'] += 1
        if calls['n'] == 1:      # die mid-run, after a checkpoint
            self.train_epoch()
            self.epoch += 1
            self.save_checkpoint(self.out_dir / 'last.ckpt')
            raise RuntimeError('injected crash')
        return real_fit(self, max_epochs)

    monkeypatch.setattr(trainer_mod.Trainer, 'fit', crashing_fit)
    out = trun.safe_trainrun(_config(ds_dir, max_epochs=3),
                             project_dir=str(tmp_path / 'runs'),
                             device='cpu')
    assert calls['n'] == 2 and out['trainer'].epoch == 3
    assert np.isfinite(out['results']['best_early_stopping_loss'])
    # a run with a dataset_override is not resumed
    calls['n'] = 0
    from grappa_tpu_torch.data.dataset import Dataset
    with pytest.raises(RuntimeError, match='injected'):
        trun.safe_trainrun(_config(ds_dir), project_dir=str(tmp_path / 'o'),
                           dataset_override=Dataset.load(ds_dir),
                           device='cpu')


def test_pretrain_path_and_dataset_override(run, ds_dir, tmp_path):
    out, _, _ = run
    config = _config(ds_dir, max_epochs=0)
    warm = trun.do_trainrun(config, project_dir=str(tmp_path / 'runs'),
                            run_name='warm',
                            pretrain_path=out['model_dict_path'],
                            device='cpu')
    assert config['lit_model_config']['start_qm_epochs'] == 0
    src = texport.load_model_dict(out['model_dict_path'])['state_dict']
    got = texport.load_model_dict(warm['model_dict_path'])['state_dict']
    assert src.keys() == got.keys()
    assert all(np.array_equal(src[k], got[k]) for k in src)
    bad = _config(ds_dir, max_epochs=1)
    bad['model_config']['gnn_width'] = 32
    with pytest.raises(ValueError, match='shape mismatch'):
        trun.do_trainrun(bad, project_dir=str(tmp_path / 'runs'),
                         run_name='bad', pretrain_path=out['model_dict_path'],
                         device='cpu')
    from grappa_tpu_torch.data.dataset import Dataset
    over = trun.do_trainrun(_config(ds_dir, max_epochs=1),
                            project_dir=str(tmp_path / 'runs'),
                            run_name='over',
                            dataset_override=Dataset.load(ds_dir),
                            device='cpu')
    assert over['trainer'].epoch == 1
    assert 'test' not in (texport.load_model_dict(
        over['model_dict_path']).get('results') or {})


def test_entry_points_run_on_the_card_unless_asked(ds_dir, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for call in (lambda: trun.do_trainrun(_config(ds_dir),
                                          project_dir=str(tmp_path)),
                 lambda: trun.resume_trainrun(str(tmp_path / 'run'))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    from grappa_tpu_torch import zoo
    monkeypatch.setenv('GRAPPA_TPU_CACHE', str(tmp_path / 'cache'))
    with pytest.raises(RuntimeError, match='no-such-tag'):
        zoo.dataset_path_from_tag('no-such-tag')
    (tmp_path / 'cache' / 'datasets' / 'local').mkdir(parents=True)
    assert zoo.dataset_path_from_tag('local') == \
        tmp_path / 'cache' / 'datasets' / 'local'
