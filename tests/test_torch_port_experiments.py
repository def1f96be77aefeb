"""The offline accuracy studies on the port (grappa_tpu_torch.experiments)
against the JAX package's drivers under experiments/ on the CPU: the
ablation flags' configs and the ablated architectures' forwards, the
espaloma-proxy splits, molecules, gate and convergence verdicts, the
learning curve's train-molecule counts, the HPO sweep's base config and
suggestions, and a tiny port-only proxy flow (generate, train, a resume
under a session bound, the table and the analysis).

The JAX side runs no training: the drivers are imported through
sys.path, as tests/test_experiments.py imports them, and the model runs
one jitted forward a case. Every output goes under tmp_path.
"""
import dataclasses
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
EXP = REPO / 'experiments'
sys.path.insert(0, str(EXP))

from ablation import run_ablation as jax_run_ablation  # noqa: E402
from ablation import train as jax_ablation  # noqa: E402
from espaloma_proxy import analyze as jax_analyze  # noqa: E402
from espaloma_proxy import run as jax_proxy  # noqa: E402
from espaloma_proxy_xl import run_xl as jax_xl  # noqa: E402
from hpo import run_hpo as jax_hpo  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu.data import MolGraph as JaxMolGraph  # noqa: E402
from grappa_tpu.data import collate as jax_collate  # noqa: E402
from grappa_tpu.data.dataset import Dataset as JaxDataset  # noqa: E402
from grappa_tpu.data.loader import bucketed_pad_spec as jax_pad  # noqa: E402
from grappa_tpu.data.synthetic import make_moldata as jax_make_moldata  # noqa
from grappa_tpu.data.synthetic import random_molecule  # noqa: E402
from grappa_tpu.models import grappa_model as jgm  # noqa: E402
from grappa_tpu.train import sweep as jax_sweep  # noqa: E402
from grappa_tpu.train.torch_compat import stats_from_model  # noqa: E402
from grappa_tpu_torch.data import MolGraph, Molecule, collate  # noqa: E402
from grappa_tpu_torch.data.dataset import Dataset  # noqa: E402
from grappa_tpu_torch.data.loader import bucketed_pad_spec  # noqa: E402
from grappa_tpu_torch.data.synthetic import make_dataset  # noqa: E402
from grappa_tpu_torch.experiments import ablation, hpo, lc  # noqa: E402
from grappa_tpu_torch.experiments import espaloma_proxy as proxy  # noqa
from grappa_tpu_torch.experiments import espaloma_proxy_xl as proxy_xl  # noqa
from grappa_tpu_torch.models import grappa_model as tgm  # noqa: E402
from grappa_tpu_torch.train import sweep  # noqa: E402
from grappa_tpu_torch.train.config import (  # noqa: E402
    default_config, overwrite_config, read_yaml)
from grappa_tpu_torch.weights import state_dict_from_flax  # noqa: E402

FLAGS = ['with_hybridization', 'wrong_symmetry', 'no_positional_encoding',
         'no_param_attention', 'no_gnn_attention', 'no_gnn',
         'no_self_interaction', 'no_gated_torsion', 'harmonic_gate']
# the model test's tolerance at the default width's predict path
RTOL, ATOL = 3e-4, 3e-5
CUTOFF = 1e-4


def _canon(config):
    return json.dumps(config, sort_keys=True)


def _small_config(**data):
    """default_config at the small width, trained briefly on the CPU."""
    config = default_config()
    overwrite_config({
        'model_config': tgm.get_small_model_config(),
        'data_config': dict({'train_batch_size': 2, 'val_batch_size': 4,
                             'test_batch_size': 4}, **data),
        'lit_model_config': {'lr': 2e-4, 'start_qm_epochs': 0,
                             'warmup_steps': 2},
        'trainer_config': {'checkpoint_every': 1},
        'test_model': False,
    }, config)
    return config


# (1) the flags' configs and run names

@pytest.mark.parametrize('argv', [[]] + [[f'--{f}'] for f in FLAGS] + [
    ['--wrong_symmetry', '--no_gnn_attention', '--with_hybridization',
     '--no_gated_torsion', '--epochs', '7', '--pretrain_path', 'm.npz']],
    ids=['none'] + FLAGS + ['combined'])
def test_ablated_config_equals_jax_driver(argv):
    got = ablation.main(argv, dry_run=True)
    want = jax_ablation.main(argv=argv, dry_run=True)
    assert _canon(got) == _canon(want)
    assert got['trainer_config']['name'].startswith('ablation')


@pytest.mark.parametrize('flag', ['no_scaling', 'exp_to_range'])
def test_unimplemented_flags_raise_as_jax(flag):
    with pytest.raises(NotImplementedError):
        jax_ablation.main(argv=[f'--{flag}'], dry_run=True)
    with pytest.raises(NotImplementedError):
        ablation.main([f'--{flag}'], dry_run=True)


# (2) the ablated architectures' forwards on the same weights

def _seeded_params(jmodel, batch, seed=0):
    """Seeded values for every leaf of the flax model's params (their
    shapes traced, not compiled): weights ~ N(0, 1/fan_in), LayerNorm
    scales around 1, the rest around 0, every entry non-zero."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], 'key', '')
        if name == 'kernel':
            v = rng.normal(0, 1 / np.sqrt(leaf.shape[0]), leaf.shape)
        elif name == 'scale':
            v = 1 + rng.normal(0, 0.1, leaf.shape)
        else:
            v = rng.normal(0, 0.1, leaf.shape)
        return jax.numpy.asarray(v, leaf.dtype)

    shapes = jax.eval_shape(jmodel.init, jax.random.key(seed), batch)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize('flags', [
    ['--wrong_symmetry'], ['--no_gnn_attention'], ['--no_param_attention'],
    ['--no_gnn'], ['--no_positional_encoding', '--harmonic_gate']],
    ids=['wrong_symmetry', 'no_gnn_attention', 'no_param_attention',
         'no_gnn', 'no_pos_enc+harmonic_gate'])
def test_ablated_forward_equals_jax(flags):
    base = {'model_config': jgm.get_small_model_config(),
            'trainer_config': {}}
    cfg = ablation.ablated_config(
        json.loads(json.dumps(base)),
        ablation.build_parser().parse_args(flags))['model_config']
    want_cfg = jax_ablation.ablated_config(
        json.loads(json.dumps(base)),
        jax_ablation.build_parser().parse_args(flags))['model_config']
    assert _canon(cfg) == _canon(want_cfg)

    jms = [random_molecule(seed=s, atom_range=(8, 20)) for s in (1, 2, 3)]
    jg = [JaxMolGraph.from_molecule(m) for m in jms]
    tg = [MolGraph.from_molecule(Molecule.from_dict(m.to_dict()))
          for m in jms]
    jb = jax_collate(jg, pad=jax_pad(jg, 1), n_confs=1)
    tb = collate(tg, pad=bucketed_pad_spec(tg, 1), n_confs=1, device='cpu')
    jmodel = jgm.make_model(cfg)
    params = _seeded_params(jmodel, jb)
    want = jax.jit(jmodel.apply)(params, jb)
    tmodel = tgm.make_model(cfg)
    tmodel.load_state_dict(state_dict_from_flax(params, cfg,
                                                stats_from_model(jmodel)),
                           strict=True)
    with torch.no_grad():
        got = tmodel.eval()(tb)
    for key, ref in want.items():
        term = ('n4_improper' if key.startswith('n4_im')
                else key.rsplit('_', 1)[0])
        real = np.asarray(jb.terms[term].mask)
        a, b = got[key].numpy()[real], np.asarray(ref)[real]
        assert a.shape == b.shape and np.isfinite(a).all(), key
        keep = (np.abs(a) > CUTOFF) == (np.abs(b) > CUTOFF)
        assert keep.mean() > 0.99, key
        np.testing.assert_allclose(a[keep], b[keep], rtol=RTOL, atol=ATOL,
                                   err_msg=key)


# (3) the committed splits from the specs' ids alone

@pytest.mark.parametrize('which', ['proxy', 'xl'])
def test_split_from_ids_equals_committed(which):
    study = proxy.PROXY if which == 'proxy' else proxy_xl.XL
    path = study.split_json
    ids = [f'{tag}-{t[1]}' for tag, ts in proxy.tasks(study.specs).items()
           for t in ts]
    assert proxy.build_split(ids) == json.loads(path.read_text())
    assert path.resolve() == (EXP / path.parent.name / path.name).resolve()
    want_specs = (jax_proxy.SPECS if which == 'proxy'
                  else jax_xl.SPECS_XL)
    assert study.specs == want_specs


def test_gates_equal_jax():
    assert proxy.GATE_TARGET == jax_proxy.GATE_TARGET
    assert proxy.GATE_RATCHET == proxy.PROXY.ratchet == jax_proxy.GATE_RATCHET
    assert proxy_xl.GATE_RATCHET_XL == jax_xl.GATE_RATCHET_XL
    assert proxy_xl.XL.ratchet == {**jax_proxy.GATE_RATCHET,
                                   **jax_xl.GATE_RATCHET_XL}


# (4) generate's first molecule of each chemistry

def _same(a, b, where=''):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f'{where}.{f.name}')
    elif hasattr(a, 'to_dict'):
        _same(a.to_dict(), b.to_dict(), where)
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f'{where}[{k}]')
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, where
        if a.dtype.kind in 'fc':
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                       err_msg=where)
        else:
            assert np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize('tag', list(proxy.SPECS))
def test_generated_molecule_equals_jax(tag):
    task = proxy.tasks()[tag][0]
    got = proxy._one_moldata(task)
    _, seed, n_confs, elements, atom_range, cm = task
    want = jax_make_moldata(seed=seed, n_confs=n_confs, ds_name=tag,
                            learnable=True, conf_noise=0.08,
                            charge_model=cm, elements=elements,
                            atom_range=atom_range)
    assert got.mol_id == want.mol_id == f'{tag}-{seed}'
    _same(got, want)


# (5) the table and the gate on the committed results

def test_table_and_gate_equal_jax(tmp_path):
    results = EXP / 'espaloma_proxy' / 'proxy_results.json'
    for side in ('port', 'jax'):
        (tmp_path / side).mkdir()
        shutil.copy(results, tmp_path / side / 'proxy_results.json')
    got = proxy.table(tmp_path / 'port')
    want = jax_proxy.table(out_dir=tmp_path / 'jax')
    assert got == want and got['pass'] and got['target_pass']
    for name in ('gate.json', 'table.md', 'table.tex'):
        assert ((tmp_path / 'port' / name).read_text()
                == (tmp_path / 'jax' / name).read_text()), name


# (6) the convergence verdicts

REGIMES = {
    'descending': (lambda e: 10 ** (-e / 50), lambda e: 10 ** (1 - e / 50),
                   lambda e: 1e-4),
    'generalization': (lambda e: 10 ** (-e / 50),
                       lambda e: 2.0 if e > 30 else 10 - e * 0.25,
                       lambda e: 1e-4),
    'plateau': (lambda e: 3.0, lambda e: 2.0,
                lambda e: 1e-4 if e < 50 else 5e-5),
    'short': (lambda e: 3.0 - e, lambda e: 2.0, lambda e: 1e-4),
}


@pytest.mark.parametrize('regime', list(REGIMES))
def test_analyze_equals_jax(regime, tmp_path):
    train_fn, val_fn, lr_fn = REGIMES[regime]
    n = 3 if regime == 'short' else 100
    with open(tmp_path / 'metrics.jsonl', 'w') as f:
        for e in range(n):
            f.write(json.dumps({'epoch': e, 'time': float(e),
                                'train_loss': train_fn(e),
                                'lr': lr_fn(e)}) + '\n')
            f.write(json.dumps({
                'epoch': e, 'time': e + 0.5,
                'early_stopping_loss': val_fn(e),
                'val_metrics/avg/rmse_energies': val_fn(e),
                'val_metrics/avg/rmse_gradients': val_fn(e)}) + '\n')
    got = proxy.analyze(tmp_path)
    assert got == jax_analyze.analyze(tmp_path)
    assert {'descending': 'still descending',
            'generalization': 'generalization floor',
            'plateau': 'optimization plateau',
            'short': 'insufficient data'}[regime] in got['verdict']


# (7) the learning curve's train-molecule counts

def test_lc_train_molecules_equal_jax_subsampled(tmp_path, monkeypatch):
    ds_dir = tmp_path / 'ds'
    Dataset.from_moldata(make_dataset(n_mols=16, n_confs=2, seed=5,
                                      atom_range=(6, 10)),
                         'syn-lc').save(ds_dir)
    config = _small_config(datasets=[str(ds_dir)], weights={},
                           pure_train_datasets=[], pure_val_datasets=[],
                           conf_strategy=2, val_conf_strategy=2)
    config['trainer_config']['scan_epochs'] = True
    path = tmp_path / 'lc_results.json'
    results = lc.run_lc([1.0, 0.5, 0.25], epochs=1, out_dir=tmp_path,
                        datasets=[str(ds_dir)], results_path=path,
                        config=config, device='cpu')
    split = json.loads((tmp_path / 'runs' / 'lc_1' / 'split.json')
                       .read_text())
    tr = JaxDataset.load(ds_dir).split(split['train'], split['val'],
                                       split['test'])[0]
    for factor in (1.0, 0.5, 0.25):
        entry = results[f'lc_{factor:g}']
        assert entry['train_mols'] == len(tr.subsampled(factor, seed=0))
        assert entry['subsampling_factor'] == factor
        assert 'rmse_energies' in next(iter(entry['test'].values()))
    # recorded factors train nothing
    monkeypatch.setattr(proxy, 'do_trainrun', lambda *a, **k: (
        _ for _ in ()).throw(AssertionError('retrained a recorded factor')))
    again = lc.run_lc([1.0, 0.5, 0.25], epochs=1, out_dir=tmp_path,
                      datasets=[str(ds_dir)], results_path=path,
                      config=config, device='cpu')
    assert again == json.loads(path.read_text())


# (8) the sweep's base config and first suggestions

def test_hpo_base_config_and_suggestions_equal_jax():
    got, want = hpo.build_base_config(150), jax_hpo.build_base_config(150)
    for cfg in (got, want):
        dc = cfg['data_config']
        dc['splitpath'] = str(Path(dc['splitpath']).resolve())
    assert _canon(got) == _canon(want)
    assert hpo.SPEC == jax_hpo.SPEC
    for path in hpo.SPEC:
        sweep.set_dotted(got, path, got[path.split('.')[0]][
            path.split('.')[1]])
    rng = np.random.default_rng(7)
    history = [{'params': {p: sweep.sample_value(rng, d)
                           for p, d in hpo.SPEC.items()},
                'early_stopping_loss': float(10 + 5 * rng.random())}
               for _ in range(6)]
    r_port, r_jax = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        a = sweep.suggest_bayes(hpo.SPEC, history, r_port)
        b = jax_sweep.suggest_bayes(jax_hpo.SPEC, history, r_jax)
        assert a == b
        history.append({'params': a, 'early_stopping_loss': 9.0})


def test_sweep_resumes_a_null_loss(tmp_path):
    """A trial that ended before the recipe's first QM epoch has no
    early-stopping loss: trials.jsonl records null, which a resumed sweep
    and the report read as infinity (the JAX package's run_sweep compares
    None with a float there)."""
    rec = {'trial': 0, 'params': {'lit_model_config.lr': 1e-5},
           'early_stopping_loss': None, 'epochs': 1}
    (tmp_path / 'trials.jsonl').write_text(json.dumps(rec) + '\n')
    with pytest.raises(TypeError):
        jax_sweep.run_sweep({}, {'lit_model_config.lr': ('log_uniform',
                                                         1e-6, 1e-4)},
                            1, sweep_dir=str(tmp_path))
    best = sweep.run_sweep({}, {'lit_model_config.lr': ('log_uniform', 1e-6,
                                                        1e-4)},
                           1, sweep_dir=str(tmp_path), device='cpu')
    assert best['trial'] is None
    scored = hpo.report(out_dir=tmp_path)
    assert [t['early_stopping_loss'] for t in scored] == [float('inf')]


# (9) a tiny port-only proxy flow

TINY_SPECS = {
    'proxy-spice-monomers': (10, 2, 31, [1, 1, 6, 8], (6, 9), 'am1BCC'),
    'proxy-peptide': (10, 2, 33, [1, 1, 6, 7, 8], (6, 9), 'amber99'),
}


def test_tiny_proxy_flow(tmp_path, monkeypatch):
    study = proxy.Study(TINY_SPECS, tmp_path / 'split.json',
                        proxy.GATE_RATCHET, tmp_path)
    # generate refuses a missing split and one unlike the molecules'
    with pytest.raises(FileNotFoundError):
        proxy.generate(workers=4, cache_dir=tmp_path / 'cache', study=study)
    ids = [f'{tag}-{t[1]}' for tag, ts in proxy.tasks(TINY_SPECS).items()
           for t in ts]
    study.split_json.write_text(json.dumps(proxy.build_split(ids[1:])))
    with pytest.raises(RuntimeError):
        proxy.generate(workers=4, cache_dir=tmp_path / 'cache', study=study)
    study.split_json.write_text(json.dumps(proxy.build_split(ids)))
    split = proxy.generate(workers=4, cache_dir=tmp_path / 'cache',
                           study=study)                        # cached
    assert {k: len(v) for k, v in split.items()} == {
        'train': 16, 'val': 2, 'test': 2}
    assert json.loads(study.split_json.read_text()) == split
    config = _small_config()
    summary = proxy.train(epochs=1, out_dir=tmp_path, base_config=config,
                          device='cpu', study=study)
    assert summary['epoch'] == 1 and set(summary['test']) >= set(TINY_SPECS)
    run_yaml = tmp_path / 'runs' / proxy.RUN_NAME / 'grappa_config.yaml'
    stored = read_yaml(run_yaml)
    assert stored['data_config']['weights'] == {}
    assert stored['trainer_config']['scan_epochs'] is True
    assert stored['trainer_config']['async_checkpoints'] is True

    # a resume under a session bound: stored as session_time_limit
    summary = proxy.train(epochs=2, out_dir=tmp_path, base_config=config,
                          time_limit=1.0, device='cpu', study=study)
    stored = read_yaml(run_yaml)
    assert summary['epoch'] == 2 and summary['epochs_run'] == 1
    assert stored['lit_model_config']['session_time_limit'] == 1.0
    assert stored['lit_model_config']['time_limit'] != 1.0
    # a bound that fires at once still finalizes; an unbounded resume
    # clears it and trains on
    summary = proxy.train(epochs=50, out_dir=tmp_path, base_config=config,
                          time_limit=1e-9, device='cpu', study=study)
    assert summary['epoch'] < 50 and summary['test']
    summary = proxy.train(epochs=summary['epoch'] + 1, out_dir=tmp_path,
                          base_config=config, device='cpu', study=study)
    assert read_yaml(run_yaml)['lit_model_config'][
        'session_time_limit'] is None
    assert json.loads((tmp_path / 'proxy_results.json').read_text()) == \
        summary
    gate = json.loads((tmp_path / 'gate.json').read_text())
    assert set(gate['per_dataset']) == set(TINY_SPECS)
    assert (tmp_path / 'table.md').exists()
    out = proxy.write_analysis(tmp_path)
    assert out['verdict'] == 'insufficient data'
    assert out['last_epoch'] == summary['epoch'] - 1
    assert json.loads((tmp_path / 'analysis.json').read_text()) == out

    # the ablation benchmark on the same data: two arms, then a rerun
    # that trains nothing
    results = ablation.run_ablation(
        arms=['baseline', 'wrong_symmetry'], epochs=1,
        out_dir=tmp_path / 'abl', base_config=config,
        datasets=sorted(TINY_SPECS), cache_dir=tmp_path / 'cache',
        device='cpu')
    assert set(results) == {'baseline', 'wrong_symmetry'}
    assert read_yaml(tmp_path / 'abl' / 'runs' / 'abl-wrong_symmetry'
                     / 'grappa_config.yaml')['model_config'][
        'wrong_symmetry'] is True
    assert 'wrong_symmetry' in (tmp_path / 'abl' / 'ablation_table.md'
                                ).read_text()
    monkeypatch.setattr(proxy, 'do_trainrun', lambda *a, **k: (
        _ for _ in ()).throw(AssertionError('retrained a finished arm')))
    assert ablation.run_ablation(
        arms=['baseline', 'wrong_symmetry'], out_dir=tmp_path / 'abl',
        base_config=config, device='cpu') == results
    # the table of both drivers from the same results
    jax_run_ablation.write_table(results, tmp_path / 'jax_table.md')
    assert (tmp_path / 'jax_table.md').read_text() == (
        tmp_path / 'abl' / 'ablation_table.md').read_text()

    # the sweep: two trials, then a resumed call that runs none
    hcfg = json.loads(json.dumps(config))
    hcfg['data_config'].update({'datasets': sorted(TINY_SPECS),
                                'splitpath': str(tmp_path / 'split.json')})
    best = hpo.run_hpo(trials=2, epochs=1, out_dir=tmp_path / 'hpo',
                       base_config=hcfg, method='random',
                       spec={'lit_model_config.lr': ('log_uniform', 1e-4,
                                                     3e-4)},
                       cache_dir=tmp_path / 'cache', device='cpu')
    trials = (tmp_path / 'hpo' / 'trials.jsonl').read_text()
    assert best['trial'] is not None and len(trials.splitlines()) == 2
    hpo.run_hpo(trials=2, epochs=1, out_dir=tmp_path / 'hpo',
                base_config=hcfg, method='random',
                spec={'lit_model_config.lr': ('log_uniform', 1e-4, 3e-4)},
                cache_dir=tmp_path / 'cache', device='cpu')
    assert (tmp_path / 'hpo' / 'trials.jsonl').read_text() == trials
    scored = hpo.report(out_dir=tmp_path / 'hpo')
    assert len(scored) == 2 and (tmp_path / 'hpo' / 'hpo_summary.md').exists()
