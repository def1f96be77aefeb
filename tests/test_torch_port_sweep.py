"""The port's hyperparameter sweep (grappa_tpu_torch.train.sweep) against
the JAX package's, on the CPU.

The sampling, the spec encoder, the GP posterior, the expected
improvement and the Bayes suggestion are the same numpy arithmetic on the
same `default_rng` stream in both packages: equal values. `run_sweep` in
both, with each package's `do_trainrun` replaced by one deterministic
objective of the sampled values (one trial raising, one scoring inf),
writes the same trials.jsonl and best.json byte for byte under 'random'
and 'bayes', resumed sweeps included. One real sweep of the port on the
CPU (the small config, 2 trials x 2 epochs) checks the layout, that a
resumed sweep skips its recorded trials without building a Trainer, and
that an infinite loss is written as null.
"""
import json
import math

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu.train import run as jrun
from grappa_tpu.train import sweep as jsweep
from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.data.synthetic import make_dataset
from grappa_tpu_torch.models.grappa_model import get_small_model_config
from grappa_tpu_torch.train import run as trun
from grappa_tpu_torch.train import sweep as tsweep
from grappa_tpu_torch.train.config import default_config

SPEC = {
    'lit_model_config.lr': ('log_uniform', 1e-5, 1e-3),
    'data_config.train_batch_size': ('choice', [16, 32, 64]),
    'model_config.gnn_width': ('choice', [128, 256]),
    'lit_model_config.warmup_steps': ('int_uniform', 10, 500),
    'model_config.gnn_dropout_attention': ('uniform', 0.0, 0.5),
}


def test_sampling_and_surrogate_equal():
    for seed in range(5):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(20):
            for dist in SPEC.values():
                a, b = jsweep.sample_value(rj, dist), tsweep.sample_value(
                    rt, dist)
                assert a == b and type(a) is type(b)
    with pytest.raises(ValueError, match='unknown distribution'):
        tsweep.sample_value(np.random.default_rng(0), ('beta', 1, 2))

    ej, et = jsweep.SpecEncoder(SPEC), tsweep.SpecEncoder(SPEC)
    assert (ej.paths, ej.dim) == (et.paths, et.dim) == (sorted(SPEC), 8)
    rng = np.random.default_rng(1)
    samples = [{p: tsweep.sample_value(rng, d) for p, d in SPEC.items()}
               for _ in range(12)]
    X = np.stack([et.encode(s) for s in samples])
    assert X.tobytes() == np.stack([ej.encode(s) for s in samples]).tobytes()
    y = rng.normal(size=8)
    for fn in (jsweep, tsweep):
        mean, std = fn._gp_posterior(X[:8], y, X[8:])
        ei = fn._expected_improvement(mean, std, y.min())
        if fn is jsweep:
            want = (mean, std, ei)
    for a, b in zip((mean, std, ei), want):
        assert a.tobytes() == b.tobytes()
    assert np.all(std > 0) and np.all(ei >= 0)

    history = [{'params': s, 'early_stopping_loss': float(v)}
               for s, v in zip(samples, np.exp(rng.normal(size=12)))]
    history[3]['early_stopping_loss'] = math.inf
    for n in (0, 1, 5, 12):
        got = tsweep.suggest_bayes(SPEC, history[:n],
                                   np.random.default_rng(n), 64)
        assert got == jsweep.suggest_bayes(SPEC, history[:n],
                                           np.random.default_rng(n), 64)

    config = {'a': {'b': 1}}
    tsweep.set_dotted(config, 'a.b', 2)
    assert config == {'a': {'b': 2}}
    with pytest.raises(KeyError, match='a.c'):
        tsweep.set_dotted(config, 'a.c', 3)
    tree = {'x': [1.0, math.inf, {'y': math.nan}], 'z': (2, -math.inf)}
    assert tsweep._json_safe(tree) == jsweep._json_safe(tree) == \
        {'x': [1.0, None, {'y': None}], 'z': [2, None]}


def _objective(config, project_dir, run_name, **kwargs):
    """A deterministic stand-in for do_trainrun: a loss of the sampled
    values; trial 2 raises and trial 4 scores inf."""
    if run_name == 'trial_002':
        raise RuntimeError('diverged')
    lr = config['lit_model_config']['lr']
    batch = config['data_config']['train_batch_size']
    loss = ((math.log10(lr) + 4.0) ** 2 + batch / 64.0
            + config['model_config']['gnn_dropout_attention'])
    if run_name == 'trial_004':
        loss = math.inf
    return {'results': {'best_early_stopping_loss': loss,
                        'epochs': config['trainer_config']['max_epochs']},
            'run_dir': f'{project_dir}/{run_name}'}


@pytest.mark.parametrize('method', ['random', 'bayes'])
def test_run_sweep_files_equal(tmp_path, monkeypatch, method):
    monkeypatch.setattr(jrun, 'do_trainrun', _objective)
    monkeypatch.setattr(trun, 'do_trainrun', _objective)
    base = default_config()
    best, files = {}, {}
    for pkg, mod, kw in (('jax', jsweep, {}),
                         ('port', tsweep, {'device': 'cpu'})):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        # 4 trials, the same call again (every trial recorded), then
        # resumed to 8
        for k, n in enumerate((4, 4, 8)):
            best[pkg, k] = mod.run_sweep(base, SPEC, n, sweep_dir='sweeps/s',
                                         seed=3, max_epochs=2, method=method,
                                         n_init=2, **kw)
            files[pkg, k] = [(tmp_path / pkg / 'sweeps' / 's' / name)
                             .read_bytes() for name in ('trials.jsonl',
                                                        'best.json')]
    assert files['port', 0] == files['jax', 0]
    assert best['port', 0] == best['jax', 0] and best['port', 0]['run_dir']
    assert files['port', 1] == files['port', 0]
    for k in (1, 2):
        assert files['port', k][0] == files['jax', k][0]
        # a recorded best keeps its run directory in the port's best.json
        # (the JAX package's drops it)
        want = dict(best['jax', k])
        want.setdefault('run_dir', f"sweeps/s/trial_{want['trial']:03d}")
        assert best['port', k] == want
        assert json.loads(files['port', k][1]) == want
    records = [json.loads(line) for line in (
        tmp_path / 'port' / 'sweeps' / 's' / 'trials.jsonl').read_text()
        .splitlines()]
    assert [r['trial'] for r in records] == list(range(8))
    assert records[2]['error'] == 'RuntimeError: diverged'
    assert records[4]['early_stopping_loss'] is None
    assert all(r['epochs'] == 2 for i, r in enumerate(records) if i != 2)
    assert base['trainer_config']['max_epochs'] != 2     # left as it was


def test_port_sweep_on_cpu(tmp_path, monkeypatch):
    data = tmp_path / 'data'
    Dataset.from_moldata(make_dataset(n_mols=6, n_confs=3, seed=4,
                                      atom_range=(6, 12)), 'syn').save(data)
    config = default_config()
    config['model_config'] = get_small_model_config()
    config['data_config'].update(
        datasets=[str(data)], conf_strategy=3, val_conf_strategy=3,
        train_batch_size=2, val_batch_size=2, partition=[0.5, 0.25, 0.25],
        pure_train_datasets=[], pure_val_datasets=[], weights={})
    config['lit_model_config'].update(start_qm_epochs=0, warmup_steps=1)
    config['trainer_config'].update(checkpoint_every=1)
    spec = {'lit_model_config.lr': ('log_uniform', 1e-4, 1e-3),
            'data_config.train_batch_size': ('choice', [1, 2])}
    sweep_dir = tmp_path / 'sweep'
    kw = dict(sweep_dir=str(sweep_dir), seed=0, max_epochs=2,
              method='bayes', n_init=2, device='cpu')
    best = tsweep.run_sweep(config, spec, 2, **kw)
    records = [json.loads(line) for line in
               (sweep_dir / 'trials.jsonl').read_text().splitlines()]
    assert [r['trial'] for r in records] == [0, 1]
    for r in records:
        assert set(r) == {'trial', 'params', 'early_stopping_loss', 'epochs'}
        assert set(r['params']) == set(spec) and r['epochs'] == 2
        assert np.isfinite(r['early_stopping_loss'])
        run = sweep_dir / f"trial_{r['trial']:03d}"
        assert (run / 'model.npz').exists() and (run / 'best.ckpt').is_dir()
        stored = json.loads((run / 'grappa_config.yaml').read_text())
        assert stored['trainer_config']['max_epochs'] == 2
        assert stored['lit_model_config']['lr'] == r['params'][
            'lit_model_config.lr']
    losses = [r['early_stopping_loss'] for r in records]
    assert best['early_stopping_loss'] == min(losses)
    assert best['trial'] == int(np.argmin(losses))
    assert best['run_dir'] == str(sweep_dir / f"trial_{best['trial']:03d}")
    best_json = (sweep_dir / 'best.json').read_text()
    assert json.loads(best_json) == best

    # resumed: the recorded trials build no Trainer and leave the files
    # as they were
    built = []

    def no_trainer(*args, **kwargs):
        built.append(args)
        raise AssertionError('a recorded trial was trained again')

    monkeypatch.setattr(trun, 'Trainer', no_trainer)
    log = (sweep_dir / 'trials.jsonl').read_text()
    again = tsweep.run_sweep(config, spec, 2, **kw)
    assert not built and (sweep_dir / 'trials.jsonl').read_text() == log
    assert again == best and (sweep_dir / 'best.json').read_text() == \
        best_json

    # a third trial scoring inf is written as null and leaves the best
    calls = []

    def inf_run(config, project_dir, run_name, **kwargs):
        calls.append(run_name)
        return {'results': {'best_early_stopping_loss': math.inf,
                            'epochs': 0}, 'run_dir': 'unused'}

    monkeypatch.setattr(trun, 'do_trainrun', inf_run)
    third = tsweep.run_sweep(config, spec, 3, **kw)
    assert calls == ['trial_002'] and not built
    lines = (sweep_dir / 'trials.jsonl').read_text().splitlines()
    assert len(lines) == 3 and 'Infinity' not in lines[2]
    assert json.loads(lines[2])['early_stopping_loss'] is None
    assert third == again
