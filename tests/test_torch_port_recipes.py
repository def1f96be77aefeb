"""The published training recipes on the port (grappa_tpu_torch.production)
against the JAX package's experiments/production_driver.py on the CPU: the
config each recipe and flag set gives, the recipe's dataset routing (the
stored split and its extension, pure train / test sets, subsampling,
weighted draws) and loss-weight schedule, and a micro rehearsal of the
grappa-1.2.1 recipe at the small width (tests/test_production_recipes.py's
rehearsal, which is marked slow there, on the port).

Stand-in datasets: make_dataset molecules, whose classical proper ks are
6 wide as the published datasets' are, saved under the recipe's own tags
in a temporary GRAPPA_TPU_CACHE; the espaloma_split tag covers only part
of them. They draw random classical parameters (learnable=True would
minimise each molecule's geometry, ~1 s a molecule on the CPU). Downloads
are patched to raise.
"""
import json
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
EXP = REPO / 'experiments'
sys.path.insert(0, str(EXP))
from production_driver import run_production as jax_run_production  # noqa

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu import zoo as jzoo  # noqa: E402
from grappa_tpu.train import run as jrun  # noqa: E402
from grappa_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from grappa_tpu_torch import production, zoo  # noqa: E402
from grappa_tpu_torch.data.dataset import Dataset  # noqa: E402
from grappa_tpu_torch.data.synthetic import make_dataset  # noqa: E402
from grappa_tpu_torch.train import run as trun  # noqa: E402
from grappa_tpu_torch.train.trainer import Trainer  # noqa: E402

V121 = EXP / 'train-grappa-1.2.1'
FLAG_SETS = [
    ('1.0', []), ('1.0', ['-p', '0.001']),
    ('1.0', ['-tb', '16', '-vb', '8', '-p', '0.01']),
    ('1.1', []), ('1.1', ['-b', '--n_periodicity', '6']),
    ('1.2', []), ('1.2', ['-p', '0.1', '--shrink_train', '0.25']),
    ('1.2.1', []), ('1.2.1', ['-b']),
    ('1.2.1', ['-p', '0.001', '--shrink_train', '0.5', '--n_periodicity',
               '4', '--no_torsion_cutoff']),
    ('1.2.1', ['-tb', '16', '-p', '0.01', '-b', '--shrink_train', '0.5',
               '--n_periodicity', '6', '--no_torsion_cutoff']),
    ('1.2.1', ['--pretrain_path', 'pretrained/model.npz']),
    ('1.2.1', ['-b', 'local_split']),
]


def _no_download(url, target):
    raise RuntimeError(f'no network in tests: {url}')


def _canon(config):
    # type-aware: 3 and 3.0 differ
    return json.dumps(config, sort_keys=True)


@pytest.mark.parametrize('version,flags', FLAG_SETS, ids=[
    f"{v}:{' '.join(f) or 'defaults'}" for v, f in FLAG_SETS])
def test_dry_run_config_equals_jax_driver(version, flags, tmp_path):
    """Both drivers on the recipe yaml in place; 'local_split' copies the
    yaml beside an espaloma_split.json."""
    config_dir = EXP / f'train-grappa-{version}'
    if 'local_split' in flags:
        flags = [f for f in flags if f != 'local_split']
        shutil.copy(config_dir / 'grappa_config.yaml', tmp_path)
        (tmp_path / 'espaloma_split.json').write_text('{"train": []}')
        config_dir = tmp_path
    v1_0 = version == '1.0'
    want = jax_run_production(config_dir, f'grappa-{version}', argv=flags,
                              v1_0=v1_0, dry_run=True)
    got = production.run_production(config_dir, f'grappa-{version}',
                                    argv=flags, v1_0=v1_0, dry_run=True)
    assert _canon(got) == _canon(want)
    if v1_0:
        for run in (jax_run_production, production.run_production):
            with pytest.raises(SystemExit):
                run(config_dir, 'grappa-1.0', argv=['-b'], v1_0=True,
                    dry_run=True)


@pytest.fixture(scope='module')
def stand_ins(tmp_path_factory):
    """Two molecules x two conformers under every tag of the 1.2.1 recipe
    and an espaloma_split tag over the first two tags' molecules."""
    cache = tmp_path_factory.mktemp('cache')
    config = production.run_production(V121, 'grappa-1.2.1', argv=[],
                                       dry_run=True)
    dcfg = config['data_config']
    tags = (dcfg['datasets'] + dcfg['pure_train_datasets']
            + dcfg['pure_test_datasets'])
    ids = {}
    for i, tag in enumerate(tags):
        ds = Dataset.from_moldata(make_dataset(
            n_mols=2, n_confs=2, seed=300 + i, atom_range=(6, 14)), tag)
        ds.save(cache / 'datasets' / tag)
        ids[tag] = ds.mol_ids
    covered = ids[tags[0]] + ids[tags[1]]
    split_dir = cache / 'datasets' / 'espaloma_split'
    split_dir.mkdir(parents=True)
    (split_dir / 'split.json').write_text(json.dumps(
        {'train': covered[:2], 'val': covered[2:3], 'test': covered[3:4]}))
    return cache, config, ids, covered


@pytest.fixture
def in_cache(stand_ins, monkeypatch):
    monkeypatch.setenv('GRAPPA_TPU_CACHE', str(stand_ins[0]))
    monkeypatch.setattr(zoo, '_download', _no_download)
    monkeypatch.setattr(jzoo, '_download', _no_download)
    return stand_ins


@pytest.mark.parametrize('shrink', [None, 0.5], ids=['all', 'shrink50'])
def test_routing_and_weighted_draws_equal_jax(in_cache, shrink, tmp_path):
    _, config, ids, covered = in_cache
    dcfg = dict(config['data_config'], tr_subsampling_factor=shrink,
                train_batch_size=4, val_batch_size=4)
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    want = jrun.get_dataloaders(dict(dcfg), tmp_path / 'jax')
    got = trun.get_dataloaders(dict(dcfg), tmp_path / 'port', device='cpu')
    split = json.loads((tmp_path / 'port' / 'split.json').read_text())
    assert split == json.loads((tmp_path / 'jax' / 'split.json').read_text())
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dataset.mol_ids == w.dataset.mol_ids
        assert g.dataset.ds_names == w.dataset.ds_names

    # the recipe's routing, on the port's loaders
    train, val, test = (set(x.dataset.mol_ids) for x in got[:3])
    assert set(covered[:2]) <= set(split['train'])
    assert covered[2] in split['val'] and covered[3] in split['test']
    in_split = {i for t in dcfg['datasets'] for i in ids[t]}
    assert in_split == set(split['train']) | set(split['val']) | set(
        split['test'])
    for tag in dcfg['pure_train_datasets']:
        in_train = set(ids[tag]) & train
        assert in_train and not set(ids[tag]) & (val | test)
        if shrink is None:
            assert in_train == set(ids[tag])
    for tag in dcfg['pure_test_datasets']:
        assert set(ids[tag]) <= test and not set(ids[tag]) & (train | val)
    n_train = len(set(split['train'])) + 2
    assert len(train) == (n_train if shrink is None else int(n_train / 2))

    # the first epoch's weighted draws (sampling weights, then the epoch's
    # batches and their subdataset names)
    tl, jl = got[0], want[0]
    np.testing.assert_allclose(tl._sample_weights, jl._sample_weights,
                               rtol=1e-15)
    assert [names for _, names in tl] == [names for _, names in jl]
    assert got[2].fixed_pad and len(got[2]) == len(want[2])


def test_loss_weights_schedule_equals_jax():
    """_loss_weights over epochs 0-4, unbound on a stub (no model), for
    the recipe with -p, cut to param_loss_epochs 3 and as published, and
    with --pretrain_path."""
    names = ['spice-pubchem', 'spice-dipeptide_amber99sbildn', 'gen2',
             'hyp-dop_amber99sbildn', 'rna-nucleoside']
    for argv, cut in ((['-p', '0.001'], 3), (['-p', '0.01'], None),
                      (['--pretrain_path', 'm.npz'], None)):
        lit = production.run_production(
            V121, 'grappa-1.2.1', argv=argv, dry_run=True)['lit_model_config']
        if cut is not None:
            lit['param_loss_epochs'] = cut
        for epoch in range(5):
            common = dict(cfg=lit, epoch=epoch,
                          start_qm_epochs=lit['start_qm_epochs'])
            got = Trainer._loss_weights(types.SimpleNamespace(
                device=torch.device('cpu'), **common), names, len(names))
            want = JaxTrainer._loss_weights(types.SimpleNamespace(**common),
                                            names, len(names))
            for field in ('energy', 'gradient', 'proper_reg',
                          'improper_reg'):
                assert float(getattr(got, field)) == float(
                    getattr(want, field)), (argv, epoch, field)
            np.testing.assert_array_equal(got.param.numpy(),
                                          np.asarray(want.param))
        if cut == 3:     # epoch 4: switched off, the overrides kept
            np.testing.assert_array_equal(
                got.param.numpy(), np.float32([0, 1e-3, 0, 1e-3, 0]))


def test_micro_rehearsal_1_2_1(in_cache, tmp_path):
    """The 1.2.1 recipe end to end through run_production on the CPU at the
    small width, with the recipe's periodicity 3 and torsion cutoff against
    the stand-ins' 6-wide ks: param-only epoch 0, QM epoch 1."""
    from grappa_tpu_torch.models.grappa_model import get_small_model_config
    from grappa_tpu_torch.train.export import load_model_dict
    _, config, ids, covered = in_cache
    small = get_small_model_config()
    for key in ('n_periodicity_proper', 'n_periodicity_improper',
                'torsion_cutoff', 'gated_torsion'):
        small[key] = config['model_config'][key]
    assert (small['n_periodicity_proper'], small['torsion_cutoff']) == (
        3, 1e-4)
    cuts = {'model_config': small,
            'data_config': {'conf_strategy': 2, 'val_conf_strategy': 2,
                            'train_batch_size': 4, 'val_batch_size': 4},
            'lit_model_config': {'start_qm_epochs': 1, 'warmup_steps': 2,
                                 'param_loss_epochs': 2},
            'trainer_config': {'max_epochs': 2}}
    out = production.run_production(
        V121, 'grappa-1.2.1', argv=['--project', str(tmp_path)],
        device='cpu', overrides=cuts)
    run_dir = Path(out['run_dir'])
    assert run_dir == tmp_path / 'grappa-1.2.1'
    trainer = out['trainer']
    assert trainer.epoch == 2 and trainer.restarts == [1, 2]
    assert all(np.isfinite(sum(trainer.train_losses, [])))
    split = json.loads((run_dir / 'split.json').read_text())
    assert set(covered[:2]) <= set(split['train'])
    in_split = {i for t in config['data_config']['datasets'] for i in ids[t]}
    assert in_split <= set(split['train']) | set(split['val']) | set(
        split['test'])
    md = load_model_dict(out['model_dict_path'])
    k = md['state_dict']['parameter_writer.proper_writer.k_mean']
    assert np.asarray(k).shape[-1] == 3
    assert md['results']['test']


def test_main_passes_the_recipe_flags(monkeypatch, capsys):
    """`python -m grappa_tpu_torch.production <dir> <version> [--v1_0]
    [--device D] [recipe flags]`: the recipe flags reach run_production's
    parser untouched."""
    seen = {}

    def fake(config_dir, version, argv=None, v1_0=False, device=None):
        seen.update(config_dir=config_dir, version=version, argv=argv,
                    v1_0=v1_0, device=device)
        return {'model_dict_path': 'm.npz', 'run_dir': 'r'}

    monkeypatch.setattr(production, 'run_production', fake)
    assert production.main([str(V121), 'grappa-1.2.1', '-p', '0.001',
                            '--device', 'cpu', '--shrink_train', '0.5']) == 0
    assert seen == dict(config_dir=str(V121), version='grappa-1.2.1',
                        argv=['-p', '0.001', '--shrink_train', '0.5'],
                        v1_0=False, device='cpu')
    production.main(['experiments/train-grappa-1.0', 'grappa-1.0', '--v1_0'])
    assert seen['v1_0'] and seen['argv'] == [] and seen['device'] is None
    assert 'm.npz' in capsys.readouterr().out
