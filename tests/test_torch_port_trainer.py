"""The port's Trainer (grappa_tpu_torch.train.trainer) against the JAX
package's on the CPU, and its checkpoints.

Both packages start from JAX's initial params of the small config (dropout
0), carried across with `state_dict_from_flax`, and train on the same
make_dataset molecules through loaders that draw the same batches
(cache_batches off: the batch order is the loaders' numpy draw). Without
dropout nothing else draws randomness, so the runs are the same run in two
frameworks.

Tolerances: the LR sequence, the restart / phase switches, the plateau
decisions and the best epoch are decisions and must be equal. Per-epoch
train losses and validation metrics rtol 2e-4: float32 sums in another
order through a double backward give 1e-6 on a step's loss (the one-step
test's 1e-5), and Adam moves an entry whose gradient is near 0 by about
+-lr in either framework's direction (tests/test_torch_port_train.py), so
after 8 steps at lr 1e-4 the weights differ by a few 1e-4 of lr-sized
moves. Checkpoint round trips are exact.
"""
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from grappa_tpu.data.dataset import Dataset as JaxDataset
from grappa_tpu.data.loader import GraphLoader as JaxGraphLoader
from grappa_tpu.data.synthetic import make_dataset as jax_make_dataset
from grappa_tpu.models import grappa_model as jgm
from grappa_tpu.statistics import param_statistics_from_graphs
from grappa_tpu.train import trainer as jtrainer_mod
from grappa_tpu.train.torch_compat import stats_from_model
from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.data.loader import GraphLoader
from grappa_tpu_torch.data.moldata import MolData
from grappa_tpu_torch.models import grappa_model as tgm
from grappa_tpu_torch.train import trainer as trainer_mod
from grappa_tpu_torch.train.trainer import Trainer
from grappa_tpu_torch.weights import state_dict_from_flax

RTOL = 2e-4
LR = 1e-4
LIT = {'lr': LR, 'start_qm_epochs': 1, 'add_restarts': [2],
       'warmup_steps': 2, 'patience': 1, 'lr_decay': 0.5,
       'energy_weight': 1.0, 'gradient_weight': 0.8, 'param_weight': 1e-3,
       'proper_regularisation': 1e-3, 'improper_regularisation': 1e-3,
       'param_weights_by_dataset': {'b': 1e-2}}
EPOCHS = 4


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; one intra-op
    thread a worker keeps them from oversubscribing the CPU (this file's
    ops are small, so one thread loses nothing)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split_data():
    mds = (jax_make_dataset(n_mols=6, n_confs=4, seed=1, ds_name='a')
           + jax_make_dataset(n_mols=4, n_confs=4, seed=2, ds_name='b'))
    names = ['a'] * 6 + ['b'] * 4
    tr = [0, 1, 2, 3, 6, 7]
    vl = [4, 5, 8, 9]
    pick = lambda idx: ([mds[i] for i in idx], [names[i] for i in idx])
    return pick(tr), pick(vl)


def _loaders(jax_side, tr, vl):
    if jax_side:
        return (JaxGraphLoader(JaxDataset(*tr), batch_size=3, conf_strategy=4,
                               shuffle=True, seed=0, drop_last=True),
                JaxGraphLoader(JaxDataset(*vl), batch_size=2, conf_strategy=4,
                               shuffle=False, fixed_pad=True))
    port = lambda d: Dataset([MolData.from_dict(m.to_dict()) for m in d[0]],
                             d[1])
    return (GraphLoader(port(tr), batch_size=3, conf_strategy=4, shuffle=True,
                        seed=0, drop_last=True, device='cpu'),
            GraphLoader(port(vl), batch_size=2, conf_strategy=4,
                        shuffle=False, fixed_pad=True, device='cpu'))


def _record_lrs(trainer, lr_index):
    """Wrap the trainer's step to record the LR of every step, as the
    float32 the step applies."""
    lrs, step = [], trainer.train_step

    def wrapped(*args):
        lrs.append(float(np.float32(args[lr_index])))
        return step(*args)
    trainer.train_step = wrapped
    return lrs


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The same EPOCHS-epoch fit in both packages."""
    tr, vl = _split_data()
    cfg = jgm.get_small_model_config()
    jtl, jvl = _loaders(True, tr, vl)
    stats = param_statistics_from_graphs(jtl.dataset.graphs())
    jmodel = jgm.make_model(cfg, stats)
    batch, _ = next(iter(jtl))
    params = jax.device_get(jax.jit(jmodel.init)(jax.random.key(0), batch))
    out = tmp_path_factory.mktemp('trainer')

    jt = jtrainer_mod.Trainer(jmodel, params, jtl, jvl, dict(LIT),
                              {'checkpoint_every': 1}, seed=0,
                              out_dir=str(out / 'jax'))
    jlrs = _record_lrs(jt, 4)
    jlog = []
    jt.log_fn = jlog.append
    jt.fit(max_epochs=EPOCHS)

    ptl, pvl = _loaders(False, tr, vl)
    next(iter(ptl))   # the JAX side's init batch took one epoch order
    model = tgm.make_model(cfg, stats)
    model.load_state_dict(state_dict_from_flax(params, cfg,
                                               stats_from_model(jmodel)))
    pt = Trainer(model, ptl, pvl, dict(LIT), {'checkpoint_every': 1}, seed=0,
                 out_dir=str(out / 'port'))
    plrs = _record_lrs(pt, 2)
    plog = []
    pt.log_fn = plog.append
    pt.fit(max_epochs=EPOCHS)
    return dict(jt=jt, pt=pt, jlrs=jlrs, plrs=plrs, jlog=jlog, plog=plog,
                out=out, tr=tr, vl=vl, cfg=cfg, stats=stats)


def test_losses_and_val_metrics_match_jax(runs):
    jlog, plog = runs['jlog'], runs['plog']
    jtrain = [r['train_loss'] for r in jlog if 'train_loss' in r]
    ptrain = [r['train_loss'] for r in plog if 'train_loss' in r]
    assert len(ptrain) == len(jtrain) == EPOCHS
    np.testing.assert_allclose(ptrain, jtrain, rtol=RTOL)
    # the phase switch: epoch 0 trains on the parameter loss alone
    assert ptrain[0] < 1e-2 * ptrain[1] and jtrain[0] < 1e-2 * jtrain[1]
    assert sorted(plog[0]) == sorted(jlog[0])
    jval = [r for r in jlog if 'val_metrics' in r]
    pval = [r for r in plog if 'val_metrics' in r]
    for p, j in zip(pval, jval):
        assert sorted(p) == sorted(j)
        assert p['val_metrics'].keys() == j['val_metrics'].keys() == \
            {'a', 'b', 'avg'}
        for ds, m in j['val_metrics'].items():
            for key, v in m.items():
                np.testing.assert_allclose(p['val_metrics'][ds][key], v,
                                           rtol=RTOL, err_msg=f'{ds}/{key}')
        np.testing.assert_allclose(p['early_stopping_loss'],
                                   j['early_stopping_loss'], rtol=RTOL)


def test_lr_sequence_restarts_and_best_epoch_match_jax(runs):
    """Restarts at epochs 1 (start_qm_epochs) and 2 (add_restarts) reset
    Adam and warm the LR up over 2 steps; 2 steps an epoch."""
    jt, pt = runs['jt'], runs['pt']
    assert runs['plrs'] == runs['jlrs']
    assert runs['plrs'][:6] == [float(np.float32(x)) for x in (
        LR, LR, 0.0, LR / 2, 0.0, LR / 2)]
    assert pt.global_step == jt.global_step == 2 * EPOCHS
    assert pt.lr == jt.lr
    assert pt.epoch == jt.epoch == EPOCHS
    assert pt._best_snapshot[1] == jt._best_snapshot[1]
    np.testing.assert_allclose(pt.best_loss, jt.best_loss, rtol=RTOL)
    assert pt.epochs_without_improvement == jt.epochs_without_improvement
    for name in ('best.ckpt', 'last.ckpt'):
        pmeta = json.loads((runs['out'] / 'port' / name / 'meta.json')
                           .read_text())
        jmeta = json.loads((runs['out'] / 'jax' / name / 'meta.json')
                           .read_text())
        assert sorted(pmeta) == sorted(jmeta)
        assert pmeta['epoch'] == jmeta['epoch']
        assert pmeta['global_step'] == jmeta['global_step']


def _scripted(trainer, monkeypatch, mod, losses):
    monkeypatch.setattr(trainer, 'train_epoch', lambda: None)
    monkeypatch.setattr(trainer, 'validate',
                        lambda: {'es': losses[trainer.epoch]})
    monkeypatch.setattr(mod, 'early_stopping_loss',
                        lambda metrics, w: metrics['es'])
    saves, real = [], trainer.save_checkpoint
    monkeypatch.setattr(
        trainer, 'save_checkpoint',
        lambda path, include_opt_state=True, **kw: (
            saves.append((trainer.epoch, losses[trainer.epoch])) or True
            if str(path).endswith('best.ckpt')
            else real(path, include_opt_state, **kw)))
    lrs = []
    monkeypatch.setattr(trainer, 'log_fn', lambda d: lrs.append(trainer.lr)
                        if 'val_metrics' in d else None)
    return saves, lrs


def test_plateau_decay_decisions_match_jax(tmp_path, monkeypatch):
    """Scripted early-stopping losses (tests/test_training.py's plateau
    test, longer): the same LR decays, best saves and baselines."""
    import jax.numpy as jnp
    losses = [10.0, 12.0, 13.0, 11.0, 9.0, 9.5, 9.7, 9.6, 8.0, 8.5, 8.4]
    lit = {'lr': 1e-3, 'start_qm_epochs': 0, 'patience': 1, 'lr_decay': 0.5}
    jt = jtrainer_mod.Trainer(model=None, params={'w': jnp.zeros(1)},
                              train_loader=None, val_loader=None,
                              lit_config=lit,
                              trainer_config={'checkpoint_every': 1},
                              out_dir=str(tmp_path / 'jax'))
    jsaves, jlrs = _scripted(jt, monkeypatch, jtrainer_mod, losses)
    jt.fit(max_epochs=len(losses))
    pt = Trainer(torch.nn.Linear(1, 1), None, None, lit,
                 {'checkpoint_every': 1}, out_dir=str(tmp_path / 'port'))
    psaves, plrs = _scripted(pt, monkeypatch, trainer_mod, losses)
    pt.fit(max_epochs=len(losses))
    assert psaves == jsaves == [(0, 10.0), (4, 9.0), (8, 8.0)]
    assert plrs == jlrs and plrs[-1] < plrs[0]
    assert (pt.best_loss, pt.plateau_baseline, pt.lr) == \
        (jt.best_loss, jt.plateau_baseline, jt.lr)
    meta = json.loads((tmp_path / 'port' / 'last.ckpt' / 'meta.json')
                      .read_text())
    assert meta['best_loss'] == 8.0 and meta['plateau_baseline'] == \
        jt.plateau_baseline


# ----------------------------------------------------------------------
# the port's own Trainer mechanics
@pytest.fixture()
def small(runs):
    """A fresh port model and loaders on the runs' data."""
    tl, vl = _loaders(False, runs['tr'], runs['vl'])
    model = tgm.make_model(runs['cfg'], runs['stats'],
                           generator=torch.Generator().manual_seed(3))
    return model, tl, vl


def test_checkpoint_round_trip_is_exact(small, tmp_path):
    model, tl, vl = small
    lit = dict(LIT, start_qm_epochs=0)
    t = Trainer(model, tl, vl, lit, {'checkpoint_every': 1},
                out_dir=str(tmp_path / 'run'))
    t.fit(max_epochs=2)
    t2 = Trainer(tgm.make_model(jgm.get_small_model_config()), tl, vl, lit,
                 {}, out_dir=None)
    t2.load_checkpoint(tmp_path / 'run' / 'last.ckpt')
    for (k, a), (k2, b) in zip(t.model.state_dict().items(),
                               t2.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    assert t2.optimizer.count == t.optimizer.count == 4
    for name in t.optimizer.mu:
        assert torch.equal(t.optimizer.mu[name], t2.optimizer.mu[name])
        assert torch.equal(t.optimizer.nu[name], t2.optimizer.nu[name])
    for key in ('epoch', 'global_step', 'lr', 'best_loss',
                'plateau_baseline'):
        assert getattr(t2, key) == getattr(t, key), key
    assert t2.elapsed_time == pytest.approx(t.elapsed_time, abs=0.5)
    meta = json.loads((tmp_path / 'run' / 'last.ckpt' / 'meta.json')
                      .read_text())
    assert set(meta) == {'epoch', 'global_step', 'lr', 'best_loss',
                         'plateau_baseline', 'elapsed_time', 'config'}
    assert not (tmp_path / 'run' / 'best.ckpt' / 'opt_state.pt').exists()


def test_torn_checkpoint_detected(small, tmp_path):
    model, tl, _ = small
    t = Trainer(model, tl, None, {'lr': 2e-4}, {})
    t.save_checkpoint(tmp_path / 'x.ckpt', blocking=True)
    t.load_checkpoint(tmp_path / 'x.ckpt')   # intact: loads
    f = tmp_path / 'x.ckpt' / 'params.pt'
    f.write_bytes(f.read_bytes() + b'\x00')
    with pytest.raises(RuntimeError, match='torn'):
        t.load_checkpoint(tmp_path / 'x.ckpt')
    # a params-only save removes a stale optimizer file
    t.save_checkpoint(tmp_path / 'x.ckpt', include_opt_state=False,
                      blocking=True)
    assert not (tmp_path / 'x.ckpt' / 'opt_state.pt').exists()
    t.load_checkpoint(tmp_path / 'x.ckpt')


def test_async_writer_snapshot_skip_and_errors(small, tmp_path, monkeypatch):
    """An async save writes what the model held when it was asked for
    (a clone, not a reference the next step updates in place), equal to
    a blocking save; a save while the writer is busy is skipped; a
    writer error surfaces on the next join."""
    model, tl, _ = small
    t = Trainer(model, tl, None, dict(LIT, start_qm_epochs=0),
                {'async_checkpoints': True}, out_dir=str(tmp_path / 'run'))
    release = threading.Event()
    real = trainer_mod._write_checkpoint

    def slow(path, p, o, meta):
        release.wait(timeout=10)
        real(path, p, o, meta)
    monkeypatch.setattr(trainer_mod, '_write_checkpoint', slow)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert t.save_checkpoint(tmp_path / 'a.ckpt') is True
    assert t.save_checkpoint(tmp_path / 'busy.ckpt') is False
    t.train_epoch()             # updates the parameters in place
    release.set()
    t._join_ckpt_thread()
    monkeypatch.setattr(trainer_mod, '_write_checkpoint', real)
    saved = torch.load(tmp_path / 'a.ckpt' / 'params.pt', weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in before.items())
    assert any(not torch.equal(saved[k], v)
               for k, v in model.state_dict().items())
    assert not (tmp_path / 'busy.ckpt').exists()
    t.save_checkpoint(tmp_path / 'b.ckpt', blocking=True)
    t.save_checkpoint(tmp_path / 'c.ckpt')
    t._join_ckpt_thread()
    for name in ('params.pt', 'opt_state.pt'):
        b = torch.load(tmp_path / 'b.ckpt' / name, weights_only=True)
        c = torch.load(tmp_path / 'c.ckpt' / name, weights_only=True)
        flat = lambda d: [d] if isinstance(d, (int, torch.Tensor)) else [
            x for v in d.values() for x in flat(v)]
        for x, y in zip(flat(b), flat(c)):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))

    def bad(path, p, o, meta):
        raise OSError('disk gone')
    monkeypatch.setattr(trainer_mod, '_write_checkpoint', bad)
    assert t.save_checkpoint(tmp_path / 'e.ckpt') is True
    with pytest.raises(RuntimeError, match='async checkpoint'):
        t._join_ckpt_thread()


def test_fit_exception_joins_async_writer(small, tmp_path, monkeypatch):
    model, tl, _ = small
    t = Trainer(model, tl, None, {'lr': 2e-4, 'start_qm_epochs': 0},
                {'async_checkpoints': True}, out_dir=str(tmp_path / 'run'))
    real = trainer_mod._write_checkpoint

    def slow(path, p, o, meta):
        time.sleep(0.3)
        real(path, p, o, meta)
    monkeypatch.setattr(trainer_mod, '_write_checkpoint', slow)
    assert t.save_checkpoint(tmp_path / 'run' / 'last.ckpt') is True
    assert t._ckpt_thread.is_alive()
    monkeypatch.setattr(t, 'train_epoch',
                        lambda: (_ for _ in ()).throw(ValueError('boom')))
    with pytest.raises(ValueError, match='boom'):
        t.fit(max_epochs=2)
    assert t._ckpt_thread is None
    assert (tmp_path / 'run' / 'last.ckpt' / 'meta.json').exists()


def test_best_flushed_at_fit_exit(small, tmp_path, monkeypatch):
    """Best at epoch 1 is throttle-skipped (checkpoint_every 5): the
    fit-exit flush writes the epoch-1 snapshot, not the final weights."""
    model, tl, _ = small
    losses = iter([5.0, 4.0, 10.0])
    monkeypatch.setattr(trainer_mod, 'early_stopping_loss',
                        lambda metrics, w: next(losses))
    t = Trainer(model, tl, None, {'lr': 2e-4, 'start_qm_epochs': 0,
                                  'warmup_steps': 1},
                {'async_checkpoints': True}, out_dir=str(tmp_path / 'run'))
    t.fit(max_epochs=3)
    best = tmp_path / 'run' / 'best.ckpt'
    meta = json.loads((best / 'meta.json').read_text())
    assert meta['epoch'] == 1 and meta['best_loss'] == 4.0
    snapshot, epoch = t._best_snapshot
    assert epoch == 1
    saved = torch.load(best / 'params.pt', weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in snapshot.items())
    assert any(not torch.equal(saved[k], v)
               for k, v in t.model.state_dict().items())
    assert not (best / 'opt_state.pt').exists()


def test_early_exit_counts_the_epoch(small, tmp_path):
    model, tl, vl = small
    t = Trainer(model, tl, vl, {'lr': 2e-4, 'start_qm_epochs': 0,
                                'time_limit': 1e-9},
                {'max_epochs': 10, 'checkpoint_every': 1},
                out_dir=str(tmp_path / 'run'))
    out = t.fit()
    assert len(out['history']) == t.epoch == 1
    meta = json.loads((tmp_path / 'run' / 'last.ckpt' / 'meta.json')
                      .read_text())
    assert meta['epoch'] == 1


def test_scan_epochs_equal_the_loop_on_cached_batches(runs):
    """The same seed: the scanned epoch and the cached loop take the same
    batches in the same order with the same LRs, and give the same losses
    and validation (rtol 1e-5 / 1e-4: the CPU's threaded segment sums are
    not bit-reproducible from run to run, so neither is a step); the
    scan's rules hold."""
    results = []
    for scan in (False, True):
        tl, vl = _loaders(False, runs['tr'], runs['vl'])
        vl.fixed_pad = False
        model = tgm.make_model(runs['cfg'], runs['stats'],
                               generator=torch.Generator().manual_seed(4))
        t = Trainer(model, tl, vl, dict(LIT), {}, seed=5,
                    cache_batches=True, scan_epochs=scan)
        steps, step = [], t.train_step

        def wrapped(batch, weights, lr, gen, step=step, steps=steps):
            steps.append((float(batch.xyz.sum()), batch.num_mols,
                          weights.param.tolist(), lr))
            return step(batch, weights, lr, gen)
        t.train_step = wrapped
        t.fit(max_epochs=3)
        if scan:
            assert t.val_loader is not vl and t.val_loader.fixed_pad
            assert not vl.fixed_pad
        results.append((steps, t.train_losses,
                        [h['metrics'] for h in t.history], t.global_step))
    (sa, la, ma, ga), (sb, lb, mb, gb) = results
    assert sa == sb and ga == gb == 6
    assert len({s[0] for s in sa[:2]}) == 2
    np.testing.assert_allclose(sum(la, []), sum(lb, []), rtol=1e-5)
    for x, y in zip(ma, mb):
        assert x.keys() == y.keys()
        for ds in x:
            for k in x[ds]:
                np.testing.assert_allclose(x[ds][k], y[ds][k], rtol=1e-4)
    tl, _ = _loaders(False, runs['tr'], runs['vl'])
    with pytest.raises(ValueError, match='cache_batches'):
        Trainer(tgm.make_model(runs['cfg']), tl, None, dict(LIT), {},
                scan_epochs=True)
    tl.fixed_pad = False
    t = Trainer(tgm.make_model(runs['cfg']), tl, None, dict(LIT), {},
                cache_batches=True, scan_epochs=True)
    with pytest.raises(ValueError, match='uniform batch shapes'):
        t.train_epoch()


def test_profile_steps_writes_a_trace(small, tmp_path):
    model, tl, _ = small
    t = Trainer(model, tl, None, {'lr': 2e-4}, {},
                out_dir=str(tmp_path / 'run'))
    trace = t.profile_steps(n_steps=1)
    assert (trace / 'trace.json').stat().st_size > 0
    assert not [th for th in threading.enumerate()
                if th.name == 'grappa-loader' and th.is_alive()]


@pytest.mark.parametrize('grad_scale', [0.1, 10.0])
def test_adam_clip_matches_optax_and_pairs_state_by_name(grad_scale):
    """AdamClip against the JAX package's optax chain (clip_by_global_norm
    -> scale_by_adam -> add_decayed_weights -> scale(-1), then x lr) over
    three steps, below the clip norm and with it triggered; halfway its
    state is saved and loaded, in reversed key order, into a new
    optimizer. Float32 with the global norm summed in another order: rtol
    1e-6 / atol 1e-7 on the parameters, the same on the moments."""
    import optax
    rng = np.random.default_rng(0)
    shapes = {'a.weight': (7, 5), 'a.bias': (5,), 'b.weight': (3, 7)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    lr, clip, wd = 1e-2, 1.0, 1e-2
    assert (np.sqrt(sum((g ** 2).sum() for g in grads[0].values()))
            > clip) == (grad_scale > 1)

    tx = jtrainer_mod.make_optimizer(grad_clip=clip, weight_decay=wd)
    jp = {k: jax.numpy.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for g in grads:
        up, state = tx.update({k: jax.numpy.asarray(v) for k, v in g.items()},
                              state, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * lr, up))

    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = trainer_mod.AdamClip(grad_clip=clip, weight_decay=wd)
    for i, g in enumerate(grads):
        if i == 2:
            sd = opt.state_dict()
            rev = lambda d: dict(reversed(list(d.items())))
            opt = trainer_mod.AdamClip(grad_clip=clip, weight_decay=wd)
            opt.load_state_dict({'count': sd['count'], 'mu': rev(sd['mu']),
                                 'nu': rev(sd['nu'])})
        opt.step(tp, [torch.from_numpy(g[k]) for k in tp], lr)
    adam = state[1]
    assert opt.count == int(adam.count) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(opt.mu[k].numpy(), np.asarray(adam.mu[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(opt.nu[k].numpy(), np.asarray(adam.nu[k]),
                                   rtol=1e-6, atol=1e-7)
