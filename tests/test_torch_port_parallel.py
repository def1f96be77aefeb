"""The port's multi-device layer (grappa_tpu_torch.parallel,
Trainer(mesh=...), atom-sharded MD) against the JAX package on the CPU:
tests/test_parallel.py's equivalences, ported.

The port's side runs in gloo ranks on the CPU: W = 2 and W = 4 processes
(spawned once for the module, sharing one FileStore each, one intra-op
thread a rank, every collective with a 90 s timeout), which run every case
of `tests/torch_parallel_worker.py` and write rank 0's results to an npz
file. The JAX side runs here meanwhile: the references are JAX's
single-device computations, which tests/test_parallel.py holds equal to
JAX's sharded ones (the DP step to the mean of per-batch jax.grad, the
sharded forward, train step and MD to the unsharded). The small config's
weights are JAX's init with seeded numpy noise (so the zero-initialised
branches carry signal), carried over by state_dict_from_flax; molecules
are each package's make_moldata / make_dataset of the same seeds.

Tolerances: the DP step's loss rtol 1e-4 and each averaged gradient's
relative L2 1e-3 against the mean of JAX's per-batch gradients; its
update against the port's one-process AdamClip on that mean gradient
1e-6 (Adam's first step turns rounding noise into sign flips, so updates
are compared within the port only, as tests/test_parallel.py:59 uses
SGD). The Trainer's DP epoch per-step
losses rtol 2e-4 against JAX's optimizer on the same group means
(tests/test_torch_port_trainer.py's tolerance). DP eval energies 5e-4,
dE/dx 5e-3; the conformer-sharded energy 1e-5; the atom-sharded forward
energies 2e-4, dE/dx 2e-3 (600 atoms); MD 2e-4 (400 atoms, 10 NVE steps);
the atom-sharded train step loss rtol 1e-3, each all-reduced gradient's
relative L2 1e-3 against jax.grad of the unsharded batch, parameters 5e-3
(Adam at lr 1e-3: a sign flip moves an entry by 2e-3, so the update alone
would pass any gradient).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from grappa_tpu import md as jmd
from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.dataset import Dataset as JaxDataset
from grappa_tpu.data.loader import GraphLoader as JaxGraphLoader
from grappa_tpu.data.synthetic import make_dataset as jax_make_dataset
from grappa_tpu.data.synthetic import make_moldata as jax_make_moldata
from grappa_tpu.models import grappa_model as jgm
from grappa_tpu.models import mm_energy as jmm
from grappa_tpu.parallel.sp import atom_sharded_pad_spec
from grappa_tpu.train import loss as jloss
from grappa_tpu.train import trainer as jtrainer
from grappa_tpu.train.torch_compat import stats_from_model
from grappa_tpu_torch.ops import fused_block, fused_gnn, philox
from grappa_tpu_torch.train.trainer import make_optimizer
from grappa_tpu_torch.weights import (parameters_from_flax,
                                      state_dict_from_flax)

import torch_parallel_worker as wk

WORLDS = (2, 4)
JOIN_S = 240


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_weights(m):
    return jloss.LossWeights(
        energy=jnp.float32(1.0), gradient=jnp.float32(0.8),
        param=jnp.full(m, 1e-3, jnp.float32), proper_reg=jnp.float32(1e-3),
        improper_reg=jnp.float32(1e-3))


def _trainer_weights(m, scale):
    """The port Trainer's QM-phase weights under TRAIN_LIT (no torsion
    regularisation), times `scale`, in float32."""
    w = jloss.LossWeights(
        energy=jnp.float32(1.0), gradient=jnp.float32(0.8),
        param=jnp.full(m, 1e-3, jnp.float32), proper_reg=jnp.float32(0.0),
        improper_reg=jnp.float32(0.0))
    return jax.tree.map(lambda x: x * jnp.float32(scale), w)


def _jax_batches():
    ds = JaxDataset.from_moldata(jax_make_dataset(
        n_mols=wk.DATA_MOLS, n_confs=wk.DATA_CONFS, seed=wk.DATA_SEED),
        'syn')
    loader = JaxGraphLoader(ds, batch_size=wk.BATCH,
                            conf_strategy=wk.DATA_CONFS, shuffle=True,
                            drop_last=True, seed=0, fixed_pad=True)
    return [b for b, _ in loader]


class _Mesh2:
    """JAX's make_mesh(2)'s size, for atom_sharded_pad_spec."""
    class devices:
        size = 2


def _start(workdir, world):
    cases = 'dp,sp,run' if world == 2 else 'dp,sp'
    return mp.start_processes(wk.main, args=(world, str(workdir), cases),
                              nprocs=world, join=False, start_method='spawn')


def _join(ctx, deadline):
    while not ctx.join(timeout=1):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError('parallel ranks did not finish in time')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Spawn the ranks, compute the JAX references meanwhile, join."""
    work = tmp_path_factory.mktemp('ranks')
    cfg = jgm.get_small_model_config()
    jbatches = _jax_batches()
    jmodel = jgm.make_model(cfg)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: jnp.asarray(a + rng.normal(0, 0.05, a.shape), np.float32),
        jax.device_get(jax.jit(jmodel.init)(jax.random.key(0),
                                            jbatches[0])))
    conf_batch = jax_collate([JaxMolGraph.from_moldata(jax_make_moldata(
        seed=wk.CONF_SEED, n_confs=wk.CONF_CONFS))], n_confs=wk.CONF_CONFS)
    conf_pred = jax.jit(jmodel.apply)(params, conf_batch)
    mdata = jax_make_moldata(seed=wk.MD_SEED, n_confs=wk.MD_CONFS,
                             n_atoms=wk.MD_ATOMS, learnable=True,
                             conf_noise=0.05)
    mgraph = JaxMolGraph.from_moldata(mdata)
    md_batch = jax_collate([mgraph], pad=atom_sharded_pad_spec(
        [mgraph], wk.MD_CONFS, _Mesh2))
    md_masses = jmd.masses_from_molecules([mdata.molecule],
                                          md_batch.xyz.shape[0])
    vrng = np.random.default_rng(4)
    v0 = (np.sqrt(jmd.KB * 300.0 / np.asarray(md_masses))[:, None, None]
          * vrng.normal(size=md_batch.xyz.shape)
          * np.asarray(md_batch.node_mask)[:, None, None]).astype(np.float32)
    torch.save({'cfg': cfg,
                'state_dict': state_dict_from_flax(params, cfg,
                                                   stats_from_model(jmodel)),
                'conf_pred': {k: np.asarray(v) for k, v in conf_pred.items()},
                'md_v0': v0}, work / 'inputs.pt')
    deadline = time.time() + JOIN_S
    ctxs = {w: _start(work, w) for w in WORLDS}

    ref = {'cfg': cfg, 'params': params, 'jbatches': jbatches}

    @jax.jit
    def value_grad(p, batch, w):
        def loss_fn(p):
            return jloss.molwise_loss(batch, jmodel.apply(p, batch), w)
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    ref['per_batch'] = [value_grad(params, b, _jax_weights(b.num_mols))
                        for b in jbatches]
    eval_step = jax.jit(lambda p, b: jmm.energy_and_gradient(
        b, jmodel.apply(p, b)))
    ref['eval'] = [eval_step(params, b) for b in jbatches[:max(WORLDS)]]
    ref['conf'] = jax.jit(jmm.energy_and_gradient)(conf_batch, conf_pred)

    # the Trainer's DP epoch: per group, JAX's gradients of each rank's
    # batch (the trailing group's weights scaled by W / k, the padding's
    # zeroed), averaged, then JAX's optimizer; lrs of the 2-step warmup
    tx = jtrainer.make_optimizer()
    ref['trainer'] = {}
    for w in WORLDS:
        p, state, losses = params, tx.init(params), []
        n = len(jbatches)
        for g, first in enumerate(range(0, n, w)):
            grp = list(range(first, min(first + w, n)))
            k = len(grp)
            vals, grads = [], []
            for r in range(w):
                b = jbatches[grp[r] if r < k else grp[(r - k) % k]]
                scale = 1.0 if k == w else (w / k if r < k else 0.0)
                (loss, _), gr = value_grad(
                    p, b, _trainer_weights(b.num_mols, scale))
                vals.append(float(loss))
                grads.append(gr)
            mean = jax.tree.map(lambda *xs: sum(xs) / w, *grads)
            lr = min(g / wk.TRAIN_LIT['warmup_steps'], 1.0) * \
                wk.TRAIN_LIT['lr']
            updates, state = tx.update(mean, state, p)
            p = optax.apply_updates(p, jax.tree.map(
                lambda u: u * jnp.float32(lr), updates))
            losses.append(np.mean(vals))
        ref['trainer'][w] = losses

    # the atom-sharded forward, train step and MD on the whole batch
    g = JaxMolGraph.from_moldata(jax_make_moldata(
        seed=wk.SP_SEED, n_confs=wk.SP_CONFS, n_atoms=wk.SP_ATOMS))
    sp_batch = jax_collate([g], pad=atom_sharded_pad_spec(
        [g], wk.SP_CONFS, _Mesh2))
    ref['sp'] = eval_step(params, sp_batch)
    step = jtrainer.make_train_step(jmodel, tx, donate=False)
    new_p, _, loss, aux = step(params, tx.init(params), sp_batch,
                               _jax_weights(1), jnp.float32(wk.LR),
                               jax.random.key(0))
    ref['sp_step'] = (float(loss), np.asarray(aux['gradient_mse']),
                      parameters_from_flax(new_p, cfg))
    ref['sp_grad'] = parameters_from_flax(
        value_grad(params, sp_batch, _jax_weights(1))[1], cfg)
    md_params = {key: jnp.nan_to_num(getattr(md_batch.terms[t], f))
                 for key, t, f in wk.REF_FIELDS}
    ref['md'] = jmd.simulate(md_batch, md_params, md_masses,
                             dt_fs=wk.MD_DT, n_steps=wk.MD_STEPS,
                             v0=jnp.asarray(v0))

    outs = {}
    for w, ctx in ctxs.items():
        _join(ctx, deadline)
        outs[w] = dict(np.load(work / f'out_w{w}.npz'))
    ref['out'] = outs
    return ref


@pytest.mark.parametrize('world', WORLDS)
def test_dp_step_matches_mean_of_jax_grads(runs, world):
    out = runs['out'][world]
    per = runs['per_batch'][:world]
    np.testing.assert_allclose(out['dp/loss'],
                               np.mean([float(l) for (l, _), _ in per]),
                               rtol=1e-4)
    for key in per[0][0][1]:
        np.testing.assert_allclose(
            out[f'dp/aux/{key}'],
            np.mean([np.asarray(a[key]) for (_, a), _ in per], axis=0),
            rtol=1e-4, atol=1e-6, err_msg=key)
    cfg = runs['cfg']
    mean = parameters_from_flax(
        jax.tree.map(lambda *xs: sum(xs) / world, *[g for _, g in per]), cfg)
    for name, want in mean.items():
        assert _rel_l2(out[f'dp/grad/{name}'], want.numpy()) <= 1e-3, name


@pytest.mark.parametrize('world', WORLDS)
def test_dp_step_update_is_adamclip_on_the_mean(runs, world):
    """The update is the port's one-process AdamClip on the averaged
    gradient (the clip sees the mean)."""
    out = runs['out'][world]
    from grappa_tpu_torch.models.grappa_model import make_model
    model = make_model(runs['cfg'])
    model.load_state_dict(state_dict_from_flax(
        runs['params'], runs['cfg'],
        stats_from_model(jgm.make_model(runs['cfg']))), strict=True)
    params = dict(model.named_parameters())
    make_optimizer().step(params, [torch.from_numpy(out[f'dp/grad/{n}'])
                                   for n in params], wk.LR)
    for n, p in params.items():
        np.testing.assert_allclose(out[f'dp/new/{n}'], p.detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


@pytest.mark.parametrize('world', WORLDS)
def test_dp_remainder_padding_equivalence(runs, world):
    """[batch x W weight scale, zero-weight replicas] gives the step one
    process takes on the batch alone (the trailing group's rule)."""
    out = runs['out'][world]
    np.testing.assert_allclose(out['pad/loss'], out['pad/ref_loss'],
                               rtol=1e-5)
    assert out['pad/max_dev'] <= 1e-6
    np.testing.assert_allclose(out['pad/ref_loss'],
                               float(runs['per_batch'][0][0][0]), rtol=1e-4)


@pytest.mark.parametrize('world', WORLDS)
def test_dp_trainer_epoch_with_trailing_group(runs, world):
    """5 batches over W ranks: ceil(5 / W) steps, the last a trailing group
    of 1; per-step losses against JAX's optimizer on the group means."""
    out = runs['out'][world]
    want = runs['trainer'][world]
    assert int(out['trainer/global_step']) == len(want)
    np.testing.assert_allclose(out['trainer/losses'], want, rtol=2e-4)
    assert np.isfinite(out['trainer/mean_loss'])
    # each rank collated one batch a step, not the loader's every batch
    assert list(out['trainer/collated']) == [len(want)] * world


@pytest.mark.parametrize('world', WORLDS)
def test_dp_cached_trainer_loop_equals_scan(runs, world):
    """The cached DP Trainer (each rank its own slots, shuffled every
    epoch) trains alike whether its epochs loop or run as the cached
    scan."""
    out = runs['out'][world]
    loop, scan = out['cached/losses_0'], out['cached/losses_1']
    assert loop.shape == (2, -(-wk.DATA_MOLS // wk.BATCH // world))
    np.testing.assert_allclose(scan, loop, rtol=1e-5)
    assert out['cached/max_dev'] <= 2e-6


@pytest.mark.parametrize('world', WORLDS)
def test_dp_scan_epoch_matches_looped_dp_steps(runs, world):
    """The cached DP epoch (real slots first, padding last, positional
    W / k and 0 scales) equals the looped DP steps with the same groups."""
    out = runs['out'][world]
    np.testing.assert_allclose(out['scan/losses'], out['scan/losses_ref'],
                               rtol=1e-5)
    assert out['scan/max_dev'] <= 2e-6


@pytest.mark.parametrize('world', WORLDS)
def test_dp_scan_trainer_curriculum_weights(runs, world):
    """The cached DP Trainer restacks the epoch's loss weights (pre-QM
    epoch energy 0, then 1); ragged batch shapes raise the fixed_pad
    message."""
    out = runs['out'][world]
    energy = out['curriculum/energy']
    assert energy.shape[0] == 2
    assert energy[0].max() == 0.0 and energy[1].min() == 1.0
    assert 'fixed_pad' in str(out['curriculum/ragged'])


@pytest.mark.parametrize('world', WORLDS)
def test_dp_eval_matches_jax(runs, world):
    out = runs['out'][world]
    assert out['eval/energy'].shape[0] == world
    for r in range(world):
        e, g = runs['eval'][r]
        np.testing.assert_allclose(out['eval/energy'][r], np.asarray(e),
                                   rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(out['eval/gradient'][r], np.asarray(g),
                                   rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize('world', WORLDS)
def test_conf_sharded_energy_matches_jax(runs, world):
    out = runs['out'][world]
    e, g = runs['conf']
    np.testing.assert_allclose(out['conf/energy'], np.asarray(e), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out['conf/gradient'], np.asarray(g),
                               rtol=1e-5, atol=1e-5)
    assert 'divisible' in str(out['conf/odd'])
    assert str(out['mesh/too_few']) == (f'need {world + 1} devices, have '
                                        f'{world}')


@pytest.mark.parametrize('world', WORLDS)
def test_atom_sharded_forward_matches_jax(runs, world):
    out = runs['out'][world]
    e, g = runs['sp']
    np.testing.assert_allclose(out['sp/energy'], np.asarray(e), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(out['sp/gradient'], np.asarray(g), rtol=2e-3,
                               atol=2e-3)
    assert 'divisible' in str(out['sp/odd'])


@pytest.mark.parametrize('world', WORLDS)
def test_atom_sharded_train_step_matches_jax(runs, world):
    out = runs['out'][world]
    loss, g_mse, new = runs['sp_step']
    np.testing.assert_allclose(out['sp_step/loss'], loss, rtol=1e-3)
    np.testing.assert_allclose(out['sp_step/gradient_mse'], g_mse,
                               rtol=5e-3)
    for name, want in new.items():
        np.testing.assert_allclose(out[f'sp_step/new/{name}'], want.numpy(),
                                   rtol=5e-3, atol=5e-3, err_msg=name)


@pytest.mark.parametrize('world', WORLDS)
def test_atom_sharded_step_gradients_match_jax(runs, world):
    """The gradients the atom-sharded step hands to AdamClip (the ranks'
    all-reduced sum over the world size, through the differentiable
    collectives and the force loss's double backward) are jax.grad of the
    unsharded batch's loss."""
    out = runs['out'][world]
    for name, want in runs['sp_grad'].items():
        assert _rel_l2(out[f'sp_step/grad/{name}'], want.numpy()) <= 1e-3, \
            name


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('path', ['eager', 'fused'])
def test_atom_sharded_dropout_is_the_unsharded_draw(runs, world, path):
    """Training-mode forward with dropout on: every rank's masks are the
    unsharded masks' rows (the Philox row offset), so the sharded
    prediction is the unsharded one."""
    out = runs['out'][world]
    keys = [k for k in out if k.startswith(f'sp_dropout/{path}/')]
    assert len(keys) == 6
    for k in keys:
        assert out[k] <= 1e-5, k


@pytest.mark.parametrize('world', WORLDS)
def test_atom_sharded_md_matches_jax(runs, world):
    out = runs['out'][world]
    ref = runs['md']
    np.testing.assert_allclose(out['md/potential'],
                               np.asarray(ref['potential']), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(out['md/xyz'], np.asarray(ref['xyz']),
                               rtol=2e-4, atol=2e-4)
    # BAOAB: the whole noise array is drawn, the rank's rows kept
    assert out['md/langevin_dev'] <= 1e-4
    assert out['md/langevin_kinetic_dev'] <= 1e-4


def test_trainrun_with_a_mesh(runs):
    """do_trainrun(mesh=...) for 2 epochs, then resume_trainrun(mesh=...)
    by one, over 2 ranks: rank 0 alone writes the run directory (one
    train entry an epoch in metrics.jsonl), every rank ends with the same
    parameters."""
    out = runs['out'][2]
    assert list(out['run/epochs']) == [2, 3]
    assert out['run/steps'][1] == out['run/steps'][0] * 3 // 2
    assert bool(out['run/ranks_equal'])
    assert list(out['run/writer_dirs']) == [1, 0]
    assert {'grappa_config.yaml', 'split.json', 'param_statistics.json',
            'best.ckpt', 'last.ckpt', 'model.npz',
            'metrics.jsonl'} <= set(out['run/files'])
    assert list(out['run/train_entries']) == [0, 1, 2]


@pytest.mark.parametrize('shape, first', [((96, 16), 32), ((4, 48, 16), 12),
                                          ((3, 40, 8), 0)])
def test_philox_rows_are_the_unsharded_mask_rows(shape, first):
    """A shard's mask (rows first.. of the axis before the features)
    equals the unsharded mask's slice bit for bit, in philox.dropout_mask
    and the K1m / K2m wrappers' plain versions; (0, n) and None are
    today's draw."""
    *pre, n, f = shape
    total = n * 3 + first
    full_shape = (*pre, total, f)
    for stream in (0, 1):
        full = philox.dropout_mask(1234, stream, full_shape, 0.3)
        part = philox.dropout_mask(1234, stream, shape, 0.3,
                                   rows=(first, total))
        assert torch.equal(part, full[..., first:first + n, :])
        assert torch.equal(
            philox.dropout_mask(99, stream, shape, 0.5, rows=(0, n)),
            philox.dropout_mask(99, stream, shape, 0.5))
    op = fused_gnn if len(shape) == 2 else fused_block
    got = op.dropout_masks(7, shape, 0.3, device='cpu', rows=(first, total))
    want = op.dropout_masks(7, full_shape, 0.3, device='cpu')
    for a, b in zip(got, want):
        assert torch.equal(a, b[..., first:first + n, :])
    with pytest.raises(ValueError, match='outside'):
        philox.dropout_mask(1, 0, shape, 0.3, rows=(total - 1, total))


def test_world_of_one_is_make_train_step():
    """A mesh of one rank (gloo, the CPU): the DP step with dropout on is
    make_train_step's, bit for bit, over three steps (one intra-op thread:
    the CPU's threaded segment sums are not bit-reproducible)."""
    import torch.distributed as dist

    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.parallel import dp
    from grappa_tpu_torch.train.trainer import make_train_step
    cfg = dict(jgm.get_small_model_config(), **wk.DROPOUT)
    mesh = dp.make_mesh(1, device='cpu', timeout_s=60)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert mesh.size == 1 and mesh.backend == 'gloo'
        loader = wk.train_loader()
        batches = [b for b, _ in loader][:3]
        a = make_model(cfg, generator=torch.Generator().manual_seed(0))
        b = make_model(cfg, generator=torch.Generator().manual_seed(0))
        sa = make_train_step(a, make_optimizer())
        sb = dp.make_dp_train_step(b, make_optimizer(), mesh)
        ga, gb = (torch.Generator().manual_seed(5),
                  torch.Generator().manual_seed(5))
        for batch in batches:
            la, _ = sa(batch, wk.qm_weights(batch.num_mols), 1e-3, ga)
            lb, _ = sb(batch, wk.qm_weights(batch.num_mols), 1e-3, gb)
            assert torch.equal(la, lb)
        for pa, pb in zip(a.parameters(), b.parameters()):
            assert torch.equal(pa, pb)
    finally:
        torch.set_num_threads(threads)
        dist.destroy_process_group()


@pytest.mark.parametrize('device, env, cards, want', [
    # torchrun on 2 hosts x 8 cards: 16 ranks, 8 on this host
    ('cuda:3', {'LOCAL_WORLD_SIZE': '8', 'WORLD_SIZE': '16'}, 8, 'nccl'),
    # 2 ranks sharing this host's one card
    ('cuda:0', {'LOCAL_WORLD_SIZE': '2', 'WORLD_SIZE': '2'}, 1, 'gloo'),
    # spawned ranks without torchrun's environment: all on this host
    ('cuda:0', {'WORLD_SIZE': '2'}, 1, 'gloo'),
    ('cuda:1', {'WORLD_SIZE': '2'}, 2, 'nccl'),
    ('cpu', {'LOCAL_WORLD_SIZE': '1', 'WORLD_SIZE': '4'}, 8, 'gloo'),
])
def test_backend_follows_the_hosts_ranks(monkeypatch, device, env, cards,
                                         want):
    """NCCL whenever each rank of this host has a card of its own, however
    many hosts the job spans; gloo when the host's ranks share a card or
    run on the CPU."""
    from grappa_tpu_torch.parallel import dp
    monkeypatch.delenv('LOCAL_WORLD_SIZE', raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    assert dp._choose_backend(torch.device(device),
                              int(env['WORLD_SIZE'])) == want


@pytest.mark.parametrize('fixed_pad', [True, False])
def test_loader_select_skips_without_moving_the_draws(fixed_pad):
    """GraphLoader.select(keep) yields the batches a full iteration yields
    at the kept positions, equal bit for bit, epoch after epoch: the
    skipped batches draw their conformer subsets uncollated, so the
    shuffles and draws that follow stay where they were."""
    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.data.loader import GraphLoader
    from grappa_tpu_torch.data.synthetic import make_dataset
    ds = Dataset.from_moldata(make_dataset(n_mols=9, n_confs=12, seed=2),
                              'syn')

    def loader():
        return GraphLoader(ds, batch_size=2, conf_strategy=8, shuffle=True,
                           seed=4, fixed_pad=fixed_pad, device='cpu')

    full, part = loader(), loader()
    keep = lambda i: i % 3 == 1
    for _ in range(2):
        want = [b for i, (b, _) in enumerate(full) if keep(i)]
        got = [b for b, _ in part.select(keep)]
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert torch.equal(a.xyz, b.xyz)
            assert torch.equal(a.energy_ref, b.energy_ref)
            assert torch.equal(a.gradient_ref, b.gradient_ref)
            assert torch.equal(a.node_mol, b.node_mol)
