"""The port's multi-device layer with a bfloat16 model (the small config
with compute_dtype='bfloat16') against the JAX package's on the CPU, and
against the port's own one-process bf16 path.

The port's side runs in W = 2 gloo ranks on the CPU (spawned once for the
module, one intra-op thread a rank, every collective with a 90 s timeout),
which run the cases of `tests/torch_parallel_bf16_worker.py` and write
rank 0's results to an npz file. The JAX side runs here meanwhile, on a
2-device mesh of the virtual CPU mesh tests/conftest.py sets up: its
`make_dp_train_step` (whose executable, given one batch on both devices,
also gives that batch's jax.grad) and `make_atom_sharded_forward`, each
compiled without XLA's excess precision, which keeps the fused bf16
model's roundings, and `energy_and_gradient(..., use_fused_torsion=True)`
on the atom-sharded batch (K5 through its plain jnp version, the JAX
package's `interpret=True`). A step's gradients come out of the JAX step
through a pass-through optimizer whose state is the gradients it is
given.

Rules and tolerances:
  * against the JAX package, the bf16 rule of
    tests/test_torch_port_bf16_train.py (RULE, SPREAD, BIAS_RULE for the
    biases flax adds in bf16): mean |port - JAX_bf16| <= 0.1 x the bf16
    effect mean |JAX_bf16 - float32|. The float32 side of the effect is
    the port's one-process float32 result on the same weights and batches
    (it agrees with JAX's float32 to ~1e-6 of the values, the float32
    tests'; the effect is 1e-3 to 1e-2 of them);
  * against the port's own unsharded path, the float32 cases' tolerances
    (tests/test_torch_port_parallel.py): the DP step's loss rtol 1e-4 and
    each gradient's relative L2 1e-3 against one process's mean of the
    two batches' gradients; the atom-sharded forward's energies 2e-4 +
    2e-4|E| and dE/dx 2e-3 + 2e-3|g|; the step's loss rtol 1e-3 and its
    parameters 5e-3 + 5e-3|p|; the Trainer's per-step losses rtol 1e-4;
    the sharded energy with K5 2e-4 + 2e-4|E| and 2e-3 + 2e-3|g|.
    The sharded bf16 step's gradients (dropout on) against the unsharded
    bf16 step's: relative L2 STEP_GRAD_RL2 = 1e-2 each
    (`test_atom_sharded_bf16_step_gradients_match_the_unsharded`: its
    doc has the sound readings and the planted faults' between which
    it lies).
  * the dropout masks of a sharded forward equal the unsharded masks'
    rows bit for bit; a mesh of one rank is make_train_step bit for bit;
    a bf16 Dense's gradients on a shard (`layers.shard_dense`,
    `AtomShard.whole_grad`) equal the unsharded Dense's to relative L2
    1e-6.
"""
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.synthetic import make_moldata as jax_make_moldata
from grappa_tpu.models import grappa_model as jgm
from grappa_tpu.models import mm_energy as jmm
from grappa_tpu.ops import fused_block as jfb
from grappa_tpu.ops import fused_gnn as jfg
from grappa_tpu.ops import fused_symmetriser as jfs
from grappa_tpu.ops import torsion_kernel as jtk
from grappa_tpu.parallel import dp as jdp
from grappa_tpu.parallel import sp as jsp
from grappa_tpu.train.torch_compat import stats_from_model
from grappa_tpu_torch.weights import (parameters_from_flax,
                                      state_dict_from_flax)

import torch_parallel_bf16_worker as bw
import torch_parallel_worker as wk
from test_torch_port_bf16_train import (BIAS_RULE, RULE, SPREAD,
                                        _bf16_dense_biases, _check_grads,
                                        _ratio, _ulp)
from test_torch_port_parallel import (_jax_batches, _jax_weights, _join,
                                      _Mesh2, _rel_l2)

WORLD = 2
JOIN_S = 240
# the sharded bf16 step's gradients against the unsharded step's
# (test_atom_sharded_bf16_step_gradients_match_the_unsharded)
STEP_GRAD_RL2 = 1e-2
# the ratio to the bf16 effect up to which a gradient past its rule
# against JAX passes when the port's unsharded bf16 step lies as far from
# JAX (ROADMAP.md §3: 7 of the proper writer's gradients, 0.106-0.130,
# within JAX's own spread under a second one-ulp draw)
JAX_GAP_CAP = 0.15
CASES = 'dense,dp,trainer,run,sp,dropout,torsion'
NO_EXCESS = {'xla_allow_excess_precision': False}


def _grads_tx():
    """An optax transformation whose state is the gradients it is given
    (its updates zero): a step's state after the step holds the gradients
    the step handed its optimizer."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _compile(fn, *args):
    return fn.lower(*args).compile(compiler_options=NO_EXCESS)


def _start(workdir):
    return mp.start_processes(bw.main, args=(WORLD, str(workdir), CASES),
                              nprocs=WORLD, join=False, start_method='spawn')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Spawn the ranks, compute the JAX references meanwhile, join."""
    jfb.INTERPRET = jfs.INTERPRET = jfg.INTERPRET = True
    try:
        yield _runs(tmp_path_factory)
    finally:
        jfb.INTERPRET = jfs.INTERPRET = jfg.INTERPRET = False


def _runs(tmp_path_factory):
    work = tmp_path_factory.mktemp('ranks_bf16')
    cfg = jgm.get_small_model_config()
    jbatches = _jax_batches()
    jmodel = jgm.make_model(cfg)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: jnp.asarray(a + rng.normal(0, 0.05, a.shape), np.float32),
        jax.device_get(jax.jit(jmodel.init)(jax.random.key(0),
                                            jbatches[0])))
    torch.save({'cfg': cfg,
                'state_dict': state_dict_from_flax(params, cfg,
                                                   stats_from_model(jmodel))},
               work / 'inputs.pt')
    deadline = time.time() + JOIN_S
    ctx = _start(work)

    # the fused bf16 model (the Pallas kernels in interpret mode): compiled
    # without excess precision it keeps every bf16 rounding of the eager
    # call (tests/test_torch_port_bf16_train.py), which the eager flax
    # modules under jit do not
    model16 = jgm.make_model(dict(cfg, **bw.BF16_CFG, fused_gnn=True,
                                  fused_heads=True))
    mesh = jdp.make_mesh(WORLD)
    tx = _grads_tx()
    ref = {'cfg': cfg, 'params': params}

    # the DP step (device r trains on batch r) and, through the same
    # executable, batch 0 on both devices: the mean of two equal
    # gradients, jax.grad of batch 0, which the atom-sharded step on batch
    # 0 is held to; the atom-sharded forward of batch 0 split by atoms
    dp_step = jdp.make_dp_train_step(model16, tx, mesh, donate=False)
    rngs = jax.random.split(jax.random.key(1), WORLD)

    def dp_args(p, which):
        bs = [jbatches[i] for i in which]
        return (p, tx.init(p), jdp.shard_batches(bs),
                jax.tree.map(lambda *x: jnp.stack(x),
                             *[_jax_weights(b.num_mols) for b in bs]),
                jnp.float32(wk.LR), rngs)

    sp_batch = jsp.shard_batch_by_atoms(jbatches[0], mesh)
    fwd = jsp.make_atom_sharded_forward(model16, mesh)
    with ThreadPoolExecutor(3) as pool:
        torsion = pool.submit(_torsion_reference, mesh)
        dp_run, fwd_run = pool.map(lambda a: _compile(*a), [
            (dp_step, *dp_args(params, (0, 1))), (fwd, params, sp_batch)])
        ref['torsion'] = torsion.result()
    grads_of = lambda out: parameters_from_flax(jax.device_get(out[1]), cfg)
    out = dp_run(*dp_args(params, (0, 1)))
    ref['dp'] = (float(out[2]), {k: np.asarray(v) for k, v in out[3].items()},
                 grads_of(out))
    ref['dp_ulp'] = lambda: grads_of(dp_run(*dp_args(_ulp(params, 1),
                                                     (0, 1))))
    ref['sp'] = [np.asarray(x) for x in fwd_run(params, sp_batch)]
    out = dp_run(*dp_args(params, (0, 0)))
    ref['sp_loss'], ref['sp_grad'] = float(out[2]), grads_of(out)
    ref['sp_grad_ulp'] = lambda seed=1: grads_of(dp_run(*dp_args(
        _ulp(params, seed), (0, 0))))

    _join(ctx, deadline)
    ref['out'] = dict(np.load(work / f'out_w{WORLD}.npz'))
    return ref


def _torsion_reference(mesh):
    """The JAX package's atom-sharded MM energy with use_fused_torsion=True
    on the torsion case's batch, K5 through its plain jnp version (the
    JAX package's `interpret=True`)."""
    mdata = jax_make_moldata(seed=bw.TORSION_SEED,
                             n_confs=bw.TORSION_CONFS,
                             n_atoms=bw.TORSION_ATOMS, learnable=True,
                             conf_noise=0.05)
    mg = JaxMolGraph.from_moldata(mdata)
    t_batch = jsp.shard_batch_by_atoms(jax_collate([mg], pad=(
        jsp.atom_sharded_pad_spec([mg], bw.TORSION_CONFS, _Mesh2))), mesh)
    t_params = {key: jnp.nan_to_num(getattr(t_batch.terms[t], f))
                for key, t, f in wk.REF_FIELDS}
    plain_k5 = jtk.torsion_energy_fused
    jtk.torsion_energy_fused = lambda pos, k, interpret=True: plain_k5(
        pos, k, True)
    try:
        return [np.asarray(x) for x in jax.jit(
            lambda b, p: jmm.energy_and_gradient(
                b, p, use_fused_torsion=True))(t_batch, t_params)]
    finally:
        jtk.torsion_energy_fused = plain_k5


def _names(out, key):
    return [k[len(key) + 1:] for k in out if k.startswith(key + '/')]


def _port_grads(out, key, names):
    return [out[f'{key}/{n}'] for n in names]


def _bias_rules(runs, fused, monkeypatch):
    """BIAS_RULE for the biases the port's model adds in bf16."""
    model = bw._model({'cfg': runs['cfg'], 'state_dict': state_dict_from_flax(
        runs['params'], runs['cfg'],
        stats_from_model(jgm.make_model(runs['cfg'])))}, fused)
    batch = next(iter(wk.train_loader()))[0]
    return dict.fromkeys(_bf16_dense_biases(
        model, SimpleNamespace(tb=batch), monkeypatch), BIAS_RULE)


def _collectives(out, key):
    seen = [str(x) for x in out[f'{key}/collectives']]
    print(f'{key}: collectives by operand dtype {seen}')
    return seen


@pytest.mark.parametrize('path', ['shard_dense', 'whole_grad'])
def test_bf16_dense_gradients_on_a_shard_are_the_unsharded(runs, path):
    """A bf16 Dense's weight and bias gradients from two ranks' halves of
    its rows (`layers.shard_dense`), and from a projection every rank
    computes whole while using half its rows (`AtomShard.whole_grad`),
    equal the unsharded bf16 Dense's to relative L2 1e-6 (one rounding of
    a float32 sum in another order); autograd's own bf16 product, which
    rounds each rank's part before the ranks' sum, lies 1e-4 or more off
    (measured 2.3e-3), so the check tells the two apart."""
    out = runs['out']
    plain = 'autograd' if path == 'shard_dense' else 'whole_autograd'
    for name in ('weight', 'bias'):
        assert out[f'dense/{path}/{name}'] <= 1e-6, name
        assert out[f'dense/{plain}/{name}'] >= 1e-4, name


def test_dp_bf16_step_matches_jax(runs, monkeypatch):
    """The bf16 DP step (eager modules, the CPU's path) against the JAX
    package's make_dp_train_step with the bf16 small model on a 2-device
    mesh: the loss and every averaged gradient under the bf16 rule. The
    step's one collective (loss, aux and gradients in one buffer) sums in
    float32."""
    out = runs['out']
    loss, _, want16 = runs['dp']
    names = list(want16)
    got16 = _port_grads(out, 'dp/fused/grad', names)
    got32 = _port_grads(out, 'dp/fused/one/float32/grad', names)
    _check_grads(got16, got32, [want16[k].numpy() for k in names], got32,
                 lambda: [g[k].numpy() for g in [runs['dp_ulp']()]
                          for k in names],
                 names, max_rule=None,
                 rules=_bias_rules(runs, True, monkeypatch))
    loss32 = float(out['dp/fused/one/float32/loss'])
    assert abs(float(out['dp/fused/loss']) - loss) <= 0.1 * abs(loss - loss32)


@pytest.mark.parametrize('path', ['eager', 'fused'])
def test_dp_bf16_step_matches_one_process(runs, path):
    """The bf16 DP step against the port's one-process bf16 step on the
    mean of the shares: loss rtol 1e-4, each gradient's relative L2 1e-3
    (float32 sums in another order); the collective's operand float32 on
    both paths (fused: the kernels' plain versions, the card's path)."""
    out = runs['out']
    np.testing.assert_allclose(out[f'dp/{path}/loss'],
                               out[f'dp/{path}/one/bfloat16/loss'],
                               rtol=1e-4)
    names = _names(out, f'dp/{path}/grad')
    assert len(names) == len(runs['dp'][2])
    for n in names:
        assert _rel_l2(out[f'dp/{path}/grad/{n}'],
                       out[f'dp/{path}/one/bfloat16/grad/{n}']) <= 1e-3, n
    assert _collectives(out, f'dp/{path}') == ['all_reduce:torch.float32']


def test_world_of_one_is_bf16_make_train_step():
    """A mesh of one rank (gloo, the CPU): the bf16 DP step with dropout on
    is bf16 make_train_step's, bit for bit, over three steps (one intra-op
    thread: the CPU's threaded segment sums are not bit-reproducible)."""
    import torch.distributed as dist

    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.parallel import dp
    from grappa_tpu_torch.train.trainer import make_optimizer, make_train_step
    cfg = dict(jgm.get_small_model_config(), **bw.BF16_CFG, **wk.DROPOUT)
    mesh = dp.make_mesh(1, device='cpu', timeout_s=60)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        batches = [b for b, _ in wk.train_loader()][:3]
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


def test_dp_bf16_trainer_epoch_with_trailing_group(runs):
    """A bf16 Trainer(mesh=...) epoch of 5 batches over 2 ranks: 3 steps,
    the last a trailing group of 1, each rank collating one batch a step;
    its per-step losses against the same groups stepped in one process
    (rtol 1e-4); every rank ends with the same parameters."""
    out = runs['out']
    assert int(out['trainer/global_step']) == 3
    assert list(out['trainer/collated']) == [3] * WORLD
    assert bool(out['trainer/ranks_equal'])
    np.testing.assert_allclose(out['trainer/losses'],
                               out['trainer/one_losses'], rtol=1e-4)


def test_bf16_trainrun_with_a_mesh(runs):
    """do_trainrun(mesh=...) with a bf16 config for 2 epochs, then
    resume_trainrun(mesh=...) by one: the stored config keeps
    compute_dtype, the resumed model is bf16, rank 0 alone writes,
    model.npz holds float32 parameters, every rank ends equal."""
    out = runs['out']
    assert list(out['run/epochs']) == [2, 3]
    assert str(out['run/stored_dtype']) == 'bfloat16'
    assert str(out['run/model_dtype']) == 'torch.bfloat16'
    assert list(out['run/npz_dtypes']) == ['float32']
    assert list(out['run/writer_dirs']) == [1, 0]
    assert bool(out['run/ranks_equal'])
    assert {'grappa_config.yaml', 'best.ckpt', 'last.ckpt', 'model.npz',
            'metrics.jsonl'} <= set(out['run/files'])
    assert np.isfinite(out['run/train_losses']).all()


def test_atom_sharded_bf16_forward_matches_jax(runs):
    """The atom-sharded bf16 forward (eager) against the JAX package's
    make_atom_sharded_forward with the bf16 model: energies and dE/dx
    under the bf16 rule."""
    out = runs['out']
    for i, key in enumerate(('energy', 'gradient')):
        want16 = runs['sp'][i]
        got16 = out[f'sp/mols/fused/{key}']
        want32 = out[f'sp/mols/fused/one/float32/{key}']
        err = np.abs(got16 - want16).mean()
        effect = np.abs(want16 - want32).mean()
        assert err <= 0.1 * effect, (key, err, effect)


@pytest.mark.parametrize('path', ['eager', 'fused'])
def test_atom_sharded_bf16_forward_matches_the_unsharded(runs, path):
    """The atom-sharded bf16 forward against the port's unsharded bf16
    forward: energies 2e-4 + 2e-4|E|, dE/dx 2e-3 + 2e-3|g|."""
    out = runs['out']
    one = f'sp/big/{path}/one/bfloat16'
    np.testing.assert_allclose(out[f'sp/big/{path}/energy'],
                               out[f'{one}/energy'],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out[f'sp/big/{path}/gradient'],
                               out[f'{one}/gradient'], rtol=2e-3, atol=2e-3)
    _collectives(out, f'sp/big/{path}/forward')


def test_atom_sharded_bf16_step_matches_jax(runs, monkeypatch):
    """The atom-sharded bf16 train step (fused: the kernels' plain
    versions) on the DP step's batch 0 split by atoms, against the JAX
    package's bf16 step on that batch (jax.grad of its loss, as
    tests/test_torch_port_parallel.py holds the float32 sharded step's):
    the loss at RULE; every all-reduced gradient under the bf16 rule
    (RULE, SPREAD x JAX's own one-ulp spread, BIAS_RULE); the median over
    the gradients at RULE. A gradient past its rule passes only where the
    gap is the port's unsharded bf16 step's on this batch (recorded in
    ROADMAP.md §3): the sharded gradient within relative L2 1e-3 of that
    step's, and at most JAX_GAP_CAP of the bf16 effect from JAX's.
    (Measured: the sharded gradients equal the unsharded step's to 0.000
    of the effect, median 0.044 from JAX's; 7 of the proper writer's
    gradients, its projection's weight and six biases of its first
    layers, lie 0.106-0.130 from JAX's, both steps alike, where JAX's
    own spread is 0.03-0.10 under the rule's one-ulp draw and
    0.23-0.32 under a second, printed beside them.) JAX's own
    atom-sharded step is not the reference for
    the gradients: GSPMD rounds each device's partial weight gradient of
    a bf16 Dense to bf16 before the sum (its first GNN block's fc weights
    stood at 0.19 of the effect from the unsharded gradients, past the
    0.16 of its own one-ulp spread), which `layers.shard_dense` does not."""
    out = runs['out']
    want16, ulp = runs['sp_grad'], runs['sp_grad_ulp']()
    rules = _bias_rules(runs, True, monkeypatch)
    ratios, over, gap = [], {}, {}
    for n, want in want16.items():
        key = f'sp/mols/fused/{{}}/{n}'
        got, f32 = out[key.format('grad')], out[key.format('one/float32/grad')]
        assert np.isfinite(got).all(), n
        r = _ratio(got, want.numpy(), f32)
        if r is None:
            continue
        ratios.append(r[0])
        floor = _ratio(ulp[n].numpy(), want.numpy(), f32) or (0.0, 0.0)
        if r[0] <= max(rules.get(n, RULE), SPREAD * floor[0]):
            continue
        if r[0] <= JAX_GAP_CAP and _rel_l2(
                got, out[key.format('one/bfloat16/grad')]) <= 1e-3:
            gap[n] = r[0]
        else:
            over[n] = (r[0], floor[0])
    if gap:
        # a reading: JAX's own spread there under another one-ulp draw
        ulp2 = runs['sp_grad_ulp'](2)
        print('past the rule as the unsharded step is (ratio, JAX\'s '
              'spread under a second one-ulp draw):', {
                  n: (r, _ratio(ulp2[n].numpy(), want16[n].numpy(), out[
                      f'sp/mols/fused/one/float32/grad/{n}'])[0])
                  for n, r in gap.items()})
    assert not over, over
    assert np.median(ratios) <= RULE
    loss = runs['sp_loss']
    loss32 = float(out['sp/mols/fused/one/float32/loss'])
    assert abs(float(out['sp/mols/fused/loss']) - loss) <= RULE * abs(
        loss - loss32)


@pytest.mark.parametrize('path', ['eager', 'fused'])
def test_atom_sharded_bf16_step_matches_the_unsharded(runs, path):
    """The atom-sharded bf16 train step with dropout on against the port's
    unsharded bf16 make_train_step (the same seeds): loss rtol 1e-3,
    parameters after the step 5e-3 + 5e-3|p|; the collectives' operand
    dtypes printed."""
    out = runs['out']
    one = f'sp/big/{path}/one/bfloat16'
    np.testing.assert_allclose(out[f'sp/big/{path}/loss'], out[f'{one}/loss'],
                               rtol=1e-3)
    for n in _names(out, f'sp/big/{path}/new'):
        np.testing.assert_allclose(out[f'sp/big/{path}/new/{n}'],
                                   out[f'{one}/new/{n}'], rtol=5e-3,
                                   atol=5e-3, err_msg=n)
    _collectives(out, f'sp/big/{path}/step')


@pytest.mark.parametrize('path', ['eager', 'fused'])
def test_atom_sharded_bf16_step_gradients_match_the_unsharded(runs, path):
    """The all-reduced gradients of the sharded bf16 step with dropout on
    against the unsharded bf16 step's (the same dropout seeds): each
    within relative L2 STEP_GRAD_RL2. Not the float32 cases' 1e-3: where
    a float32 sum in another order (the ranks' partial sums, the CPU's
    plain versions at another row count) flips a bf16 rounding, the flip
    spreads through the later roundings (a one-ulp change of every weight
    moves these gradients by 0.5-1%). Measured: eager worst 5.6e-3 (the
    eager gather's backward sums its bf16 scatter in bf16 on each rank
    apart), fused 3.8e-3; planted faults: one wrong dropout mask row a
    rank puts all 130 gradients past 1e-2 (worst 0.097 eager, 0.18
    fused), a dropped / W in the sharded Dense or the projections'
    gradient 1.0."""
    out = runs['out']
    key, one = f'sp/big/{path}/grad', f'sp/big/{path}/one/bfloat16/grad'
    names = _names(out, key)
    assert len(names) == len(runs['dp'][2])
    rel = {n: _rel_l2(out[f'{key}/{n}'], out[f'{one}/{n}']) for n in names}
    assert max(rel.values()) <= STEP_GRAD_RL2, {
        n: r for n, r in rel.items() if r > STEP_GRAD_RL2}


@pytest.mark.parametrize('path', ['eager', 'fused'])
def test_atom_sharded_bf16_dropout_is_the_unsharded_draw(runs, path):
    """Training-mode bf16 forward with dropout on: every mask a rank draws
    is the unsharded mask's rows, bit for bit (13 masks: the GNN's and
    the writers'), and the sharded prediction the unsharded one."""
    out = runs['out']
    assert int(out[f'dropout/{path}/masks']) == 13
    assert bool(out[f'dropout/{path}/masks_equal'])
    for k in ('n2_k', 'n2_eq', 'n3_k', 'n3_eq', 'n4_k', 'n4_improper_k'):
        assert out[f'dropout/{path}/{k}'] <= 1e-5, k


def test_atom_sharded_fused_torsion_energy(runs):
    """The atom-sharded MM energy with use_fused_torsion=True (K5 / K5b's
    plain versions, called twice a call on the rank's propers and
    impropers) against the JAX package's energy_and_gradient(...,
    use_fused_torsion=True) on the sharded batch, and against the port's
    unsharded fused energy and its own sharded Chebyshev path: energies
    2e-4 + 2e-4|E|, dE/dx 2e-3 + 2e-3|g|."""
    out = runs['out']
    assert int(out['torsion/fused/k5_calls']) == 2
    assert int(out['torsion/plain/k5_calls']) == 0
    for want_e, want_g in (runs['torsion'],
                           (out['torsion/one/energy'],
                            out['torsion/one/gradient']),
                           (out['torsion/plain/energy'],
                            out['torsion/plain/gradient'])):
        np.testing.assert_allclose(out['torsion/fused/energy'], want_e,
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out['torsion/fused/gradient'], want_g,
                                   rtol=2e-3, atol=2e-3)
