"""The port's training step (grappa_tpu_torch.train: loss, optimizer, train
and eval steps) against the JAX package's on the CPU.

Batches: each package's `make_moldata` (equal arrays), one molecule with
NaN classical parameters. Weights: the flax init of the small config with
every leaf perturbed by seeded numpy noise (so the zero-initialised branches
carry signal), carried over by `state_dict_from_flax`; gradients and Adam's
mu / nu map back by `parameters_from_flax`. Dropout is 0 here: the port's
dropout is Philox and is checked against its own plain version
(tests/test_torch_port_ops.py), not against JAX's bits.

Tolerances: loss and its parts rtol 1e-5 (float32, sums in another order
through a double backward); every gradient and Adam's mu per-leaf relative
L2 <= 1e-4, nu <= 2e-4 (it squares the gradient). Updated parameters:
Adam's first step moves an entry by about +-lr whatever the size of its
gradient, so an entry whose gradient is near 0 can move the other way in
the other framework. Entries with 0 < |g| < 1e-5 of their leaf's largest
are left out (402 of 300,563 here; the test asserts under 1%); the rest
must agree to 1e-2 lr (an entry whose gradient is exactly 0 stays put in
both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.parameters import Parameters as JaxParameters
from grappa_tpu.data.synthetic import make_moldata as jax_make_moldata
from grappa_tpu.models import grappa_model as jgm
from grappa_tpu.train import loss as jloss
from grappa_tpu.train import trainer as jtrainer
from grappa_tpu.train.torch_compat import stats_from_model
from grappa_tpu_torch.data import MolGraph, collate
from grappa_tpu_torch.data.moldata import MolData
from grappa_tpu_torch.models import grappa_model as tgm
from grappa_tpu_torch.train import loss as tloss
from grappa_tpu_torch.train import trainer as ttrainer
from grappa_tpu_torch.weights import (parameters_from_flax,
                                      state_dict_from_flax)

LR = 1e-3
CUTOFF = 1e-4


def _batches(seeds=(0, 1, 2, 3), n_confs=4):
    jmds = [jax_make_moldata(seed=s, n_confs=n_confs) for s in seeds]
    # one molecule without classical parameters: NaN references
    jmds[1].classical_parameters = JaxParameters.get_nan_params(
        jmds[1].molecule)
    tmds = [MolData.from_dict(m.to_dict()) for m in jmds]
    jb = jax_collate([JaxMolGraph.from_moldata(m) for m in jmds],
                     n_confs=n_confs)
    tb = collate([MolGraph.from_moldata(m) for m in tmds], n_confs=n_confs,
                 device='cpu')
    return jb, tb


def _weights(m):
    jw = jloss.LossWeights(
        energy=jnp.float32(1.0), gradient=jnp.float32(0.8),
        param=jnp.full(m, 1e-3, jnp.float32), proper_reg=jnp.float32(1e-3),
        improper_reg=jnp.float32(1e-3))
    tw = tloss.LossWeights(1.0, 0.8, torch.full((m,), 1e-3), 1e-3, 1e-3)
    return jw, tw


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _pred(batch, seed, n_per=(6, 3)):
    rng = np.random.default_rng(seed)
    n = {t: batch.terms[t].idxs.shape[0] for t in batch.terms}
    return {'n2_k': rng.uniform(300, 900, n['n2']),
            'n2_eq': rng.uniform(1.0, 1.6, n['n2']),
            'n3_k': rng.uniform(50, 150, n['n3']),
            'n3_eq': rng.uniform(1.7, 2.2, n['n3']),
            'n4_k': rng.normal(0, 1, (n['n4'], n_per[0])),
            'n4_improper_k': rng.normal(0, 1, (n['n4_improper'], n_per[1]))}


@pytest.mark.parametrize('n_proper', [6, 3, 8],
                         ids=['same', 'truncate', 'pad'])
def test_molwise_loss_matches_jax(n_proper):
    """NaN references count in the denominator; reference torsion ks are
    truncated (3) or zero-padded (8) to the prediction's periodicity."""
    jb, tb = _batches()
    p = _pred(jb, n_proper, (n_proper, 3))
    jw, tw = _weights(jb.num_mols)
    want, jaux = jloss.molwise_loss(
        jb, {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}, jw)
    got, aux = tloss.molwise_loss(
        tb, {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()},
        tw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for key in jaux:
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(jaux[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    if n_proper <= 6:
        # the NaN molecule (padding adds zero references, which count)
        assert aux['param_mse'][1] == 0


@pytest.mark.parametrize('max_norm', [1e-3, 1e3], ids=['clips', 'passes'])
def test_clip_is_optax_clip_by_global_norm(max_norm):
    rng = np.random.default_rng(0)
    tree = [rng.normal(0, 1, s).astype(np.float32)
            for s in ((3, 4), (7,), (2, 2, 5))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(a) for a in tree], optax.EmptyState())
    got = ttrainer.AdamClip(grad_clip=max_norm).clip(
        [torch.tensor(a) for a in tree])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)
    norm = np.sqrt(sum(float((a * a).sum()) for a in tree))
    assert (norm > max_norm) == (max_norm == 1e-3)


@pytest.fixture(scope='module')
def jax_step():
    """One JAX train step of the perturbed small model, its gradients and
    its eval step on the same batch."""
    cfg = jgm.get_small_model_config()
    jb, tb = _batches()
    jmodel = jgm.make_model(cfg)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: jnp.asarray(a + rng.normal(0, 0.05, a.shape), np.float32),
        jax.device_get(jax.jit(jmodel.init)(jax.random.key(0), jb)))
    jw, tw = _weights(jb.num_mols)
    key = jax.random.key(3)

    def loss_fn(p):
        pred = jmodel.apply(p, jb, deterministic=False,
                            rngs={'dropout': key})
        return jloss.molwise_loss(jb, pred, jw)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                    has_aux=True))(params)
    tx = jtrainer.make_optimizer()
    step = jtrainer.make_train_step(jmodel, tx, donate=False)
    new_params, opt_state, step_loss, _ = step(
        params, tx.init(params), jb, jw, jnp.float32(LR), key)
    adam = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    energy, gradient = jtrainer.make_eval_step(jmodel)(params, jb)
    pred = jax.jit(jmodel.apply)(params, jb)
    return dict(cfg=cfg, jb=jb, tb=tb, tw=tw, params=params,
                stats=stats_from_model(jmodel), loss=float(loss),
                step_loss=float(step_loss), aux=aux, grads=grads,
                new_params=new_params, mu=adam.mu, nu=adam.nu,
                energy=energy, gradient=gradient, pred=pred)


def _port_model(js, fused):
    cfg = dict(js['cfg'], fused_gnn=fused, fused_heads=fused)
    model = tgm.make_model(cfg)
    model.load_state_dict(state_dict_from_flax(js['params'], js['cfg'],
                                               js['stats']), strict=True)
    return model


@pytest.mark.parametrize('fused', [False, True], ids=['eager', 'fused'])
def test_train_step_matches_jax(jax_step, fused):
    """fused=True runs the fused ops' plain versions and their autograd
    (the kernels' counterparts on the CPU); 'eager' the modules."""
    js = jax_step
    model = _port_model(js, fused)
    tb, tw, cfg = js['tb'], js['tw'], js['cfg']
    gen = torch.Generator().manual_seed(0)

    # no predicted torsion k sits at the hard cutoff, where a last-ulp
    # difference would flip its gradient to 0 in one framework only
    with torch.no_grad():
        pred = model.eval()(tb)
    for key in ('n4_k', 'n4_improper_k'):
        k = np.abs(pred[key].numpy())
        assert not np.any(np.abs(k - CUTOFF) < 1e-3 * CUTOFF), key

    loss, aux, grads = ttrainer.loss_gradients(model, tb, tw, gen)
    np.testing.assert_allclose(float(loss), js['loss'], rtol=1e-5)
    for key in js['aux']:
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(js['aux'][key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    want_g = parameters_from_flax(js['grads'], cfg)
    assert list(want_g) == list(grads)
    for name, g in grads.items():
        assert _rel_l2(g.numpy(), want_g[name].numpy()) <= 1e-4, name

    opt = ttrainer.make_optimizer()
    step = ttrainer.make_train_step(model, opt)
    step_loss, _ = step(tb, tw, LR, gen)
    np.testing.assert_allclose(float(step_loss), js['step_loss'], rtol=1e-5)
    assert opt.count == 1
    want_mu = parameters_from_flax(js['mu'], cfg)
    want_nu = parameters_from_flax(js['nu'], cfg)
    want_p = parameters_from_flax(js['new_params'], cfg)
    left_out = total = 0
    for name, p in model.named_parameters():
        assert _rel_l2(opt.mu[name].numpy(), want_mu[name].numpy()) \
            <= 1e-4, name
        assert _rel_l2(opt.nu[name].numpy(), want_nu[name].numpy()) \
            <= 2e-4, name
        g = np.abs(want_g[name].numpy())
        keep = (g >= 1e-5 * g.max()) | (g == 0)
        left_out += int((~keep).sum())
        total += g.size
        diff = np.abs(p.detach().numpy() - want_p[name].numpy())[keep]
        assert np.all(diff <= 1e-2 * LR + 1e-6 * np.abs(
            want_p[name].numpy()[keep])), name
    assert left_out < 0.01 * total, (left_out, total)


def test_eval_step_matches_jax(jax_step):
    js = jax_step
    model = _port_model(js, True)
    energy, gradient = ttrainer.make_eval_step(model)(js['tb'])
    assert not energy.requires_grad and not gradient.requires_grad
    real = js['tb'].node_mask.numpy()
    np.testing.assert_allclose(energy.numpy(), np.asarray(js['energy']),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(gradient.numpy()[real],
                               np.asarray(js['gradient'])[real], rtol=1e-4,
                               atol=1e-3)


def test_dropout_needs_a_generator_and_draws_only_from_it():
    """Training mode with dropout: the same generator seed gives the same
    step, torch's global RNG is neither needed nor touched."""
    cfg = dict(tgm.get_small_model_config(), gnn_dropout_attention=0.3,
               parameter_dropout=0.5, gnn_dropout_final=0.1,
               fused_gnn=True, fused_heads=True)
    _, tb = _batches((0, 2))
    _, tw = _weights(tb.num_mols)
    losses = []
    for _ in range(2):
        model = tgm.make_model(cfg, generator=torch.Generator().manual_seed(1))
        torch.manual_seed(123)
        state = torch.get_rng_state()
        loss, _, grads = ttrainer.loss_gradients(
            model, tb, tw, torch.Generator().manual_seed(5))
        assert torch.equal(torch.get_rng_state(), state)
        losses.append((float(loss), grads))
    assert losses[0][0] == losses[1][0]
    for name in losses[0][1]:
        assert torch.equal(losses[0][1][name], losses[1][1][name]), name
    with pytest.raises(ValueError, match='Generator'):
        ttrainer.loss_gradients(tgm.make_model(cfg), tb, tw, None)
    # a different generator seed gives other masks
    model = tgm.make_model(cfg, generator=torch.Generator().manual_seed(1))
    other, _, _ = ttrainer.loss_gradients(model, tb, tw,
                                          torch.Generator().manual_seed(6))
    assert float(other) != losses[0][0]
