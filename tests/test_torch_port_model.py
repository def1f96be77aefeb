"""The port's model (grappa_tpu_torch.models, weights) against the JAX
package's flax model on the same weights and batches (CPU).

Weights: the flax init with every leaf perturbed by seeded numpy noise, so
the zero-initialised branches (head_reducer, si_dense2, attn.out_proj,
ff.linear2) carry signal; they cross over through the port's
state_dict_from_flax into load_state_dict(strict=True). Tolerances are those
of tests/test_torch_fullstack_parity.py: rtol 1e-4 / atol 1e-5 at the small
config, rtol 3e-4 / atol 3e-5 at the default config. Torsion ks that the
hard cutoff (|k| > 1e-4) sends to zero on one side only are left out of the
comparison: a last-ulp difference flips them.
"""
import jax
import numpy as np
import pytest
import torch

from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.loader import bucketed_pad_spec as jax_pad_spec
from grappa_tpu.data.synthetic import random_molecule
from grappa_tpu.models import grappa_model as jgm
from grappa_tpu.models.gnn import GrappaGNN as JaxGNN
from grappa_tpu.train.torch_compat import export_state_dict, stats_from_model
from grappa_tpu_torch.data import MolGraph, Molecule, collate
from grappa_tpu_torch.data.loader import bucketed_pad_spec
from grappa_tpu_torch.models import grappa_model as tgm
from grappa_tpu_torch.weights import state_dict_from_flax

CUTOFF = 1e-4


def _perturb(params, seed, scale=0.05):
    # device arrays: flax applies numpy leaves ~100x slower
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jax.numpy.asarray(a + rng.normal(0, scale, a.shape),
                                    np.float32), jax.device_get(params))


def _batches(seeds, atom_range=(8, 24)):
    jms = [random_molecule(seed=s, atom_range=atom_range) for s in seeds]
    jg = [JaxMolGraph.from_molecule(m) for m in jms]
    tg = [MolGraph.from_molecule(Molecule.from_dict(m.to_dict()))
          for m in jms]
    jb = jax_collate(jg, pad=jax_pad_spec(jg, 1), n_confs=1)
    tb = collate(tg, pad=bucketed_pad_spec(tg, 1), n_confs=1, device='cpu')
    return jb, tb


def _init(jmodel, batch, seed):
    # jit: flax's eager init of the model takes ~20 s on the CPU
    return _perturb(jax.jit(jmodel.init)(jax.random.key(seed), batch), seed)


def _apply(jmodel, params, batch):
    # jit: eager flax compiles each op for every new shape
    return jax.jit(jmodel.apply)(params, batch)


def _models(cfg, batch, seed=0, port_cfg=None):
    """(flax model, perturbed params, port model with the same weights);
    the flax model runs its XLA path on the CPU, the port `port_cfg`."""
    jmodel = jgm.make_model(cfg)
    params = _init(jmodel, batch, seed)
    sd = state_dict_from_flax(params, cfg, stats_from_model(jmodel))
    tmodel = tgm.make_model(port_cfg or cfg)
    tmodel.load_state_dict(sd, strict=True)
    return jmodel, params, tmodel.eval()


def _assert_outputs(got, want, jbatch, rtol, atol):
    for key, ref in want.items():
        term = key.rsplit('_', 1)[0] if not key.startswith('n4_im') \
            else 'n4_improper'
        real = np.asarray(jbatch.terms[term].mask)     # padded tuples: out
        a, b = got[key].detach().numpy()[real], np.asarray(ref)[real]
        assert a.shape == b.shape and np.isfinite(a).all(), key
        keep = (np.abs(a) > CUTOFF) == (np.abs(b) > CUTOFF)
        assert keep.mean() > 0.99, key
        np.testing.assert_allclose(a[keep], b[keep], rtol=rtol, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize('variant', [
    {}, {'gnn_convolutions': 1}, {'wrong_symmetry': True},
    {'gated_torsion': False, 'harmonic_gate': True}],
    ids=['small', 'conv', 'wrong_symmetry', 'ungated'])
def test_state_dict_equals_export_and_loads_strictly(variant):
    cfg = dict(jgm.get_small_model_config(), **variant)
    jmodel = jgm.make_model(cfg)
    params = _init(jmodel, _batches([1])[0], 1)
    stats = stats_from_model(jmodel)
    ref = export_state_dict(params, cfg, stats=stats)
    got = state_dict_from_flax(params, cfg, stats)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k
    model = tgm.make_model(cfg)
    model.load_state_dict(got, strict=True)
    assert set(model.state_dict()) == set(ref)


@pytest.mark.parametrize('fused', [False, True], ids=['eager', 'fused'])
def test_small_model_matches_flax_on_12_molecules(fused):
    """fused=True runs the ops' plain versions (the kernels' counterparts on
    the CPU); 'eager' the modules."""
    cfg = jgm.get_small_model_config()
    jb, tb = _batches(range(12))
    jmodel, params, tmodel = _models(
        cfg, jb, port_cfg=dict(cfg, fused_gnn=fused, fused_heads=fused))
    want = _apply(jmodel, params, jb)
    with torch.no_grad():
        got = tmodel(tb)
    _assert_outputs(got, want, jb, rtol=1e-4, atol=1e-5)


def test_gnn_and_each_head_match_flax():
    cfg = jgm.get_small_model_config()
    jb, tb = _batches(range(4))
    jmodel, params, tmodel = _models(cfg, jb)
    p = params['params']
    jgnn = JaxGNN(out_feats=cfg['graph_node_features'],
                  node_feats=cfg['gnn_width'],
                  n_att=cfg['gnn_attentional_layers'],
                  n_heads=cfg['gnn_attention_heads'],
                  in_feat_names=tuple(cfg['in_feat_name']))
    h_ref = jax.jit(jgnn.apply, static_argnums=4)(
        {'params': p['gnn']}, jb.feats, jb.neighbors, jb.neighbor_mask, True)
    with torch.no_grad():
        h = tmodel.gnn(tb.feats, tb.neighbors, tb.neighbor_mask)
        # every head on the same (JAX) embedding
        h_in = torch.tensor(np.asarray(h_ref))
        w = tmodel.parameter_writer
        heads = {'n2': w.bond_writer(h_in, tb.terms['n2'].idxs),
                 'n3': w.angle_writer(h_in, tb.terms['n3'].idxs),
                 'n4': w.proper_writer(h_in, tb.terms['n4'].idxs),
                 'n4_improper': w.improper_writer(
                     h_in, tb.terms['n4_improper'].idxs)}
    real = np.asarray(jb.node_mask)
    np.testing.assert_allclose(h.numpy()[real], np.asarray(h_ref)[real],
                               rtol=1e-4, atol=1e-5)
    # the full flax model's heads see its own GNN output == h_ref
    want = _apply(jmodel, params, jb)
    got = {'n2_k': heads['n2'][0], 'n2_eq': heads['n2'][1],
           'n3_k': heads['n3'][0], 'n3_eq': heads['n3'][1],
           'n4_k': heads['n4'], 'n4_improper_k': heads['n4_improper']}
    _assert_outputs(got, want, jb, rtol=1e-4, atol=1e-5)


def test_default_model_matches_flax_on_2_molecules():
    """The deployed width: 7 x 512 GNN with 16 heads, depth-3 x 512 heads."""
    cfg = jgm.get_default_model_config()
    jb, tb = _batches([0, 1])
    jmodel, params, tmodel = _models(cfg, jb)
    want = _apply(jmodel, params, jb)
    with torch.no_grad():
        got = tmodel(tb)
    _assert_outputs(got, want, jb, rtol=3e-4, atol=3e-5)


def test_bfloat16_is_refused_not_run_in_float32():
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tgm.make_model(dict(tgm.get_small_model_config(),
                            compute_dtype='bfloat16'))


def test_config_and_statistics_rules_match_jax():
    assert tgm.get_default_model_config() == jgm.get_default_model_config()
    assert tgm.get_small_model_config() == jgm.get_small_model_config()
    with pytest.raises(KeyError):
        tgm.make_model({'no_such_key': 1})
    cfg = tgm.get_small_model_config()
    assert tgm.field_of_view(cfg) == jgm.field_of_view(cfg)
    # eps-on-std: the port's buffers carry the JAX model's statistics
    jstats = stats_from_model(jgm.make_model(cfg))
    sd = tgm.make_model(cfg).state_dict()
    w = 'parameter_writer'
    np.testing.assert_allclose(
        sd[f'{w}.proper_writer.k_std'].numpy()[0],
        jstats['std']['n4_k'][:cfg['n_periodicity_proper']], rtol=1e-7)
    np.testing.assert_allclose(float(sd[f'{w}.bond_writer.to_k.std']),
                               jstats['std']['n2_k'][0], rtol=1e-7)
