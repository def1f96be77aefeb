"""The port's checkpoint import (grappa_tpu_torch.train.torch_compat and
export.model_from_dict) against the JAX package's on the same files.

The files are what the JAX package exports from seeded weights (flax init
plus seeded numpy noise, so no branch is zero): a reference-format state
dict with every alias and buffer, a buffer-less one (build_model_dict
without the model) and the same state dict with DGL's `fc_src` name and
without the `gnn.blocks.{i}` aliases. The audit must reject, and warn
about, the same inputs as `grappa_tpu.train.torch_compat.import_state_dict`
(tests/test_checkpoint_audit.py's cases), and every file the JAX package
loads must load in the port and predict what the JAX model predicts from
it, within rtol 3e-4 / atol 3e-5 (the repo's default parity tolerance:
float32 sums in another order).
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.loader import bucketed_pad_spec as jax_pad_spec
from grappa_tpu.data.synthetic import random_molecule
from grappa_tpu.models import grappa_model as jgm
from grappa_tpu.train import export as jexport
from grappa_tpu.train import torch_compat as jtc
from grappa_tpu_torch import Grappa
from grappa_tpu_torch.data import MolGraph, Molecule, collate
from grappa_tpu_torch.data.loader import bucketed_pad_spec
from grappa_tpu_torch.models.grappa_model import make_model
from grappa_tpu_torch.train import export as texport
from grappa_tpu_torch.train import torch_compat as ttc

RTOL, ATOL = 3e-4, 3e-5
PERMS = ('parameter_writer.improper_writer.torsion_model'
         '.symmetriser.permutations')


@pytest.fixture(scope='module')
def exported():
    """(config, JAX model, seeded params, the JAX package's model dict with
    its scaler buffers)."""
    cfg = jgm.get_small_model_config()
    jm = jgm.make_model(cfg)
    jb, _ = _batches()
    params = jax.jit(jm.init)(jax.random.key(0), jb)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a + rng.normal(0, 0.05, a.shape), np.float32),
        jax.device_get(params))
    md = jexport.build_model_dict(params, {'model_config': cfg}, model=jm)
    return cfg, jm, params, md


def _batches(seeds=(21, 22, 23)):
    """The same three molecules as a JAX batch and as the port's."""
    jms = [random_molecule(seed=s) for s in seeds]
    jg = [JaxMolGraph.from_molecule(m) for m in jms]
    tg = [MolGraph.from_molecule(Molecule.from_dict(m.to_dict()))
          for m in jms]
    return (jax_collate(jg, pad=jax_pad_spec(jg, 1), n_confs=1),
            collate(tg, pad=bucketed_pad_spec(tg, 1), n_confs=1,
                    device='cpu'))


def _sd(md):
    return dict(md['state_dict'])


def _both_raise(sd, cfg, exc, match):
    with pytest.raises(exc, match=match):
        jtc.import_state_dict(sd, cfg)
    with pytest.raises(exc, match=match):
        ttc.import_state_dict(sd, cfg)


def _predicts_like_jax(model_dict):
    """The file through the JAX package's model_from_dict and through the
    port's (model_from_dict and Grappa.from_model_dict): equal forwards."""
    jb, tb = _batches()
    jm, jp, _ = jexport.model_from_dict(model_dict)
    want = jax.jit(jm.apply)(jp, jb)
    model, _ = texport.model_from_dict(model_dict)
    ff = Grappa.from_model_dict(model_dict, device='cpu')
    for m in (model, ff.model):
        with torch.no_grad():
            got = m.eval()(tb)
        for key, w in want.items():
            np.testing.assert_allclose(got[key].numpy(), np.asarray(w),
                                       rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize('small', [True, False])
def test_expected_keys_match_jax_and_the_port_model(small):
    cfg = (jgm.get_small_model_config() if small
           else jgm.get_default_model_config())
    keys = ttc.expected_reference_keys(cfg)
    assert keys == jtc.expected_reference_keys(cfg)
    assert set(make_model(cfg).state_dict()) == keys


def test_import_keeps_the_files_tensors(exported):
    cfg, _, _, md = exported
    with warnings.catch_warnings():
        warnings.simplefilter('error')     # nothing left unused
        sd, stats = ttc.import_state_dict(_sd(md), cfg)
    assert set(sd) == set(md['state_dict'])
    for key, v in md['state_dict'].items():
        assert torch.equal(sd[key], torch.as_tensor(np.asarray(v))), key
    _, jstats = jtc.import_state_dict(_sd(md), cfg)
    for m in ('mean', 'std'):
        for key, v in jstats[m].items():
            np.testing.assert_array_equal(stats[m][key], v, err_msg=key)
    # the loaded model's buffers read back as the same statistics
    model, _ = texport.model_from_dict(md)
    got = ttc.stats_from_model(model)
    for m in ('mean', 'std'):
        for key, v in jstats[m].items():
            np.testing.assert_array_equal(got[m][key], v, err_msg=key)


@pytest.mark.parametrize('victims', [
    ('gnn.pre_dense.0.weight', 'gnn.att_blocks.1.head_reducer.bias',
     'parameter_writer.angle_writer.angle_model.symmetriser.mlp.1.linear2'
     '.weight'),
    ('parameter_writer.bond_writer.to_k.std',
     'parameter_writer.proper_writer.k_std'),
])
def test_missing_keys_reported_together(exported, victims):
    """Every missing key in one KeyError, the same set as the JAX package
    (scaler buffers count as missing when they are required)."""
    cfg, _, _, md = exported
    sd = {k: v for k, v in md['state_dict'].items() if k not in victims}
    with pytest.raises(KeyError) as jexc:
        jtc.import_state_dict(sd, cfg)
    with pytest.raises(KeyError) as texc:
        ttc.import_state_dict(sd, cfg)
    for v in victims:
        assert v in str(jexc.value) and v in str(texc.value), v
    assert str(texc.value).split(': ', 1)[0] == \
        str(jexc.value).split(': ', 1)[0]


def test_unused_keys_warned_like_jax(exported):
    cfg, _, _, md = exported
    sd = _sd(md)
    sd['parameter_writer.bond_writer.some_new_buffer'] = torch.zeros(3)
    sd['gnn.blocks.9.layer_norm.weight'] = torch.zeros(3)
    caught = {}
    for name, fn in (('jax', jtc.import_state_dict),
                     ('port', ttc.import_state_dict)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            fn(sd, cfg)
        caught[name] = [str(x.message) for x in w]
    assert len(caught['port']) == 1
    assert 'some_new_buffer' in caught['port'][0]
    assert caught['port'] == caught['jax']


@pytest.mark.parametrize('case', ['permutations', 'alias', 'n_periodicity',
                                  'min_', 'positional_encoding'])
def test_foreign_conventions_rejected(exported, case):
    cfg, _, _, md = exported
    sd = _sd(md)
    if case == 'permutations':
        sd[PERMS] = torch.tensor([[0, 1, 2, 3], [1, 0, 2, 3]],
                                 dtype=torch.int32)
        match = 'permutation'
    elif case == 'alias':
        key = 'gnn.blocks.1.head_reducer.weight'
        sd[key] = torch.as_tensor(np.asarray(sd[key])) + 1e-3
        match = 'alias'
    elif case == 'n_periodicity':
        sd['parameter_writer.proper_writer.n_periodicity'] = \
            torch.tensor(4)
        match = 'n_periodicity'
    elif case == 'min_':
        sd['parameter_writer.bond_writer.to_k.min_'] = torch.tensor(0.5)
        match = 'min_'
    else:
        sd['parameter_writer.angle_writer.angle_model.grappa_transformer'
           '.positional_encoding'] = torch.tensor([[1.0], [0.0], [0.0]])
        match = 'positional encoding'
    _both_raise(sd, cfg, ValueError, match)
    with pytest.raises(ValueError, match=match):
        texport.model_from_dict({'state_dict': sd, 'config': md['config']})


def test_roundtrip_model_dict_predicts_like_jax(exported):
    _predicts_like_jax(exported[3])


def test_bufferless_model_dict_loads(exported):
    """Fault 1: a model dict without scaler buffers (build_model_dict with
    no model) loads, with the config's default statistics, as in JAX."""
    cfg, _, params, _ = exported
    md = jexport.build_model_dict(params, {'model_config': cfg})
    assert not any(k.endswith(('.k_std', 'to_k.std'))
                   for k in md['state_dict'])
    sd, stats = ttc.import_state_dict(_sd(md), cfg, require_buffers=False)
    assert stats is None
    _predicts_like_jax(md)


def test_fc_src_model_dict_loads(exported):
    """Fault 2: DGL's bipartite name `graph_module.fc_src` for the
    attention projection."""
    _, _, _, md = exported
    sd = {k.replace('graph_module.fc.', 'graph_module.fc_src.'): v
          for k, v in md['state_dict'].items()}
    assert any('fc_src' in k for k in sd)
    _predicts_like_jax({'state_dict': sd, 'config': md['config']})


def test_aliasless_model_dict_loads(exported):
    """Fault 3: a state dict without the `gnn.blocks.{i}` registration
    aliases; the port's module tree registers them, so they are filled
    from their source."""
    _, _, _, md = exported
    sd = {k: v for k, v in md['state_dict'].items()
          if not k.startswith('gnn.blocks.')}
    sd_port, _ = ttc.import_state_dict(sd, md['config']['model_config'])
    for key in md['state_dict']:
        if key.startswith('gnn.blocks.'):
            assert key in sd_port, key
    _predicts_like_jax({'state_dict': sd, 'config': md['config']})
