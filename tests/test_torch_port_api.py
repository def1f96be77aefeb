"""The port's Grappa API (grappa_tpu_torch.api) against the JAX package's
Grappa.predict_many on the same weights (CPU, device='cpu').

The JAX model's weights (flax init, perturbed with seeded numpy noise so no
branch is zero) cross over as the JAX package exports them: the
`{state_dict, config}` model dict of grappa_tpu.train.export, loaded by the
port's Grappa.from_model_dict. Every Parameters array is compared: ids
exactly, parameters with rtol 1e-4 / atol 1e-5 (float32, small config).
Torsion entries that the hard cutoff (|k| > 1e-4) zeroes on one side only
are left out: there a last-ulp difference flips k and its phase.
"""
import jax
import numpy as np
import pytest
import torch

from grappa_tpu.api import Grappa as JaxGrappa
from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.synthetic import random_molecule
from grappa_tpu.models.grappa_model import get_small_model_config, make_model
from grappa_tpu.train.export import build_model_dict
from grappa_tpu_torch import Grappa, Molecule

CUTOFF = 1e-4
IDS = ('atoms', 'bonds', 'angles', 'propers', 'impropers')
VALUES = ('bond_k', 'bond_eq', 'angle_k', 'angle_eq')
TORSIONS = (('proper_ks', 'proper_phases'),
            ('improper_ks', 'improper_phases'))


@pytest.fixture(scope='module')
def pair():
    """(JAX Grappa, the port's Grappa on the CPU) with the same weights."""
    cfg = get_small_model_config()
    model = make_model(cfg)
    batch = jax_collate([JaxMolGraph.from_molecule(random_molecule(seed=0))])
    params = jax.jit(model.init)(jax.random.key(0), batch)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: jax.numpy.asarray(a + rng.normal(0, 0.05, a.shape),
                                    np.float32), jax.device_get(params))
    model_dict = build_model_dict(params, {'model_config': cfg}, model=model)
    return (JaxGrappa(model, params, {'model_config': cfg}),
            Grappa.from_model_dict(model_dict, device='cpu'))


def test_predict_many_matches_jax(pair):
    jax_ff, ff = pair
    mols = [random_molecule(seed=s, atom_range=(8, 30)) for s in range(6)]
    want = jax_ff.predict_many(mols, check_eq_values=False)
    got = ff.predict_many([Molecule.from_dict(m.to_dict()) for m in mols],
                          check_eq_values=False)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for name in IDS:
            np.testing.assert_array_equal(getattr(g, name),
                                          getattr(w, name), err_msg=name)
        for name in VALUES:
            np.testing.assert_allclose(getattr(g, name), getattr(w, name),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
        for ks, phases in TORSIONS:
            a, b = getattr(g, ks), getattr(w, ks)
            assert a.shape == b.shape, ks
            keep = (a > CUTOFF) == (b > CUTOFF)
            assert keep.size == 0 or keep.mean() > 0.99, ks
            np.testing.assert_allclose(a[keep], b[keep], rtol=1e-4,
                                       atol=1e-5, err_msg=ks)
            np.testing.assert_array_equal(
                getattr(g, phases)[keep & (a > CUTOFF)],
                getattr(w, phases)[keep & (b > CUTOFF)], err_msg=phases)


def test_predict_equals_predict_many_and_field_of_view(pair):
    jax_ff, ff = pair
    mol = Molecule.from_dict(random_molecule(seed=7).to_dict())
    one = ff.predict(mol, check_eq_values=False)
    many = ff.predict_many([mol, mol], check_eq_values=False)
    for p in many:
        np.testing.assert_allclose(p.bond_k, one.bond_k, rtol=1e-5)
        np.testing.assert_allclose(p.proper_ks, one.proper_ks, rtol=1e-5,
                                   atol=1e-7)
    assert ff.field_of_view == jax_ff.field_of_view


def test_disconnected_molecule_is_refused(pair):
    _, ff = pair
    mol = Molecule(atoms=[0, 1, 2, 3], bonds=[(0, 1), (2, 3)], impropers=[],
                   atomic_numbers=[6, 6, 6, 6],
                   partial_charges=[0.0, 0.0, 0.0, 0.0])
    with pytest.raises(ValueError, match='disconnected'):
        ff.predict(mol)


def test_grappa_runs_on_the_card_unless_told_otherwise(pair, monkeypatch):
    _, ff = pair
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Grappa(ff.model)
    assert Grappa(ff.model, device='cpu').device.type == 'cpu'
