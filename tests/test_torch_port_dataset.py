"""The port's host data layer for training (grappa_tpu_torch.data.dataset,
data.loader.GraphLoader, native) against the JAX package's on the CPU.

Data: the JAX package's make_moldata / make_dataset, handed to the port by
MolData.to_dict -> the port's MolData.from_dict. Tolerance: none. Splits,
batches and the native pre-processing are integer bookkeeping and float32
copies, so every id and every array must be equal; the loaders draw from one
numpy generator in the same order, so the same seed gives the same batches.
"""
import threading

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu import native as jax_native
from grappa_tpu.data.dataset import Dataset as JaxDataset
from grappa_tpu.data.dataset import calc_split_ids as jax_calc_split_ids
from grappa_tpu.data.dataset import k_fold_split_ids as jax_k_fold
from grappa_tpu.data.graph_batch import TERMS
from grappa_tpu.data.loader import GraphLoader as JaxGraphLoader
from grappa_tpu.data.synthetic import make_moldata as jax_make_moldata
from grappa_tpu.data.synthetic import random_molecule as jax_random_molecule
from grappa_tpu_torch import graph_features, native, topology
from grappa_tpu_torch.data import graph_batch
from grappa_tpu_torch.data.dataset import (
    Dataset, calc_split_ids, k_fold_split_ids, load_split, save_split)
from grappa_tpu_torch.data.loader import GraphLoader
from grappa_tpu_torch.data.moldata import MolData


def _jax_entries():
    """Two subdatasets of molecules with 3-12 conformers, one molecule id
    shared by both (the same molecule in two subdatasets)."""
    small = [jax_make_moldata(seed=s, n_confs=3 + (s % 4) * 3, ds_name='a',
                              atom_range=(6, 14)) for s in range(7)]
    big = [jax_make_moldata(seed=100 + s, n_confs=4 + s, ds_name='b',
                            atom_range=(14, 24)) for s in range(5)]
    big[0].mol_id = small[0].mol_id
    return small + big, ['a'] * 7 + ['b'] * 5


@pytest.fixture(scope='module')
def datasets():
    entries, names = _jax_entries()
    port = Dataset([MolData.from_dict(e.to_dict()) for e in entries], names)
    return JaxDataset(entries, names), port


def _assert_batch_equal(got, want):
    assert got.num_mols == want.num_mols
    for name in ('node_mask', 'node_mol', 'neighbors', 'neighbor_mask', 'xyz',
                 'conf_mask', 'energy_ref', 'gradient_ref'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert sorted(got.feats) == sorted(want.feats)
    for k in want.feats:
        np.testing.assert_array_equal(got.feats[k].numpy(),
                                      np.asarray(want.feats[k]), err_msg=k)
    for t in TERMS:
        for name in ('idxs', 'mask', 'mol', 'k_ref', 'eq_ref'):
            a, b = getattr(got.terms[t], name), getattr(want.terms[t], name)
            assert (a is None) == (b is None), (t, name)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f'{t}.{name}')


@pytest.mark.parametrize('partition', [
    (0.8, 0.1, 0.1), (0.5, 0.5, 0.0),
    {'a': (0.6, 0.2, 0.2), 'default': (0.34, 0.33, 0.33)}],
    ids=['triple', 'no-test', 'per-dataset'])
@pytest.mark.parametrize('existing', [False, True])
def test_calc_split_ids_matches_jax(datasets, partition, existing):
    jds, _ = datasets
    ids = {}
    for e, n in zip(jds.entries, jds.ds_names):
        ids.setdefault(n, []).append(e.mol_id)
    prior = ({'train': [ids['a'][1]], 'val': [ids['b'][2]], 'test': []}
             if existing else None)
    want = jax_calc_split_ids(ids, partition, seed=3, existing_split=prior)
    got = calc_split_ids(ids, partition, seed=3, existing_split=prior)
    assert got == want


@pytest.mark.parametrize('by_dataset', [False, True])
def test_k_fold_split_ids_matches_jax(datasets, by_dataset):
    jds, _ = datasets
    if by_dataset:
        ids = {}
        for e, n in zip(jds.entries, jds.ds_names):
            ids.setdefault(n, []).append(e.mol_id)
    else:
        ids = jds.mol_ids
    assert k_fold_split_ids(ids, 4, seed=5) == jax_k_fold(ids, 4, seed=5)


def test_dataset_save_loads_in_either_package(datasets, tmp_path):
    jds, port = datasets
    jds.save(tmp_path / 'from_jax')
    port.save(tmp_path / 'from_port')
    for loaded, ref in ((Dataset.load(tmp_path / 'from_jax'), jds),
                        (JaxDataset.load(tmp_path / 'from_port'), port)):
        assert loaded.ds_names == ref.ds_names
        assert loaded.mol_ids == ref.mol_ids
        for a, b in zip(loaded.entries, ref.entries):
            da, db = a.to_dict(), b.to_dict()
            assert sorted(da) == sorted(db)
            for k in da:
                np.testing.assert_array_equal(np.asarray(da[k]),
                                              np.asarray(db[k]), err_msg=k)
    split = calc_split_ids({'a': port.mol_ids}, seed=1)
    save_split(split, tmp_path / 'split.json')
    assert load_split(tmp_path / 'split.json') == split
    tr, vl, te = port.split(split['train'], split['val'], split['test'])
    jtr, jvl, jte = jds.split(split['train'], split['val'], split['test'])
    for a, b in ((tr, jtr), (vl, jvl), (te, jte)):
        assert a.mol_ids == b.mol_ids and a.ds_names == b.ds_names
    assert port.subsampled(0.5, seed=2).mol_ids == \
        jds.subsampled(0.5, seed=2).mol_ids
    assert port.shuffled(seed=4).mol_ids == jds.shuffled(seed=4).mol_ids
    assert port.where('b').mol_ids == jds.where('b').mol_ids


LOADER_CASES = {
    'sequential-buckets': dict(shuffle=False, batch_size=5),
    'sequential-fixed-min': dict(shuffle=False, batch_size=4,
                                 conf_strategy='min', fixed_pad=True),
    'shuffled-fixed-int': dict(shuffle=True, batch_size=4, conf_strategy=5),
    'shuffled-buckets-max': dict(shuffle=True, batch_size=3,
                                 conf_strategy='max', fixed_pad=False),
    'shuffled-mean': dict(shuffle=True, batch_size=3, conf_strategy='mean',
                          fixed_pad=False, drop_last=True),
    'weights': dict(shuffle=True, batch_size=4, conf_strategy=6,
                    weights={'b': 3.0}),
    'balance': dict(shuffle=True, batch_size=5, conf_strategy='all',
                    balance_factor=0.5, drop_last=True),
}


@pytest.mark.parametrize('case', sorted(LOADER_CASES))
def test_graph_loader_batches_match_jax(datasets, case):
    """Two epochs: the epoch orders, the conformer draws and the padded
    shapes continue one numpy stream in both packages."""
    jds, port = datasets
    kw = LOADER_CASES[case]
    jl = JaxGraphLoader(jds, seed=7, **kw)
    pl = GraphLoader(port, seed=7, device='cpu', **kw)
    assert len(pl) == len(jl)
    for _ in range(2):
        want = list(jl)
        got = list(pl)
        assert len(got) == len(want) > 0
        for (gb, gn), (wb, wn) in zip(got, want):
            assert gn == wn
            _assert_batch_equal(gb, wb)


def test_graph_loader_guards_and_device(datasets):
    _, port = datasets
    with pytest.raises(ValueError):
        GraphLoader(port, shuffle=False, balance_factor=0.5, device='cpu')
    with pytest.raises(ValueError):
        GraphLoader(port, shuffle=False, weights={'b': 2.0}, device='cpu')
    with pytest.raises(ValueError):
        GraphLoader(port, pad_ratio=0.9, device='cpu')
    # weighted draws put the largest molecule in a batch batch_size times:
    # the fixed spec holds that
    loader = GraphLoader(port, batch_size=3, conf_strategy=4,
                         weights={'b': 100.0}, seed=0, drop_last=True,
                         device='cpu')
    biggest = max(g.n_atoms for g in port.graphs())
    assert loader._fixed_pad_spec(4).n_nodes >= 3 * biggest
    for batch, _ in loader:
        assert batch.num_mols == 3 and batch.xyz.device.type == 'cpu'


def test_abandoned_iterator_joins_its_producer(datasets):
    _, port = datasets
    loader = GraphLoader(port, batch_size=2, conf_strategy=4, seed=0,
                         device='cpu')
    before = set(threading.enumerate())
    it = iter(loader)
    next(it)
    it.close()          # abandon mid-epoch: the generator's finally joins
    leaked = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not leaked, leaked
    assert sum(1 for _ in loader) == len(loader)


def _ring_bonds(n_rings=6, size=6):
    """Fused and bridged rings of 3-8 atoms with a tail: every column of
    the ring encoding is hit."""
    bonds, start = [], 0
    for r in range(n_rings):
        k = 3 + (size + r) % 6
        atoms = list(range(start, start + k))
        bonds += [(atoms[i], atoms[(i + 1) % k]) for i in range(k)]
        if r:
            bonds.append((start - 1, start))
        start += k
    bonds += [(start - 1, start), (start, start + 1), (2, 5)]
    return np.asarray(bonds), start + 2


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_native_matches_python_and_jax(seed, monkeypatch, tmp_path):
    assert native.available(), 'g++ builds the native library here'
    # the JAX package builds its library straight to its shared path, so
    # test workers that build it at once can load a half-written file:
    # give it a private path, built anew here
    monkeypatch.setattr(jax_native, '_LIB_PATH',
                        tmp_path / 'libgraph_preproc.so')
    monkeypatch.setattr(jax_native, '_lib', None)
    monkeypatch.setattr(jax_native, '_tried', False)
    assert jax_native.available(), \
        "g++ failed to build the JAX package's native library"
    mol = jax_random_molecule(seed=seed, n_atoms=60)
    cases = [(mol.bonds_by_index(), len(mol.atoms)), _ring_bonds(4 + seed)]
    for bonds, n in cases:
        angles, propers = native.enumerate_tuples(bonds)
        py_a, py_p = topology.enumerate_angles_propers(
            [tuple(b) for b in bonds])
        ja, jp = jax_native.enumerate_tuples(bonds)
        np.testing.assert_array_equal(angles, np.asarray(py_a).reshape(-1, 3))
        np.testing.assert_array_equal(propers, np.asarray(py_p).reshape(-1, 4))
        np.testing.assert_array_equal(angles, ja)
        np.testing.assert_array_equal(propers, jp)
        assert angles.dtype == ja.dtype == np.int32

        nb, mask = native.neighbor_list(bonds, n, 8)
        jnb, jmask = jax_native.neighbor_list(bonds, n, 8)
        np.testing.assert_array_equal(nb, jnb)
        np.testing.assert_array_equal(mask, jmask)

        ring = native.ring_encoding(bonds, n)
        np.testing.assert_array_equal(ring, jax_native.ring_encoding(bonds, n))

        # the Python paths, with the library switched off
        with monkeypatch.context() as m:
            m.setattr(native, 'get_lib', lambda: None)
            assert native.enumerate_tuples(bonds) is None
            pnb, pmask = graph_batch.build_neighbor_list(bonds, n, 8)
            np.testing.assert_array_equal(pnb, nb)
            np.testing.assert_array_equal(pmask, mask)
            np.testing.assert_array_equal(
                graph_features.ring_encoding(bonds, n), ring)
            a64, p64 = topology.enumerate_angles_propers_fast(
                [tuple(b) for b in bonds])
            np.testing.assert_array_equal(a64, angles)
            np.testing.assert_array_equal(p64, propers)
    assert ring[:, 0].any() and ring[:, 1:].any(axis=0).sum() >= 4
    with pytest.raises(IndexError):
        native.neighbor_list(np.array([[0, 5]]), 3, 8)


def test_native_is_the_port_own_build(monkeypatch):
    """The library is built under grappa_tpu_torch/build, never loaded
    from native/, and GRAPPA_TPU_NO_NATIVE switches it off."""
    assert native.get_lib() is not None
    path = native._lib_path()
    assert path.parent.name == 'build' and path.parent.parent.name == \
        'grappa_tpu_torch' and path.exists()
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_tried', False)
    monkeypatch.setenv('GRAPPA_TPU_NO_NATIVE', '1')
    assert native.get_lib() is None and not native.available()
