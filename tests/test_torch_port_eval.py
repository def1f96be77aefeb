"""The port's evaluation (grappa_tpu_torch.train.eval_model, train.report,
published) against the JAX package's on the same dataset and weights, on
the CPU.

The dataset is two sub-datasets of the JAX package's make_moldata entries,
saved by its Dataset.save and read by both packages, with a classical
force field's energies and gradients stored in the entries (one of them
with a stored nonbonded part to subtract). The weights are the JAX
package's seeded model dict, loaded by both packages' model_from_dict.
Every metric and bootstrap CI at rtol 1e-4: the per-molecule statistics
agree to float32 sums in another order, and both bootstraps draw the same
numpy stream. The classical metrics, the adaptive batch size, the report
tables and the parity verdict are pure numpy / Python on equal inputs:
equal.
"""
import jax
import numpy as np
import pytest
import torch

from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.dataset import Dataset as JaxDataset
from grappa_tpu.data.synthetic import make_moldata
from grappa_tpu.models import grappa_model as jgm
from grappa_tpu import published as jpublished
from grappa_tpu.train import eval_model as jeval
from grappa_tpu.train import export as jexport
from grappa_tpu.train import report as jreport
from grappa_tpu_torch import published as tpublished
from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.train import eval_model as teval
from grappa_tpu_torch.train import export as texport
from grappa_tpu_torch.train import report as treport

RTOL = 1e-4
N_BOOT = 200


def _with_classical(md, seed):
    """A classical force field beside the QM data: the bonded reference
    plus seeded noise, every second molecule with a stored nonbonded
    part (which classical_ff_metrics subtracts)."""
    rng = np.random.default_rng(seed)
    e = md.energy_ref + rng.normal(0, 2.0, md.energy_ref.shape)
    g = md.gradient_ref + rng.normal(0, 3.0, md.gradient_ref.shape)
    md.ff_energy['amber99'] = e.astype(np.float32)
    md.ff_gradient['amber99'] = g.astype(np.float32)
    if seed % 2:
        nb = rng.normal(0, 1.0, e.shape).astype(np.float32)
        md.ff_energy['amber99'] = md.ff_energy['amber99'] + nb
        md.ff_nonbonded_energy['amber99'] = nb
    return md


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """(JAX Dataset, the port's Dataset) read from one directory."""
    entries, names = [], []
    for tag, base in (('spice-dipeptide', 40), ('rna-diverse', 60)):
        for i in range(5):
            entries.append(_with_classical(make_moldata(
                seed=base + i, n_confs=3 + i % 2, ds_name=tag,
                atom_range=(6, 16)), base + i))
            names.append(tag)
    path = tmp_path_factory.mktemp('eval') / 'ds'
    JaxDataset(entries, names).save(path)
    return JaxDataset.load(path), Dataset.load(path)


@pytest.fixture(scope='module')
def models():
    """(JAX model, params) and the port's model from one model dict."""
    cfg = jgm.get_small_model_config()
    jm = jgm.make_model(cfg)
    batch = jax_collate([JaxMolGraph.from_moldata(make_moldata(seed=0,
                                                               n_confs=2))])
    params = jax.jit(jm.init)(jax.random.key(4), batch)
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: np.asarray(a + rng.normal(0, 0.05, a.shape), np.float32),
        jax.device_get(params))
    md = jexport.build_model_dict(params, {'model_config': cfg}, model=jm)
    jm2, jp2, _ = jexport.model_from_dict(md)
    model, _ = texport.model_from_dict(md)
    return (jm2, jp2), model


def _close(got, want, path=''):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, (list, tuple)):
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=path)
    elif isinstance(want, int):
        assert got == want, path
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=path)


@pytest.mark.parametrize('batch_size', [None, 3])
def test_eval_model_matches_jax(data, models, batch_size):
    jds, ds = data
    (jm, jp), model = models
    want = jeval.eval_model(jm, jp, jds, batch_size=batch_size,
                            n_bootstrap=N_BOOT, classical=True)
    timings = {}
    got = teval.eval_model(model, ds, batch_size=batch_size,
                           n_bootstrap=N_BOOT, classical=True, device='cpu',
                           timings=timings)
    assert set(got) == {'grappa_tpu', 'amber99'}
    assert set(got['grappa_tpu']) == {'spice-dipeptide', 'rna-diverse'}
    assert 'rmse_energies_ci' in got['grappa_tpu']['rna-diverse']
    _close(got, want)
    assert timings['batches'] == (1 if batch_size is None else 4)


def test_classical_metrics_and_batch_size_equal(data):
    jds, ds = data
    want = jeval.classical_ff_metrics(jds, n_bootstrap=N_BOOT)
    assert teval.classical_ff_metrics(ds, n_bootstrap=N_BOOT) == want
    assert teval.classical_ff_metrics(ds, ff_names=['amber99'],
                                      n_bootstrap=0) == \
        jeval.classical_ff_metrics(jds, ff_names=['amber99'], n_bootstrap=0)
    for budget in (5e5, 300.0, 1.0):
        assert teval.adaptive_batch_size(ds, budget) == \
            jeval.adaptive_batch_size(jds, budget)


def test_report_and_parity_equal(data, models):
    jds, _ = data
    (jm, jp), _ = models
    results = jeval.eval_model(jm, jp, jds, n_bootstrap=N_BOOT)['grappa_tpu']
    # one dataset near the published numbers, so both verdicts pass there
    results['gen2'] = {'rmse_energies': 1.81, 'crmse_gradients': 3.7,
                       'rmse_energies_ci': [1.7, 1.9]}
    table = {'grappa_tpu (imported)': results,
             'published grappa-1.2': jpublished.GRAPPA_12_TEST_RMSE}
    for with_ci in (False, True):
        assert treport.markdown_table(table, with_ci) == \
            jreport.markdown_table(table, with_ci)
        assert treport.tex_table(table, with_ci) == \
            jreport.tex_table(table, with_ci)
    for rtol in (tpublished.PARITY_RTOL, 0.0, 1e3):
        assert tpublished.parity_verdict(results, rtol) == \
            jpublished.parity_verdict(results, rtol)
    assert tpublished.GRAPPA_12_TEST_RMSE == jpublished.GRAPPA_12_TEST_RMSE
    assert tpublished.PARITY_RTOL == jpublished.PARITY_RTOL


def test_plots_and_device(data, models, tmp_path, monkeypatch):
    """plot_dir is not ported: it raises and names the roadmap item; the
    default device is the card, never the CPU by itself."""
    _, ds = data
    _, model = models
    with pytest.raises(NotImplementedError, match='item 7'):
        teval.eval_model(model, ds, plot_dir=tmp_path, device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.eval_model(model, ds)
