"""Model evaluation with bootstrapped confidence intervals.

Counterpart of `grappa_tpu.train.eval_model` (reference: src/grappa/
training/eval_model.py:78-301 and evaluation.py:164-408): per-dataset
energy / force metrics with molecule-level bootstrap CIs, for the model
(`eval_model`) and for the classical force fields whose energies and
gradients the dataset entries store (`classical_ff_metrics`). The
bootstrap draws from `np.random.default_rng(seed)` as the JAX package
does, so both give the same intervals for the same per-molecule
statistics, and results sit under the JAX package's keys. The parameter
and prediction scatter plots (`plot_dir`) need `plotting.py`, which is
not ported yet (ROADMAP.md §1 item 7).
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.data.loader import GraphLoader
from grappa_tpu_torch.train.evaluator import _per_mol_full_stats
from grappa_tpu_torch.train.trainer import make_eval_step
from grappa_tpu_torch.utils import resolve_device


_ACC_KEYS = ('e_se', 'e_ae', 'n_e', 'g_se', 'g_ae_vec', 'n_vec',
             'eref_sum', 'eref_sq', 'gref_sum', 'gref_sq')
# metric keys that get bootstrap CIs (reference eval_model.py METRIC_KEYS)
_METRIC_KEYS = ('rmse_energies', 'rmse_gradients', 'crmse_gradients',
                'mae_energies', 'mae_gradients')


def _metrics_from_acc(acc: Dict[str, np.ndarray], idx=None) -> Dict[str, float]:
    """Pooled metric set from per-molecule accumulators (reference
    Evaluator.get_metrics, evaluation.py:360-384): rmse/mae of centered
    energies, invariant (per-3-vector) gradient rmse/mae, component crmse,
    and the std of the reference values."""
    a = {k: (v[idx] if idx is not None else v) for k, v in acc.items()}
    n_e = max(a['n_e'].sum(), 1.0)
    n_vec = max(a['n_vec'].sum(), 1.0)
    n_comp = 3.0 * n_vec
    g_rmse = float(np.sqrt(a['g_se'].sum() / n_vec))
    eref_var = a['eref_sq'].sum() / n_e - (a['eref_sum'].sum() / n_e) ** 2
    gref_var = (a['gref_sq'].sum() / n_comp
                - (a['gref_sum'].sum() / n_comp) ** 2)
    return {
        'rmse_energies': float(np.sqrt(a['e_se'].sum() / n_e)),
        'mae_energies': float(a['e_ae'].sum() / n_e),
        'rmse_gradients': g_rmse,
        'crmse_gradients': g_rmse / float(np.sqrt(3.0)),
        'mae_gradients': float(a['g_ae_vec'].sum() / n_vec),
        'std_energies': float(np.sqrt(max(eref_var, 0.0))),
        'std_gradients': float(np.sqrt(max(gref_var, 0.0) * 3.0)),
    }


class BootstrapEvaluator:
    """Accumulates per-molecule error statistics; pools the full reference
    Evaluator metric set with molecule-level bootstrap CIs."""

    def __init__(self):
        self._data = defaultdict(lambda: {k: [] for k in _ACC_KEYS})

    def step(self, batch, energy, gradient, ds_names: Sequence[str]):
        with torch.no_grad():
            full = _per_mol_full_stats(batch, energy, gradient)
            # one device-to-host copy for all of the batch's statistics
            stacked = torch.stack([full[k] for k in _ACC_KEYS]).cpu().numpy()
        stats = dict(zip(_ACC_KEYS, stacked))
        for i, name in enumerate(ds_names):
            d = self._data[name]
            for k in _ACC_KEYS:
                d[k].append(float(stats[k][i]))

    def add_molecule(self, ds_name: str, **stats: float):
        d = self._data[ds_name]
        for k in _ACC_KEYS:
            d[k].append(float(stats.get(k, 0.0)))

    def pool(self, n_bootstrap: int = 1000, seed: int = 0
             ) -> Dict[str, Dict[str, float]]:
        rng = np.random.default_rng(seed)
        metrics: Dict[str, Dict[str, float]] = {}
        for name, d in self._data.items():
            acc = {k: np.asarray(v, np.float64) for k, v in d.items()}
            entry = _metrics_from_acc(acc)
            entry['n_mols'] = int(len(acc['e_se']))
            entry['n_confs'] = int(acc['n_e'].sum())
            n = entry['n_mols']
            if n_bootstrap and n > 1:
                boot = {k: [] for k in _METRIC_KEYS}
                for _ in range(n_bootstrap):
                    idx = rng.integers(0, n, n)
                    m = _metrics_from_acc(acc, idx)
                    for k in _METRIC_KEYS:
                        boot[k].append(m[k])
                for k in _METRIC_KEYS:
                    entry[f'{k}_ci'] = [float(np.percentile(boot[k], 2.5)),
                                        float(np.percentile(boot[k], 97.5))]
            metrics[name] = entry
        return metrics


def classical_ff_metrics(dataset: Dataset,
                         ff_names: Optional[List[str]] = None,
                         n_bootstrap: int = 1000) -> Dict[str, Dict]:
    """Metrics of the classical force fields stored in the dataset entries
    (bonded part: the stored nonbonded energy / gradient subtracted)
    against the QM reference targets; no model involved."""
    evaluators: Dict[str, BootstrapEvaluator] = {}
    for entry, ds_name in zip(dataset.entries, dataset.ds_names):
        names = ff_names or [n for n in entry.ff_energy if n != 'qm']
        for ff in names:
            if ff not in entry.ff_energy:
                continue
            e = np.asarray(entry.ff_energy[ff], np.float64)
            e_ref = np.asarray(entry.energy_ref, np.float64)
            nb = entry.ff_nonbonded_energy.get(ff)
            if nb is not None:
                e = e - np.asarray(nb, np.float64)
            e_c = e - e.mean()
            ref_c = e_ref - e_ref.mean()
            stats = {
                'e_se': float(((e_c - ref_c) ** 2).sum()),
                'e_ae': float(np.abs(e_c - ref_c).sum()),
                'n_e': float(len(e)),
                'eref_sum': float(ref_c.sum()),
                'eref_sq': float((ref_c ** 2).sum()),
            }
            g = entry.ff_gradient.get(ff)
            if g is not None:
                g = np.asarray(g, np.float64)
                nbg = entry.ff_nonbonded_gradient.get(ff)
                if nbg is not None:
                    g = g - np.asarray(nbg, np.float64)
                g_ref = np.asarray(entry.gradient_ref, np.float64)
                diff = g - entry.gradient_ref
                stats.update({
                    'g_se': float((diff ** 2).sum()),
                    'g_ae_vec': float(np.sqrt((diff ** 2).sum(axis=-1)).sum()),
                    'n_vec': float(g.shape[0] * g.shape[1]),
                    'gref_sum': float(g_ref.sum()),
                    'gref_sq': float((g_ref ** 2).sum()),
                })
            evaluators.setdefault(ff, BootstrapEvaluator()).add_molecule(
                ds_name, **stats)
    return {ff: ev.pool(n_bootstrap) for ff, ev in evaluators.items()}


def adaptive_batch_size(dataset: Dataset, forces_per_batch: float = 5e5,
                        conf_cap: int = 512) -> int:
    """Batch size from a compute budget: about forces_per_batch =
    batch * max_confs * max_atoms (reference eval_model.py's adaptive
    batching by forces_per_batch)."""
    max_atoms = max((len(e.molecule.atoms) for e in dataset.entries),
                    default=1)
    max_confs = min(conf_cap, max((e.n_confs for e in dataset.entries),
                                  default=1))
    return max(1, int(forces_per_batch / max(1, max_confs * max_atoms)))


def eval_model(model: torch.nn.Module, dataset: Dataset,
               batch_size: Optional[int] = None, conf_strategy='max',
               n_bootstrap: int = 1000, classical: bool = False,
               forces_per_batch: float = 5e5, plot_dir=None, device=None,
               timings: Optional[Dict[str, float]] = None) -> Dict:
    """Evaluate a parameter model on a dataset: {'grappa_tpu': {dataset:
    metrics}} (rmse / mae of centred energies, invariant rmse / mae and
    component rmse of forces, reference stds, bootstrap CIs), and with
    `classical` the stored classical force fields' metrics beside it.

    Runs on `device` (CUDA unless the caller asks for another; the model is
    moved there): a sequential GraphLoader, the model's forward in eval
    mode (the fused kernels on a card) and the energies and dE/dx of its
    parameters. batch_size defaults to `adaptive_batch_size`. `timings`,
    when given, receives the seconds spent waiting on the loader
    ('loader_s'), in the steps and their host copies ('step_s') and in the
    bootstrap ('pool_s'), the batch count ('batches') and size
    ('batch_size')."""
    if plot_dir is not None:
        raise NotImplementedError(
            "eval_model(plot_dir=...): the scatter plots need plotting.py, "
            "which is not ported yet (ROADMAP.md §1 item 7)")
    device = resolve_device(device)
    if batch_size is None:
        batch_size = adaptive_batch_size(dataset, forces_per_batch)
    step = make_eval_step(model.to(device))
    loader = GraphLoader(dataset, batch_size=batch_size,
                         conf_strategy=conf_strategy, shuffle=False,
                         device=device)
    evaluator = BootstrapEvaluator()
    t = {'loader_s': 0.0, 'step_s': 0.0, 'batches': 0,
         'batch_size': batch_size}
    mark = time.perf_counter()
    for batch, ds_names in loader:
        got = time.perf_counter()
        energy, gradient = step(batch)
        evaluator.step(batch, energy, gradient, ds_names)
        done = time.perf_counter()
        t['loader_s'] += got - mark
        t['step_s'] += done - got
        t['batches'] += 1
        mark = done
    results = {'grappa_tpu': evaluator.pool(n_bootstrap)}
    if classical:
        results.update(classical_ff_metrics(dataset, n_bootstrap=n_bootstrap))
    t['pool_s'] = time.perf_counter() - mark
    if timings is not None:
        timings.update(t)
    return results
