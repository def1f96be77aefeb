"""Model evaluation with bootstrapped confidence intervals.

Counterpart of `grappa_tpu.train.eval_model`'s `BootstrapEvaluator` and
`_metrics_from_acc` (reference: src/grappa/training/eval_model.py:78-301
and evaluation.py:164-408): per-dataset energy / force metrics with
molecule-level bootstrap CIs. The bootstrap draws from
`np.random.default_rng(seed)` as the JAX package does, so both give the
same intervals for the same per-molecule statistics. The rest of the JAX
module (classical force-field metrics, `eval_model`) is queued (ROADMAP.md).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence

import numpy as np
import torch

from grappa_tpu_torch.train.evaluator import _per_mol_full_stats


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
