"""Streaming per-dataset metrics (energy / force RMSEs).

Counterpart of `grappa_tpu.train.evaluator`, with the same metric
definitions: per-dataset RMSE of centred energies per conformation, gradient
RMSE per 3-vector, component RMSE (crmse = rmse / sqrt(3)), and an
equal-weight 'avg' across datasets. The per-molecule reductions run on the
batch's device and reach the host in one copy per `step`; the small
per-dataset dictionary lives on the host.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence

import numpy as np
import torch

from grappa_tpu_torch.data.graph_batch import GraphBatch
from grappa_tpu_torch.models import mm_energy


def _conf_mask_per_node(batch: GraphBatch) -> torch.Tensor:
    """(N, C) float: the node's molecule's conformer mask, 0 on padding."""
    mol = batch.node_mol.long().clamp_max(batch.num_mols - 1)
    return (batch.conf_mask[mol] & batch.node_mask[:, None]).float()


def _per_mol_sqerr(batch: GraphBatch, energy: torch.Tensor,
                   gradient: torch.Tensor):
    """Per-molecule squared errors and counts for energies and gradients:
    (e_se, n_conf, g_se, n_vec), each (M,) float32 on the batch's device."""
    m = batch.num_mols
    e_pred = mm_energy.centered(energy, batch.conf_mask)
    e_ref = mm_energy.centered(batch.energy_ref, batch.conf_mask)
    e_se = torch.square(e_pred - e_ref).sum(dim=1)
    n_conf = batch.conf_mask.float().sum(dim=1)
    g_se_node = (torch.square(gradient - batch.gradient_ref)
                 * _conf_mask_per_node(batch)[..., None]).sum(dim=(1, 2))
    g_se = mm_energy.segment_sum(g_se_node, batch.node_mol, m)
    n_vec = batch.atoms_per_mol() * n_conf
    return e_se, n_conf, g_se, n_vec


def _per_mol_full_stats(batch: GraphBatch, energy: torch.Tensor,
                        gradient: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-molecule accumulator contributions for the full Evaluator metric
    set: squared and absolute errors, the invariant (per-3-vector) gradient
    errors, and reference-value moments for std_energies / std_gradients."""
    m = batch.num_mols
    conf_mask = batch.conf_mask.float()
    e_pred = mm_energy.centered(energy, batch.conf_mask)
    e_ref = mm_energy.centered(batch.energy_ref, batch.conf_mask)
    e_diff = (e_pred - e_ref) * conf_mask
    n_conf = conf_mask.sum(dim=1)

    node_conf = _conf_mask_per_node(batch)[..., None]
    g_diff_sq = torch.square(gradient - batch.gradient_ref) * node_conf
    # per-(atom, conf) 3-vector norms for the invariant MAE
    g_vec_norm = torch.sqrt(g_diff_sq.sum(dim=2))

    def seg(x):
        return mm_energy.segment_sum(x, batch.node_mol, m)

    gref = batch.gradient_ref * node_conf
    return {
        'e_se': torch.square(e_diff).sum(dim=1),
        'e_ae': torch.abs(e_diff).sum(dim=1),
        'n_e': n_conf,
        'g_se': seg(g_diff_sq.sum(dim=(1, 2))),
        'g_ae_vec': seg(g_vec_norm.sum(dim=1)),
        'n_vec': batch.atoms_per_mol() * n_conf,
        'eref_sum': e_ref.sum(dim=1),
        'eref_sq': torch.square(e_ref * conf_mask).sum(dim=1),
        'gref_sum': seg(gref.sum(dim=(1, 2))),
        'gref_sq': seg(torch.square(gref).sum(dim=(1, 2))),
    }


class StreamingEvaluator:
    """Accumulates squared errors per dataset name across batches."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._e_se = defaultdict(float)
        self._n_e = defaultdict(float)
        self._g_se = defaultdict(float)
        self._n_g = defaultdict(float)

    def step(self, batch: GraphBatch, energy: torch.Tensor,
             gradient: torch.Tensor, ds_names: Sequence[str]):
        with torch.no_grad():
            stats = torch.stack(_per_mol_sqerr(batch, energy, gradient))
        self.accumulate(*stats.cpu().numpy(), ds_names)

    def accumulate(self, e_se, n_conf, g_se, n_vec,
                   ds_names: Sequence[str]):
        """Fold precomputed per-molecule accumulator arrays in."""
        for i, name in enumerate(ds_names):
            self._e_se[name] += float(e_se[i])
            self._n_e[name] += float(n_conf[i])
            self._g_se[name] += float(g_se[i])
            self._n_g[name] += float(n_vec[i])

    def pool(self, reset: bool = True) -> Dict[str, Dict[str, float]]:
        metrics: Dict[str, Dict[str, float]] = {}
        for name in self._e_se:
            n_e = max(self._n_e[name], 1.0)
            n_g = max(self._n_g[name], 1.0)
            rmse_g = float(np.sqrt(self._g_se[name] / n_g))
            metrics[name] = {
                'rmse_energies': float(np.sqrt(self._e_se[name] / n_e)),
                'rmse_gradients': rmse_g,
                'crmse_gradients': float(rmse_g / np.sqrt(3.0)),
            }
        if metrics:
            metrics['avg'] = {
                key: float(np.mean([m[key] for n, m in metrics.items()
                                    if n != 'avg']))
                for key in ('rmse_energies', 'rmse_gradients')
            }
        if reset:
            self.reset()
        return metrics


def early_stopping_loss(metrics: Dict[str, Dict[str, float]],
                        energy_weight: float = 3.0) -> float:
    """energy_weight * avg energy RMSE + avg gradient RMSE."""
    avg = metrics.get('avg')
    if not avg:
        return float('inf')
    return energy_weight * avg['rmse_energies'] + avg['rmse_gradients']
