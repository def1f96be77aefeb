"""Model evaluation with bootstrapped confidence intervals.

Counterpart of `grappa_tpu.train.eval_model` (reference: src/grappa/
training/eval_model.py:78-301 and evaluation.py:164-408): per-dataset
energy / force metrics with molecule-level bootstrap CIs, for the model
(`eval_model`) and for the classical force fields whose energies and
gradients the dataset entries store (`classical_ff_metrics`). The
bootstrap draws from `np.random.default_rng(seed)` as the JAX package
does, so both give the same intervals for the same per-molecule
statistics, and results sit under the JAX package's keys.

The parameter and prediction scatter plots (`plot_dir`) come in two parts:
`plot_arrays`, the device part (one forward a molecule on the eval device,
its parameters, centred energies and dE/dx beside the classical
references, as numpy arrays), and the drawing (`draw_parameter_plots`,
`draw_prediction_plots`), which imports matplotlib when it runs and writes
the JAX package's file names. A machine without matplotlib runs the device
part alone.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.data.graph_batch import MolGraph, PadSpec, collate
from grappa_tpu_torch.data.loader import GraphLoader
from grappa_tpu_torch.data.parameters import Parameters
from grappa_tpu_torch.models import mm_energy
from grappa_tpu_torch.train.evaluator import _per_mol_full_stats
from grappa_tpu_torch.train.trainer import make_eval_step
from grappa_tpu_torch.utils import resolve_device


_ACC_KEYS = ('e_se', 'e_ae', 'n_e', 'g_se', 'g_ae_vec', 'n_vec',
             'eref_sum', 'eref_sq', 'gref_sum', 'gref_sq')
# metric keys that get bootstrap CIs (reference eval_model.py METRIC_KEYS)
_METRIC_KEYS = ('rmse_energies', 'rmse_gradients', 'crmse_gradients',
                'mae_energies', 'mae_gradients')
# points of a dataset's gradient scatter plot (a seeded subsample above it)
_MAX_POINTS = 20000


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


def plot_arrays(model: torch.nn.Module, dataset: Dataset, device=None
                ) -> Dict[str, Dict[str, list]]:
    """The scatter plots' device part: {dataset: {key: per-molecule list}}.

    One forward of `model` (eval mode, on `device`: CUDA unless the caller
    asks for another; the model is moved there) a molecule, on the
    molecule alone padded to multiples of 32 as the JAX package pads its
    prediction plots. Keys: 'pred' (the predicted Parameters, the JAX
    package's Grappa.predict without its eq-value check) and 'ref' (the
    entry's classical parameters); 'e_pred' / 'e_qm' (centred energies,
    float32) and 'g_pred' / 'g_qm' (dE/dx, flattened (conformer, atom,
    xyz)); 'e_<ff>' / 'g_<ff>' for every classical force field the entry
    stores, its stored nonbonded part subtracted (float64)."""
    device = resolve_device(device)
    model = model.to(device).eval()
    out: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
    for entry, ds_name in zip(dataset.entries, dataset.ds_names):
        g = MolGraph.from_moldata(entry)
        n_confs, n_atoms = entry.xyz.shape[:2]
        pad = PadSpec.for_graphs([g], n_confs, node_mult=32, tuple_mult=32)
        batch = collate([g], pad=pad, device=device)
        with torch.no_grad():
            pred = model(batch)
        energy, gradient = mm_energy.energy_and_gradient(batch, pred)
        mol = entry.molecule
        counts = {'n2': len(mol.bonds), 'n3': len(mol.angles),
                  'n4': len(mol.propers), 'n4_improper': len(mol.impropers)}
        sliced = {}
        for key, v in pred.items():
            t = ('n4_improper' if key.startswith('n4_improper')
                 else key.rsplit('_', 1)[0])
            sliced[key] = v[:counts[t]].cpu().numpy()
        e = energy[0, :n_confs].cpu().numpy()
        grad = gradient[:n_atoms, :n_confs].cpu().numpy().transpose(1, 0, 2)
        d = out[ds_name]
        d['pred'].append(Parameters.from_prediction(mol, sliced,
                                                    check_eq_values=False))
        d['ref'].append(entry.classical_parameters)
        d['e_pred'].append(e - e.mean())
        d['e_qm'].append(entry.energy_ref - entry.energy_ref.mean())
        d['g_pred'].append(grad.ravel())
        d['g_qm'].append(entry.gradient_ref.ravel())
        for ff, fe in entry.ff_energy.items():
            if ff == 'qm':
                continue
            # bonded-only comparison, like classical_ff_metrics: the stored
            # classical energies are totals; the targets are bonded-only,
            # so subtract the stored nonbonded part
            fe = np.asarray(fe, np.float64)
            nb = entry.ff_nonbonded_energy.get(ff)
            if nb is not None:
                fe = fe - np.asarray(nb, np.float64)
            d[f'e_{ff}'].append(fe - fe.mean())
            fg = entry.ff_gradient.get(ff)
            if fg is not None:
                fg = np.asarray(fg, np.float64)
                nbg = entry.ff_nonbonded_gradient.get(ff)
                if nbg is not None:
                    fg = fg - np.asarray(nbg, np.float64)
                d[f'g_{ff}'].append(fg.ravel())
    return {k: dict(v) for k, v in out.items()}


def _require_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            'the scatter plots need matplotlib, which is not installed; '
            'plot_arrays gives their data without it') from exc


def draw_parameter_plots(arrays: Dict[str, Dict[str, list]], plot_dir
                         ) -> List[str]:
    """Per-dataset predicted-vs-classical parameter scatter and violin
    plots from `plot_arrays` (reference Evaluator.plot_parameters,
    evaluation.py:389-408); the JAX package's file names."""
    _require_matplotlib()
    from pathlib import Path
    from grappa_tpu_torch.plotting import (compare_parameters,
                                           compare_parameters_detailed,
                                           plot_parameters,
                                           plot_parameters_detailed)

    plot_dir = Path(plot_dir)
    plot_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for ds_name, d in arrays.items():
        f1 = plot_dir / f'{ds_name}_parameter_comparison.png'
        compare_parameters(d['ref'], d['pred'], filename=str(f1),
                           xlabel='classical (ref)', ylabel='prediction',
                           title=ds_name)
        f2 = plot_dir / f'{ds_name}_parameters.png'
        plot_parameters(d['pred'], filename=str(f2), title=ds_name)
        # reference-layout panels: signed per-periodicity torsion ks,
        # angles in degrees (Parameters.py:646-923)
        f3 = plot_dir / f'{ds_name}_parameter_comparison_detailed.png'
        compare_parameters_detailed(
            d['ref'], d['pred'], filename=str(f3),
            xlabel='classical (ref)', ylabel='prediction', title=ds_name)
        f4 = plot_dir / f'{ds_name}_parameters_detailed.png'
        plot_parameters_detailed(
            d['pred'], compare=d['ref'], filename=str(f4), title=ds_name,
            name='grappa_tpu', compare_name='classical')
        written += [str(f1), str(f2), str(f3), str(f4)]
    return written


def draw_prediction_plots(arrays: Dict[str, Dict[str, list]], plot_dir
                          ) -> List[str]:
    """Per-dataset predicted-vs-QM scatter plots of centred energies and
    gradient components from `plot_arrays`, with the stored classical
    force fields overlaid (reference: experiments/evaluation/grappa-1.1/
    scatter_plots.py). Gradient clouds are subsampled to _MAX_POINTS per
    dataset."""
    _require_matplotlib()
    from pathlib import Path

    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    plot_dir = Path(plot_dir)
    plot_dir.mkdir(parents=True, exist_ok=True)
    written = []
    series_color, classical_color = '#3b6fb6', '#c33d3d'
    for ds_name, d in arrays.items():
        e_qm = np.concatenate(d['e_qm'])
        e_pred = np.concatenate(d['e_pred'])
        g_qm = np.concatenate(d['g_qm'])
        g_pred = np.concatenate(d['g_pred'])
        rng = np.random.default_rng(0)
        idx = (rng.choice(len(g_qm), _MAX_POINTS, replace=False)
               if len(g_qm) > _MAX_POINTS else slice(None))
        classical_ffs = sorted({k[2:] for k in d if k.startswith('e_')
                                and k not in ('e_pred', 'e_qm')})

        fig, axes = plt.subplots(1, 2, figsize=(9.5, 4.6))
        for ax, qm, pred, label, unit in (
                (axes[0], e_qm, e_pred, 'energy', 'kcal/mol'),
                (axes[1], g_qm[idx], g_pred[idx], 'force components',
                 'kcal/mol/A')):
            lo = min(qm.min(), pred.min())
            hi = max(qm.max(), pred.max())
            ax.plot([lo, hi], [lo, hi], color='0.6', ls='--', lw=1,
                    zorder=0)
            rmse = float(np.sqrt(np.mean((pred - qm) ** 2)))
            ax.scatter(qm, pred, s=5, alpha=0.4, color=series_color,
                       label=f'grappa_tpu (RMSE {rmse:.2f})', lw=0)
            for ff in classical_ffs:
                key = f'{"e" if label == "energy" else "g"}_{ff}'
                if key in d:
                    vals = np.concatenate(d[key])
                    vidx = (idx if label != 'energy'
                            and np.shape(vals) == np.shape(g_qm)
                            else slice(None))
                    ref = e_qm if label == 'energy' else g_qm[vidx]
                    vals = vals[vidx] if label != 'energy' else vals
                    if len(vals) != len(ref):
                        continue
                    ff_rmse = float(np.sqrt(np.mean((vals - ref) ** 2)))
                    ax.scatter(ref, vals, s=5, alpha=0.35,
                               color=classical_color,
                               label=f'{ff} (RMSE {ff_rmse:.2f})', lw=0)
            ax.set_xlabel(f'QM {label} [{unit}]')
            ax.set_ylabel(f'predicted {label} [{unit}]')
            ax.grid(alpha=0.25, lw=0.5)
            ax.spines[['top', 'right']].set_visible(False)
            ax.legend(frameon=False, fontsize=8, loc='upper left')
        fig.suptitle(ds_name)
        fig.tight_layout()
        path = plot_dir / f'{ds_name}_prediction_scatter.png'
        fig.savefig(path, dpi=160)
        plt.close(fig)
        written.append(str(path))
    return written


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
    ('batch_size'). `plot_dir` writes the per-dataset parameter and
    prediction scatter plots there (`plot_arrays` on the device, then the
    drawing; results['plots'] lists the files); without matplotlib it
    raises ImportError before any work."""
    if plot_dir is not None:
        _require_matplotlib()
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
    if plot_dir is not None:
        arrays = plot_arrays(model, dataset, device)
        results['plots'] = (draw_parameter_plots(arrays, plot_dir)
                            + draw_prediction_plots(arrays, plot_dir))
    if timings is not None:
        timings.update(t)
    return results
