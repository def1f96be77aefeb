"""Benchmark-table generation from evaluation results.

The port's copy of `grappa_tpu.train.report` (the same tables, string for
string). Counterpart of the reference's evaluation table pipeline (reference:
experiments/evaluation/espaloma_benchmark/make_table_dict.py ->
make_tex_table.py -> table.tex): turns the nested results produced by
eval_model / the grappa_eval CLI ({model_name: {dataset: metrics}}) into a
markdown and a LaTeX table with energy RMSE and force component-RMSE rows
per dataset, bold best-per-row, optional bootstrap CIs.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def _fmt(value: Optional[float], ci=None, bold=False, tex=False) -> str:
    if value is None:
        return '--'
    s = f'{value:.1f}'
    if bold:
        s = (r'\textbf{' + s + '}') if tex else f'**{s}**'
    if ci:
        s += f' [{ci[0]:.1f},{ci[1]:.1f}]'
    return s


def _rows(results: Dict[str, Dict[str, Dict]], with_ci: bool):
    """Yield (dataset, metric_label, metric_key, per-model values)."""
    models = list(results.keys())
    datasets: List[str] = []
    for per_ds in results.values():
        for ds in per_ds:
            if ds not in datasets and ds != 'avg':
                datasets.append(ds)
    for ds in datasets:
        for label, key in (('Energy RMSE', 'rmse_energies'),
                           ('Force cRMSE', 'crmse_gradients')):
            values = []
            for m in models:
                entry = results[m].get(ds, {})
                v = entry.get(key)
                ci = entry.get(f'{key}_ci') if with_ci else None
                if key == 'crmse_gradients' and ci is None and with_ci:
                    gci = entry.get('rmse_gradients_ci')
                    ci = [c / 3 ** 0.5 for c in gci] if gci else None
                values.append((v, ci))
            yield ds, label, values


def markdown_table(results: Dict[str, Dict[str, Dict]],
                   with_ci: bool = False) -> str:
    models = list(results.keys())
    lines = ['| Dataset | Metric | ' + ' | '.join(models) + ' |',
             '|---|---|' + '---|' * len(models)]
    for ds, label, values in _rows(results, with_ci):
        numeric = [v for v, _ in values if v is not None]
        best = min(numeric) if numeric else None
        cells = [_fmt(v, ci, bold=(v is not None and v == best))
                 for v, ci in values]
        ds_md = ds.replace('|', r'\|')
        lines.append(f'| {ds_md} | {label} | ' + ' | '.join(cells) + ' |')
    return '\n'.join(lines) + '\n'


def _tex_escape(s: str) -> str:
    """Escape LaTeX specials in names (dataset tags / sweep run names
    routinely contain underscores, which would otherwise fail to compile)."""
    for ch in ('\\', '&', '%', '$', '#', '_', '{', '}'):
        s = s.replace(ch, ('\\textbackslash{}' if ch == '\\'
                           else '\\' + ch))
    return s


def tex_table(results: Dict[str, Dict[str, Dict]],
              with_ci: bool = False,
              caption: str = 'Energy RMSE [kcal/mol] and force component '
                             'RMSE [kcal/mol/\\AA] on the test splits.') -> str:
    models = list(results.keys())
    cols = 'll' + 'r' * len(models)
    header = ' & '.join(['Dataset', 'Metric']
                        + [_tex_escape(m) for m in models]) + r' \\'
    lines = [r'\begin{table}', r'\centering',
             r'\begin{tabular}{' + cols + '}', r'\toprule', header,
             r'\midrule']
    last_ds = None
    for ds, label, values in _rows(results, with_ci):
        numeric = [v for v, _ in values if v is not None]
        best = min(numeric) if numeric else None
        cells = [_fmt(v, ci, bold=(v is not None and v == best), tex=True)
                 for v, ci in values]
        ds_cell = _tex_escape(ds) if ds != last_ds else ''
        last_ds = ds
        lines.append(' & '.join([ds_cell, label] + cells) + r' \\')
    lines += [r'\bottomrule', r'\end{tabular}',
              r'\caption{' + caption + '}', r'\end{table}']
    return '\n'.join(lines) + '\n'


def write_report(results: Dict[str, Dict[str, Dict]], out_prefix: str,
                 with_ci: bool = False):
    """Write <prefix>.md and <prefix>.tex."""
    from pathlib import Path
    Path(f'{out_prefix}.md').write_text(markdown_table(results, with_ci))
    Path(f'{out_prefix}.tex').write_text(tex_table(results, with_ci))
