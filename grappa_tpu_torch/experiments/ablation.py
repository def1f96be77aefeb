"""Ablations of the benchmark recipe on the port, and the ablation
benchmark on the espaloma-proxy datasets.

Counterpart of the JAX package's experiments/ablation/train.py (the
flags: `build_parser`, `ablated_config`, `main`) and experiments/
ablation/run_ablation.py (`run_ablation`, `write_table`). Each flag
changes the benchmark config and suffixes the run name:

  --with_hybridization   sp_hybridization among the input features
  --wrong_symmetry       espaloma-style (incorrect) improper permutations
  --no_positional_encoding
  --no_param_attention   the tuple transformers' depth folded into the
                         symmetrisers (pure-MLP parameter heads)
  --no_gnn_attention     convolutions in place of the attention layers
  --no_gnn               no graph neural network (atom MLP only)
  --no_self_interaction, --no_gated_torsion, --harmonic_gate
  --pretrain_path        start from a model file

--no_scaling and --exp_to_range raise NotImplementedError, as the
reference's do.

    python -m grappa_tpu_torch.experiments.ablation --wrong_symmetry \
        [--epochs N] [--project DIR] [--device cpu]
    python -m grappa_tpu_torch.experiments.ablation --benchmark \
        [--arms baseline wrong_symmetry] [--epochs 500] [--out DIR] \
        [--time_limit HOURS] [--device cpu]

The benchmark trains one run an arm (<out>/runs/abl-<arm>, default out
runs/torch_experiments/ablation) on the proxy's four datasets and split;
the per-arm results accumulate in <out>/ablation_results.json (a finished
arm is skipped, an interrupted one resumes from last.ckpt) and the
comparison table is <out>/ablation_table.md.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

from grappa_tpu_torch.experiments import espaloma_proxy
from grappa_tpu_torch.train.config import (default_config, overwrite_config,
                                           read_yaml, validate_config)
from grappa_tpu_torch.train.run import do_trainrun

TERMS = ('bond', 'angle', 'proper', 'improper')
OUT = Path('runs') / 'torch_experiments' / 'ablation'

ARMS = {
    'baseline': [],
    'wrong_symmetry': ['--wrong_symmetry'],
    'no_gnn_attention': ['--no_gnn_attention'],
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.experiments.ablation')
    p.add_argument('--project', type=str, default=None,
                   help='output directory (default '
                        'runs/torch_experiments/ablation/runs)')
    p.add_argument('--pretrain_path', type=str, default=None)
    p.add_argument('--epochs', type=int, default=None,
                   help='override max_epochs (full recipe if omitted)')
    p.add_argument('--device', default=None,
                   help='torch device (default: CUDA)')
    for flag in ('with_hybridization', 'wrong_symmetry',
                 'no_positional_encoding', 'no_param_attention',
                 'no_gnn_attention', 'no_gnn', 'no_scaling', 'exp_to_range',
                 'no_self_interaction', 'no_gated_torsion', 'harmonic_gate'):
        p.add_argument(f'--{flag}', action='store_true', default=False)
    return p


def ablated_config(config: Dict, args) -> Dict:
    """Apply the ablation flags in `args` to `config` and set its run
    name."""
    name = 'ablation'
    mc = config['model_config']
    if args.with_hybridization:
        if 'sp_hybridization' not in mc['in_feat_name']:
            mc['in_feat_name'] = list(mc['in_feat_name']) + [
                'sp_hybridization']
        name += '_hybrid'
    if args.wrong_symmetry:
        mc['wrong_symmetry'] = True
        name += '_wrong_sym'
    if args.no_positional_encoding:
        mc['positional_encoding'] = False
        name += '_no_pos_enc'
    if args.no_param_attention:
        for term in TERMS:
            mc[f'{term}_symmetriser_depth'] += mc[f'{term}_transformer_depth']
            mc[f'{term}_transformer_depth'] = 0
        name += '_no_param_att'
    if args.no_gnn_attention:
        mc['gnn_convolutions'] += mc['gnn_attentional_layers']
        mc['gnn_attentional_layers'] = 0
        name += '_no_gnn_att'
    if args.no_gnn:
        mc['gnn_convolutions'] = 0
        mc['gnn_attentional_layers'] = 0
        name += '_no_gnn'
    if args.no_self_interaction:
        mc['self_interaction'] = False
        name += '_no_self_int'
    if args.no_gated_torsion:
        mc['gated_torsion'] = False
        name += '_no_gated_torsion'
    if args.harmonic_gate:
        mc['harmonic_gate'] = True
        name += '_harmonic_gate'
    if args.no_scaling:
        raise NotImplementedError(
            'no_scaling is not implemented (matches the reference)')
    if args.exp_to_range:
        raise NotImplementedError(
            'exp_to_range is not implemented (matches the reference)')
    if args.pretrain_path is not None:
        # do_trainrun(pretrain_path=...) sets start_qm_epochs 0 itself
        name += '_pretrain'
    if args.epochs is not None:
        config['trainer_config']['max_epochs'] = args.epochs
    config['trainer_config']['name'] = name
    return config


def benchmark_config() -> Dict:
    """The benchmark yaml merged onto the full defaults, so the depth and
    width keys the flags change are present."""
    return overwrite_config(read_yaml(espaloma_proxy.BENCHMARK_YAML),
                            default_config())


def main(argv: Optional[Sequence[str]] = None, dry_run: bool = False):
    """One ablated run of the benchmark recipe (dry_run: its config);
    `--benchmark` as the first argument runs `benchmark_main` instead."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ['--benchmark']:
        return benchmark_main(argv[1:])
    args = build_parser().parse_args(argv)
    config = ablated_config(benchmark_config(), args)
    if dry_run:
        validate_config(config)
        return config
    return do_trainrun(config, project_dir=args.project or str(OUT / 'runs'),
                       cache_batches=True, pretrain_path=args.pretrain_path,
                       device=args.device)


def run_ablation(arms=None, epochs: int = 500, out_dir=None,
                 results_path=None, base_config: Optional[Dict] = None,
                 time_limit: Optional[float] = None, datasets=None,
                 splitpath=None, cache_dir=None, device=None) -> Dict:
    """Train every requested arm (skipping finished ones) on the proxy
    datasets and collect their bootstrap test metrics. base_config:
    another config than the benchmark's (a small one for a rehearsal)."""
    arms = list(arms or ARMS)
    out_dir = Path(out_dir) if out_dir else OUT
    results_path = (Path(results_path) if results_path
                    else out_dir / 'ablation_results.json')
    results = (json.loads(results_path.read_text())
               if results_path.exists() else {})

    for arm in arms:
        if results.get(arm, {}).get('test'):
            print(f'{arm}: cached')
            continue
        config = ablated_config(
            copy.deepcopy(base_config) if base_config is not None
            else benchmark_config(), build_parser().parse_args(ARMS[arm]))
        config = espaloma_proxy.proxy_config(
            config, epochs, time_limit,
            datasets or espaloma_proxy.PROXY_DATASETS,
            splitpath or espaloma_proxy.SPLIT_JSON)
        config['trainer_config']['name'] = f'abl-{arm}'
        out, test = espaloma_proxy.train_or_resume(
            config, out_dir / 'runs' / f'abl-{arm}', cache_dir, device)
        summary = espaloma_proxy.summarize(out, test)
        results[arm] = {'flags': ARMS[arm], 'epochs': summary['epoch'],
                        'best_es_loss': summary['best_es_loss'],
                        'test': test}
        results_path.parent.mkdir(parents=True, exist_ok=True)
        results_path.write_text(json.dumps(results, indent=1))
        print(f'{arm}: done (epochs={results[arm]["epochs"]})')

    write_table(results, results_path.parent / 'ablation_table.md')
    return results


def write_table(results: Dict, path):
    """Markdown: arms x datasets, E RMSE and F cRMSE with bootstrap CIs,
    each with its difference from the baseline arm."""
    base = (results.get('baseline') or {}).get('test') or {}
    datasets = sorted(d for d in (base or next(
        (r['test'] for r in results.values() if r.get('test')), {}))
        if d != 'avg')
    lines = ['# Ablation results (espaloma-proxy, held-out test)', '',
             'E RMSE kcal/mol, F cRMSE kcal/mol/Å; [bootstrap 95% CI]; '
             'Δ vs baseline in parentheses.', '',
             '| arm | ' + ' | '.join(f'{d} E / cF' for d in datasets) + ' |',
             '|' + '---|' * (len(datasets) + 1)]

    def fmt(m, key, base_m):
        v = m.get(key)
        if v is None:
            return 'n/a'
        ci = m.get(key + '_ci')
        s = f'{v:.2f}'
        if ci:
            s += f' [{ci[0]:.2f},{ci[1]:.2f}]'
        if base_m and base_m.get(key) is not None and m is not base_m:
            s += f' ({v - base_m[key]:+.2f})'
        return s

    for arm, r in results.items():
        test = r.get('test') or {}
        cells = [fmt(test.get(d, {}), 'rmse_energies', base.get(d, {}))
                 + ' / ' + fmt(test.get(d, {}), 'crmse_gradients',
                               base.get(d, {})) for d in datasets]
        lines.append(f'| {arm} | ' + ' | '.join(cells) + ' |')
    Path(path).write_text('\n'.join(lines) + '\n')
    print(f'wrote {path}')


def benchmark_main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.experiments.ablation --benchmark')
    ap.add_argument('--arms', nargs='+', default=list(ARMS),
                    choices=list(ARMS))
    ap.add_argument('--epochs', type=int, default=500)
    ap.add_argument('--out', default=str(OUT))
    ap.add_argument('--cache', default=None,
                    help='the proxy datasets\' cache (default '
                         'GRAPPA_TPU_CACHE, else the proxy study\'s)')
    ap.add_argument('--time_limit', type=float, default=None,
                    help='bound of each arm\'s session in hours')
    ap.add_argument('--device', default=None,
                    help='torch device (default: CUDA)')
    args = ap.parse_args(argv)
    return run_ablation(arms=args.arms, epochs=args.epochs, out_dir=args.out,
                        time_limit=args.time_limit, cache_dir=args.cache,
                        device=args.device)


if __name__ == '__main__':
    main()
