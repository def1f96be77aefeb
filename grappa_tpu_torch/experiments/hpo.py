"""The Bayesian hyperparameter sweep on the espaloma-proxy benchmark, on
the port.

Counterpart of the JAX package's experiments/hpo/run_hpo.py (reference:
experiments/hyperparameter_optimization/hpo_run.py + sweep_config.yaml,
method: bayes): GP-EI trials (`train.sweep.run_sweep`, 6 random ones
first) of the benchmark recipe on the four proxy datasets and their
committed split, each trial --epochs long with early kills of hopeless
ones (finish_criterion), ranked by its validation early-stopping loss
(none before the recipe's first QM epoch: a trial that ends earlier
records null). Resumable: a trial recorded in <out>/trials.jsonl is not
run again. <out> (default runs/torch_experiments/hpo) holds trials.jsonl,
best.json and the trial runs; --report ranks the trials into
<out>/hpo_summary.md.

    python -m grappa_tpu_torch.experiments.hpo [--trials 16] \
        [--epochs 150] [--out DIR] [--device cpu]
    python -m grappa_tpu_torch.experiments.hpo --report [--out DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

from grappa_tpu_torch.experiments import espaloma_proxy
from grappa_tpu_torch.train.sweep import read_trials, run_sweep

OUT = Path('runs') / 'torch_experiments' / 'hpo'

# dotted config paths -> distributions (train.sweep's format), around the
# recipe's lr 1.5e-5, batch 32, patience 50 and lr_decay 0.8
SPEC = {
    'lit_model_config.lr': ('log_uniform', 3e-6, 1e-4),
    'data_config.train_batch_size': ('choice', [16, 32, 64]),
    'lit_model_config.patience': ('choice', [10, 25, 50]),
    'lit_model_config.lr_decay': ('uniform', 0.5, 0.9),
}


def build_base_config(epochs: int) -> Dict:
    """The benchmark yaml on the proxy datasets, `epochs` a trial."""
    config = espaloma_proxy.proxy_config(
        epochs=epochs, datasets=espaloma_proxy.PROXY_DATASETS,
        split_json=espaloma_proxy.SPLIT_JSON)
    # early kills (hours -> the most es_loss allowed): a healthy run is
    # near es_loss 30 after ~8 minutes; 10x that is hopeless
    config['lit_model_config']['finish_criterion'] = {0.15: 100.0}
    config['test_model'] = False
    return config


def run_hpo(trials: int = 16, epochs: int = 150, out_dir=None,
            base_config: Optional[Dict] = None, spec: Optional[Dict] = None,
            method: str = 'bayes', cache_dir=None, device=None) -> Dict:
    """Run (or resume) the sweep; returns the best trial."""
    out_dir = Path(out_dir) if out_dir else OUT
    config = base_config or build_base_config(epochs)
    with espaloma_proxy.dataset_cache(
            espaloma_proxy.default_cache(cache_dir)):
        best = run_sweep(config, spec or SPEC, n_trials=trials,
                         sweep_dir=str(out_dir), method=method, n_init=6,
                         max_epochs=epochs, cache_batches=True,
                         device=device)
    print(json.dumps(best, indent=1, default=str))
    return best


def report(out_dir=None, path=None):
    """Rank the trials by validation early-stopping loss into
    hpo_summary.md; returns the scored trials in rank order."""
    out_dir = Path(out_dir) if out_dir else OUT
    trials = read_trials(out_dir / 'trials.jsonl')
    scored = sorted((t for t in trials if 'early_stopping_loss' in t),
                    key=lambda t: t['early_stopping_loss'])
    lines = ['# HPO sweep summary (espaloma-proxy, GP-EI)', '',
             f'{len(trials)} trials ({len(trials) - len(scored)} failed); '
             'val early-stopping loss (3*E RMSE + F RMSE), lower is '
             'better. Production defaults: lr 1.5e-5, batch 32, '
             'patience 50, lr_decay 0.8.', '',
             '| rank | trial | es_loss | params |', '|---|---|---|---|']
    for rank, t in enumerate(scored, 1):
        ps = ', '.join(f'{k.split(".")[-1]}={v:.3g}'
                       if isinstance(v, float) else
                       f'{k.split(".")[-1]}={v}'
                       for k, v in sorted(t['params'].items()))
        lines.append(f'| {rank} | {t["trial"]:03d} | '
                     f'{t["early_stopping_loss"]:.3f} | {ps} |')
    out = Path(path) if path else out_dir / 'hpo_summary.md'
    out.write_text('\n'.join(lines) + '\n')
    print(f'wrote {out}')
    return scored


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.experiments.hpo')
    ap.add_argument('--trials', type=int, default=16)
    ap.add_argument('--epochs', type=int, default=150)
    ap.add_argument('--out', default=str(OUT))
    ap.add_argument('--method', default='bayes', choices=['bayes', 'random'])
    ap.add_argument('--cache', default=None,
                    help='the proxy datasets\' cache (default '
                         'GRAPPA_TPU_CACHE, else the proxy study\'s)')
    ap.add_argument('--report', action='store_true',
                    help='only render hpo_summary.md from trials.jsonl')
    ap.add_argument('--device', default=None,
                    help='torch device (default: CUDA)')
    args = ap.parse_args(argv)
    if not args.report:
        run_hpo(trials=args.trials, epochs=args.epochs, out_dir=args.out,
                method=args.method, cache_dir=args.cache, device=args.device)
    report(out_dir=args.out)


if __name__ == '__main__':
    main()
