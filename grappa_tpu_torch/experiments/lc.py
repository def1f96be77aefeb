"""The learning curve on the port: the benchmark recipe trained at several
train-set subsampling factors.

Counterpart of the JAX package's experiments/lc/run_lc.py (reference:
experiments/benchmark_experiments/submit_lc.py + evaluation/lc_benchmark/
make_data_dict.py). Each factor trains one run (<out>/runs/lc_<factor>)
with data_config.tr_subsampling_factor (Dataset.subsampled) and records
the number of molecules it trained on and its bootstrap test metrics in
<out>/lc_results.json (default out runs/torch_experiments/lc); a factor
already there is skipped, an interrupted one resumes from last.ckpt. By
default the runs use the espaloma-proxy datasets and committed split.

    python -m grappa_tpu_torch.experiments.lc [--factors 1.0 0.5 0.25] \
        [--epochs 60] [--out DIR] [--datasets TAG ...] [--device cpu]

The drawing of the curve (the JAX package's experiments/lc/plot.py) is
not ported: it needs matplotlib.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

from grappa_tpu_torch.experiments import espaloma_proxy

OUT = Path('runs') / 'torch_experiments' / 'lc'


def run_lc(factors: Sequence[float], epochs: int, out_dir=None,
           datasets=None, splitpath=None, results_path=None,
           config: Optional[Dict] = None, cache_dir=None,
           device=None) -> Dict:
    """Train at each subsampling factor (skipping recorded ones) and
    collect {'lc_<factor>': {'train_mols', 'subsampling_factor', 'test'}}.
    config: another base config than the benchmark's."""
    out_dir = Path(out_dir) if out_dir else OUT
    if datasets is None:
        datasets = list(espaloma_proxy.PROXY_DATASETS)
        splitpath = splitpath or str(espaloma_proxy.SPLIT_JSON)
    if config is None:
        # the benchmark yaml on `datasets`, unweighted
        config = espaloma_proxy.proxy_config(datasets=datasets,
                                             split_json=splitpath or None)
        config['data_config']['weights'] = {}
    config['trainer_config']['max_epochs'] = epochs

    results_path = (Path(results_path) if results_path
                    else out_dir / 'lc_results.json')
    results = (json.loads(results_path.read_text())
               if results_path.exists() else {})
    for factor in factors:
        key = f'lc_{factor:g}'
        if key in results:
            print(f'{key}: cached')
            continue
        cfg = json.loads(json.dumps(config))
        if factor < 1.0:
            cfg['data_config']['tr_subsampling_factor'] = factor
        cfg['trainer_config']['name'] = key
        out, test = espaloma_proxy.train_or_resume(
            cfg, out_dir / 'runs' / key, cache_dir, device)
        entry = {'train_mols': len(out['trainer'].train_loader.dataset),
                 'subsampling_factor': factor, 'test': test}
        results[key] = entry
        results_path.parent.mkdir(parents=True, exist_ok=True)
        results_path.write_text(json.dumps(results, indent=1))
        print(f'{key}: train_mols={entry["train_mols"]}')
    print(f'wrote {results_path}')
    return results


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.experiments.lc')
    ap.add_argument('--factors', type=float, nargs='+',
                    default=[1.0, 0.5, 0.25, 0.1, 0.05])
    ap.add_argument('--epochs', type=int, default=60)
    ap.add_argument('--out', default=str(OUT))
    ap.add_argument('--datasets', nargs='+', default=None,
                    help='dataset tags (default: the espaloma-proxy four)')
    ap.add_argument('--splitpath', default=None)
    ap.add_argument('--cache', default=None,
                    help='dataset cache (default GRAPPA_TPU_CACHE, else '
                         'the proxy study\'s)')
    ap.add_argument('--device', default=None,
                    help='torch device (default: CUDA)')
    args = ap.parse_args(argv)
    return run_lc(factors=args.factors, epochs=args.epochs, out_dir=args.out,
                  datasets=args.datasets, splitpath=args.splitpath,
                  cache_dir=args.cache, device=args.device)


if __name__ == '__main__':
    main()
