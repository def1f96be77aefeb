"""The espaloma-benchmark training driver on the port.

Counterpart of the JAX package's experiments/benchmark/train.py (reference:
experiments/benchmark/train.py:1-34). Loads the benchmark recipe
experiments/benchmark/grappa_config.yaml, wires the espaloma split (an
espaloma_split.json beside the yaml, or one rebuilt from te_smiles.json /
vl_smiles.json through `espaloma_split`), applies the batch-size overrides
and the sampling-weight scans, and trains with do_trainrun on the batch
cache:

  --project        run output directory (default runs/benchmark)
  -tb/-vb          train / validation batch size
  --splitpath      espaloma split json
  --te_smiles/--vl_smiles  smiles lists to rebuild the split from; the
                   rebuilt split is written to <project>/espaloma_split.json
                   (the repository's experiments/ stays as it is), where a
                   later call without --splitpath finds it
  -o/--opt_weight  sampling weight of the optimisation-trajectory datasets
                   gen2 and pepconf-dlc (run name _opt<w>)
  -s/--scan_weight sampling weight of the torsion-scan datasets
                   gen2-torsion and protein-torsion (_scan<w>)

    python -m grappa_tpu_torch.experiments.benchmark [flags] [--device cpu]

Datasets resolve by tag through the zoo cache (GRAPPA_TPU_CACHE). It trains
on CUDA unless --device names another.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence

from grappa_tpu_torch.experiments.espaloma_proxy import BENCHMARK_YAML
from grappa_tpu_torch.train.config import overwrite_config, read_yaml
from grappa_tpu_torch.train.run import do_trainrun, load_datasets

OPT_DATASETS = ('gen2', 'pepconf-dlc')
SCAN_DATASETS = ('gen2-torsion', 'protein-torsion')


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.experiments.benchmark')
    parser.add_argument('--project', type=str, default='runs/benchmark',
                        help='run output directory')
    parser.add_argument('-tb', '--train_batch', type=int, default=-1)
    parser.add_argument('-vb', '--val_batch', type=int, default=-1)
    parser.add_argument('--splitpath', type=str, default=None,
                        help='espaloma split json; default: '
                             'espaloma_split.json beside the yaml, else in '
                             'the project directory, if it exists')
    parser.add_argument('--te_smiles', type=str, default=None,
                        help='test smiles json to rebuild the split from')
    parser.add_argument('--vl_smiles', type=str, default=None)
    parser.add_argument('-o', '--opt_weight', type=float, default=1.0,
                        help='sampling weight for the opt datasets')
    parser.add_argument('-s', '--scan_weight', type=float, default=1.0,
                        help='sampling weight for the torsion-scan datasets')
    parser.add_argument('--device', default=None,
                        help='torch device (default: CUDA)')
    return parser


def benchmark_config(args) -> Dict:
    """The benchmark recipe with `args`' split, batch sizes, sampling
    weights and run name, as the JAX driver builds it."""
    config = read_yaml(BENCHMARK_YAML)
    dcfg = config['data_config']

    splitpath = args.splitpath
    for candidate in (BENCHMARK_YAML.parent / 'espaloma_split.json',
                      Path(args.project) / 'espaloma_split.json'):
        if splitpath is None and candidate.exists():
            splitpath = str(candidate)

    if splitpath is None and args.te_smiles and args.vl_smiles:
        # rebuild espaloma's partition from the shipped smiles lists
        from grappa_tpu_torch.espaloma_split import (build_espaloma_split,
                                                     save_espaloma_split)
        tags = (dcfg['datasets'] + dcfg.get('pure_train_datasets', [])
                + dcfg.get('pure_val_datasets', []))
        split = build_espaloma_split(load_datasets(tags).mol_ids,
                                     args.te_smiles, args.vl_smiles)
        out = Path(args.project) / 'espaloma_split.json'
        out.parent.mkdir(parents=True, exist_ok=True)
        save_espaloma_split(split, out)
        splitpath = str(out)

    dcfg['splitpath'] = splitpath
    if args.train_batch > 0:
        dcfg['train_batch_size'] = args.train_batch
    if args.val_batch > 0:
        dcfg['val_batch_size'] = args.val_batch

    name = config['trainer_config'].get('name') or 'benchmark'
    if args.opt_weight != 1.0:
        name += f'_opt{args.opt_weight:g}'
        for d in OPT_DATASETS:
            dcfg['weights'][d] = args.opt_weight
    if args.scan_weight != 1.0:
        name += f'_scan{args.scan_weight:g}'
        for d in SCAN_DATASETS:
            dcfg['weights'][d] = args.scan_weight
    config['trainer_config']['name'] = name
    return config


def main(argv: Optional[Sequence[str]] = None, dry_run: bool = False,
         overrides: Optional[Dict] = None):
    """Train the benchmark recipe with the flags in `argv` (sys.argv[1:]
    when None). dry_run: return the config without training. overrides: a
    nested dict applied with overwrite_config after the flags (a
    rehearsal's cuts)."""
    args = build_parser().parse_args(argv)
    config = benchmark_config(args)
    if overrides:
        overwrite_config(overrides, config)
    if dry_run:
        return config
    return do_trainrun(config, project_dir=args.project, cache_batches=True,
                       device=args.device)


if __name__ == '__main__':
    print(f"run: {main()['run_dir']}")
