"""The published training recipes (grappa-1.0, 1.1, 1.2 and 1.2.1) on the
port: load a version's reference-format grappa_config.yaml, apply the
recipe's command-line flags, wire the espaloma split and train.

Counterpart of the JAX package's experiments/production_driver.py
(reference: experiments/train-grappa-1.0/train.py:1-44,
train-grappa-1.2.1/train.py:1-76). Flags, config edits and run names are
that driver's:

  --project         output directory (default runs/<version>)
  -tb/-vb           train / validation batch size
  -p/--param_weight parameter-loss weight of the *amber99sbildn* datasets
                    (param_weights_by_dataset; run name _p<log10>)
  -b/--bondbreak_radicals  train on AA_bondbreak_rad_amber99sbildn at
                    weight 2 (_bondbreak)
  --shrink_train    tr_subsampling_factor (_shrink<percent>)
  --n_periodicity   proper-torsion periodicity (_n_p<n> unless 3)
  --no_torsion_cutoff  no hard |k| cutoff (_no_cutoff)
  --pretrain_path   model file whose weights start the run;
                    param_loss_epochs = 0 (_pretrain)

grappa-1.0 takes the first three. Run a recipe with

    python -m grappa_tpu_torch.production experiments/train-grappa-1.2.1 \
        grappa-1.2.1 [flags] [--device cpu]
    python -m grappa_tpu_torch.production experiments/train-grappa-1.0 \
        grappa-1.0 --v1_0 [flags]

It trains on CUDA unless --device (or `device=`) names another.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from grappa_tpu_torch.train.config import (normalize_reference_config,
                                           overwrite_config, read_yaml)


def build_parser(v1_0: bool = False) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--project', type=str, default=None,
                        help='run output directory (default runs/<version>)')
    parser.add_argument('-tb', '--train_batch', type=int, default=-1)
    parser.add_argument('-vb', '--val_batch', type=int, default=-1)
    parser.add_argument('-p', '--param_weight', type=float, default=None)
    if not v1_0:
        parser.add_argument('-b', '--bondbreak_radicals',
                            action='store_true', default=False)
        parser.add_argument('--shrink_train', type=float, default=None)
        parser.add_argument('--n_periodicity', type=int, default=3)
        parser.add_argument('--no_torsion_cutoff', action='store_true')
        parser.add_argument('--pretrain_path', type=str, default=None)
    return parser


def run_production(config_dir, version: str,
                   argv: Optional[Sequence[str]] = None, v1_0: bool = False,
                   dry_run: bool = False, device=None,
                   overrides: Optional[Dict] = None):
    """Load <config_dir>/grappa_config.yaml, apply the recipe flags in
    `argv` (sys.argv[1:] when None) and train with do_trainrun.

    dry_run: return the config without training. overrides: a nested dict
    applied with overwrite_config after the flags (a rehearsal's cuts,
    such as fewer epochs). device: where the run trains (CUDA unless it
    names another)."""
    args = build_parser(v1_0).parse_args(argv)
    config_dir = Path(config_dir)
    config = normalize_reference_config(read_yaml(config_dir
                                                  / 'grappa_config.yaml'))

    # the espaloma benchmark split: a json beside the config, else the
    # 'espaloma_split' tag (train.run.resolve_splitpath)
    local_split = config_dir / 'espaloma_split.json'
    config['data_config']['splitpath'] = (
        str(local_split) if local_split.exists() else 'espaloma_split')

    name = version
    if args.train_batch > 0:
        config['data_config']['train_batch_size'] = args.train_batch
    if args.val_batch > 0:
        config['data_config']['val_batch_size'] = args.val_batch

    if args.param_weight is not None:
        name += f"_p{int(np.log10(args.param_weight))}"
        config['lit_model_config']['param_weights_by_dataset'] = {
            ds: args.param_weight
            for ds in config['data_config']['datasets']
            if 'amber99sbildn' in ds}

    if not v1_0:
        if args.bondbreak_radicals:
            name += '_bondbreak'
            ds_list = config['data_config']['datasets']
            if 'AA_bondbreak_rad_amber99sbildn' not in ds_list:
                ds_list.append('AA_bondbreak_rad_amber99sbildn')
            config['data_config']['weights'][
                'AA_bondbreak_rad_amber99sbildn'] = 2.0
        if args.shrink_train is not None:
            config['data_config']['tr_subsampling_factor'] = args.shrink_train
            name += f"_shrink{int(args.shrink_train * 100)}"
        if args.n_periodicity != 3:
            config['model_config']['n_periodicity_proper'] = int(
                args.n_periodicity)
            name += f"_n_p{int(args.n_periodicity)}"
        if args.no_torsion_cutoff:
            config['model_config']['torsion_cutoff'] = 0.0
            name += '_no_cutoff'
        if args.pretrain_path is not None:
            config['lit_model_config']['param_loss_epochs'] = 0
            name += '_pretrain'

    config['trainer_config']['name'] = name
    # as the JAX driver: a default only, and normalize_reference_config has
    # already filled the key from default_config() (False)
    config['trainer_config'].setdefault('async_checkpoints', True)
    if overrides:
        overwrite_config(overrides, config)
    if dry_run:
        return config

    from grappa_tpu_torch.train.run import do_trainrun
    return do_trainrun(
        config, project_dir=args.project or f'runs/{version}',
        cache_batches=True,
        pretrain_path=getattr(args, 'pretrain_path', None), device=device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    outer = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.production',
        description='Train a published Grappa recipe; the flags after the '
                    'version are the recipe\'s (see the module doc).')
    outer.add_argument('config_dir',
                       help='directory holding the grappa_config.yaml')
    outer.add_argument('version', help='run name stem, e.g. grappa-1.2.1')
    outer.add_argument('--v1_0', action='store_true',
                       help='grappa-1.0\'s flag set (-tb, -vb, -p)')
    outer.add_argument('--device', default=None,
                       help='torch device (default: CUDA)')
    args, rest = outer.parse_known_args(argv)
    out = run_production(args.config_dir, args.version, argv=rest,
                         v1_0=args.v1_0, device=args.device)
    print(f"model: {out['model_dict_path']}  run: {out['run_dir']}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
