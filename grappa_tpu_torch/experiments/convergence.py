"""Convergence check of the full default-size model on synthetic learnable
targets, on the port: the energy and force RMSE must fall toward the
float32 noise floor, which shows that the whole training system
(curriculum, schedule, loss, double backward) optimises the real
architecture end to end. The dtype flags give bf16 training's accuracy
beside float32's.

Counterpart of the JAX package's experiments/smoke/tpu_convergence.py
(same flags, config and run names):

    python -m grappa_tpu_torch.experiments.convergence [--epochs 60] \
        [--n-mols 96] [--out runs] [--compute-dtype bfloat16] \
        [--gnn-dtype D] [--heads-dtype D] [--scan-epochs] [--name N] \
        [--time_limit HOURS] [--device cpu]

--scan-epochs sets the Trainer's scan_epochs (one loop an epoch over the
batch cache); --time_limit bounds this session in hours (the Trainer's
session_time_limit). The run is <out>/<name>, by default tpu-convergence
(float32) or tpu-convergence-bf16, the JAX driver's names. It trains on
CUDA unless --device names another.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.data.synthetic import make_dataset
from grappa_tpu_torch.models.grappa_model import get_default_model_config
from grappa_tpu_torch.train.config import default_config, overwrite_config
from grappa_tpu_torch.train.run import do_trainrun

DTYPES = ['float32', 'bfloat16']


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.experiments.convergence')
    ap.add_argument('--epochs', type=int, default=60)
    ap.add_argument('--n-mols', type=int, default=96)
    ap.add_argument('--out', default='runs')
    ap.add_argument('--compute-dtype', default='float32', choices=DTYPES,
                    help='matmul compute dtype (bf16 accuracy validation)')
    ap.add_argument('--gnn-dtype', default=None, choices=DTYPES,
                    help='override GNN stage dtype (bf16-tax diagnosis)')
    ap.add_argument('--heads-dtype', default=None, choices=DTYPES,
                    help='override tuple-head stage dtype')
    ap.add_argument('--scan-epochs', action='store_true',
                    help='one loop an epoch over the batch cache')
    ap.add_argument('--name', default=None)
    ap.add_argument('--time_limit', type=float, default=None,
                    help="this session's bound in hours")
    ap.add_argument('--device', default=None,
                    help='torch device (default: CUDA)')
    return ap


def convergence_config(args) -> Dict:
    model_cfg = get_default_model_config()
    # full architecture, but light dropout: this is a fitting-capacity check
    model_cfg.update({
        'gnn_dropout_attention': 0.0, 'gnn_dropout_final': 0.0,
        'parameter_dropout': 0.0, 'compute_dtype': args.compute_dtype,
        'gnn_compute_dtype': args.gnn_dtype,
        'heads_compute_dtype': args.heads_dtype,
    })
    config = default_config()
    overwrite_config({
        'model_config': model_cfg,
        'data_config': {'datasets': [], 'conf_strategy': 16,
                        'val_conf_strategy': 16, 'train_batch_size': 16,
                        'partition': [0.85, 0.15, 0.0], 'weights': {},
                        'pure_train_datasets': [], 'pure_val_datasets': []},
        'lit_model_config': {'lr': 5e-5, 'start_qm_epochs': 2,
                             'warmup_steps': 200, 'patience': 600,
                             'lr_decay': 0.7},
        'trainer_config': {'max_epochs': args.epochs,
                           'checkpoint_every': 200,
                           'scan_epochs': bool(args.scan_epochs),
                           'async_checkpoints': True,
                           'name': 'tpu-convergence'},
        'test_model': True,
    }, config)
    if args.time_limit is not None:
        config['lit_model_config']['session_time_limit'] = float(
            args.time_limit)
    return config


def run_name(args) -> str:
    return args.name or ('tpu-convergence' if args.compute_dtype ==
                         'float32' else 'tpu-convergence-bf16')


def series(history):
    """Each epoch's es_loss and validation E RMSE / F RMSE, rounded as the
    JAX driver rounds them."""
    return [{'epoch': h['epoch'],
             'es_loss': round(h['early_stopping_loss'], 3),
             'e_rmse': round(h['metrics'].get('avg', {}).get(
                 'rmse_energies', float('nan')), 3),
             'f_rmse': round(h['metrics'].get('avg', {}).get(
                 'rmse_gradients', float('nan')), 3)}
            for h in history]


def main(argv: Optional[Sequence[str]] = None, dry_run: bool = False):
    """Train with the flags in `argv` (sys.argv[1:] when None); returns
    do_trainrun's output (dry_run: the config and the run name)."""
    args = build_parser().parse_args(argv)
    config = convergence_config(args)
    if dry_run:
        return config, run_name(args)
    ds = Dataset.from_moldata(
        make_dataset(n_mols=args.n_mols, n_confs=16, seed=7,
                     learnable=True, conf_noise=0.08), 'synthetic')
    out = do_trainrun(config, project_dir=args.out, run_name=run_name(args),
                      dataset_override=ds, cache_batches=True,
                      device=args.device)
    rows = series(out['results']['history'])
    print(json.dumps(rows[-10:], indent=1))
    first = next(s for s in rows if s['epoch'] >= 2)
    print(json.dumps({'first_qm_epoch': first, 'last': rows[-1]}))
    return out


if __name__ == '__main__':
    main()
