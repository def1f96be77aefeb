"""Self-contained smoke experiment on the port: train the small model on
synthetic, exactly learnable targets and report the early-stopping loss of
every epoch. No downloads.

Counterpart of the JAX package's experiments/smoke/synthetic_smoke.py.

    python -m grappa_tpu_torch.experiments.smoke [--epochs 10] \
        [--n-mols 16] [--out runs] [--device cpu]

The run is <out>/synthetic-smoke. It trains on CUDA unless --device names
another.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.data.synthetic import make_dataset
from grappa_tpu_torch.models.grappa_model import get_small_model_config
from grappa_tpu_torch.train.config import default_config, overwrite_config
from grappa_tpu_torch.train.run import do_trainrun

RUN_NAME = 'synthetic-smoke'


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.experiments.smoke')
    ap.add_argument('--epochs', type=int, default=10)
    ap.add_argument('--n-mols', type=int, default=16)
    ap.add_argument('--out', default='runs')
    ap.add_argument('--device', default=None,
                    help='torch device (default: CUDA)')
    return ap


def smoke_config(epochs: int) -> Dict:
    config = default_config()
    overwrite_config({
        'model_config': get_small_model_config(),
        'data_config': {'datasets': [], 'conf_strategy': 8,
                        'val_conf_strategy': 8, 'train_batch_size': 4,
                        'partition': [0.75, 0.25, 0.0], 'weights': {},
                        'pure_train_datasets': [], 'pure_val_datasets': []},
        'lit_model_config': {'lr': 3e-4, 'start_qm_epochs': 1,
                             'warmup_steps': 5},
        'trainer_config': {'max_epochs': epochs, 'name': 'smoke'},
        'test_model': True,
    }, config)
    return config


def main(argv: Optional[Sequence[str]] = None, dry_run: bool = False):
    """Train with the flags in `argv` (sys.argv[1:] when None); returns
    [{'epoch', 'early_stopping_loss'}, ...] (dry_run: the config and the
    run name)."""
    args = build_parser().parse_args(argv)
    config = smoke_config(args.epochs)
    if dry_run:
        return config, RUN_NAME
    ds = Dataset.from_moldata(
        make_dataset(n_mols=args.n_mols, n_confs=8, seed=0), 'synthetic')
    out = do_trainrun(config, project_dir=args.out, run_name=RUN_NAME,
                      dataset_override=ds, device=args.device)
    series: List[Dict] = [
        {'epoch': h['epoch'], 'early_stopping_loss': h['early_stopping_loss']}
        for h in out['results']['history']]
    print(json.dumps(series, indent=1))
    return series


if __name__ == '__main__':
    main()
