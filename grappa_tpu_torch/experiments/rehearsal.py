"""Rehearsal of the espaloma-benchmark recipe on the port: the real
experiments/benchmark/grappa_config.yaml (full dropout, curriculum, warmup,
weighted sampling, espaloma-style split) end to end on synthetic datasets
resolved by tag through the zoo cache.

Counterpart of the JAX package's experiments/benchmark/rehearsal.py.
Everything is the production path (tag resolution, the weighted
multi-dataset loader, conf-strategy padding, the split json, the full-width
model with its dropouts, the yaml's lr / warmup / patience schedule) except
the molecules and the overrides recorded in the summary (epochs,
val_conf_strategy, dataset tags and weights). Three learnable synthetic
tags drawn from one environment force field stand in for the benchmark's
datasets; they are saved in a temporary GRAPPA_TPU_CACHE, removed at the
end.

    python -m grappa_tpu_torch.experiments.rehearsal [--epochs 120] \
        [--out runs] [--fraction F] [--device cpu]

--fraction keeps that share of each tag's molecules (1: the JAX driver's
240 / 160 / 320) for a shorter rehearsal. The run is <out>/benchmark-
rehearsal; the summary json is printed and returned.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

from grappa_tpu_torch.data import synthetic
from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.espaloma_split import (build_espaloma_split,
                                             save_espaloma_split)
from grappa_tpu_torch.experiments.espaloma_proxy import BENCHMARK_YAML
from grappa_tpu_torch.train.config import read_yaml
from grappa_tpu_torch.train.run import do_trainrun

# tag: (molecules, conformers, seed)
SPECS = {'syn-monomers': (240, 12, 11), 'syn-dipeptide': (160, 8, 23),
         'syn-pubchem': (320, 6, 37)}
WEIGHTS = {'syn-monomers': 1.0, 'syn-dipeptide': 2.0, 'syn-pubchem': 0.8}
# synthetic molecules have <= 12 conformers
VAL_CONF_STRATEGY = 16


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.experiments.rehearsal')
    ap.add_argument('--epochs', type=int, default=120)
    ap.add_argument('--out', default='runs')
    ap.add_argument('--fraction', type=float, default=1.0,
                    help="share of each tag's molecules (default 1)")
    ap.add_argument('--device', default=None,
                    help='torch device (default: CUDA)')
    return ap


def make_tags(cache: Path, fraction: float = 1.0) -> list:
    """Save the three synthetic tags under <cache>/datasets; returns every
    molecule id."""
    all_ids = []
    for tag, (n_mols, n_confs, seed) in SPECS.items():
        ds = Dataset.from_moldata(synthetic.make_dataset(
            n_mols=max(1, round(n_mols * fraction)), n_confs=n_confs,
            seed=seed, learnable=True, conf_noise=0.08), tag)
        ds.save(cache / 'datasets' / tag)
        all_ids += ds.mol_ids
    return all_ids


def rehearsal_config(epochs: int, splitpath) -> tuple:
    """(the benchmark yaml with the rehearsal's overrides, the overrides)."""
    config = read_yaml(BENCHMARK_YAML)
    overrides = {
        'datasets': sorted(SPECS),
        'weights': dict(WEIGHTS),
        'val_conf_strategy': VAL_CONF_STRATEGY,
        'max_epochs': epochs,
    }
    config['data_config'].update({
        'datasets': overrides['datasets'],
        'pure_train_datasets': [], 'pure_val_datasets': [],
        'weights': overrides['weights'],
        'splitpath': str(splitpath),
        'val_conf_strategy': overrides['val_conf_strategy'],
    })
    config['trainer_config']['max_epochs'] = epochs
    config['trainer_config']['name'] = 'benchmark-rehearsal'
    return config, overrides


def summarize(history, overrides: Dict) -> Dict:
    """The JAX driver's summary of a run's history."""
    val = [h for h in history if h['epoch'] >= 2
           and h.get('early_stopping_loss') is not None]
    if not val:   # shorter than the curriculum: no QM epochs to summarize
        return {'epochs_run': len(history),
                'note': 'no post-curriculum epochs'}
    best = min(val, key=lambda h: h['early_stopping_loss'])
    return {
        'config': 'experiments/benchmark/grappa_config.yaml',
        'overrides': overrides,
        'epochs_run': len(history),
        'first_qm_es_loss': round(val[0]['early_stopping_loss'], 2),
        'best_es_loss': round(best['early_stopping_loss'], 2),
        'best_epoch': best['epoch'],
        'best_val_metrics': {
            k: round(v, 3) for k, v in best['metrics'].get('avg', {}).items()},
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the rehearsal with the flags in `argv` (sys.argv[1:] when None);
    returns the summary."""
    args = build_parser().parse_args(argv)
    cache = Path(tempfile.mkdtemp(prefix='rehearsal_cache_'))
    before = os.environ.get('GRAPPA_TPU_CACHE')
    os.environ['GRAPPA_TPU_CACHE'] = str(cache)
    try:
        all_ids = make_tags(cache, args.fraction)
        # espaloma-style split json (the published-benchmark mechanism)
        rng_ids = sorted(all_ids)
        split = build_espaloma_split(all_ids, te_smiles=rng_ids[::10],
                                     vl_smiles=rng_ids[1::10])
        splitpath = cache / 'espaloma_split.json'
        save_espaloma_split(split, splitpath)
        config, overrides = rehearsal_config(args.epochs, splitpath)
        if args.fraction != 1.0:
            overrides['fraction'] = args.fraction
        out = do_trainrun(config, project_dir=args.out,
                          run_name='benchmark-rehearsal', cache_batches=True,
                          device=args.device)
    finally:
        if before is None:
            os.environ.pop('GRAPPA_TPU_CACHE', None)
        else:
            os.environ['GRAPPA_TPU_CACHE'] = before
        shutil.rmtree(cache, ignore_errors=True)
    summary = summarize(out['results']['history'], overrides)
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == '__main__':
    main()
