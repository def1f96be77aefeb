"""Evaluating a model on dataset directories (reference:
examples/evaluation/evaluate_peptides.py + the grappa_eval CLI).

Computes per-dataset RMSE / MAE / cRMSE with bootstrap confidence
intervals, optional classical-FF comparison columns, parameter scatter /
violin plots (with matplotlib), and writes the results back into the model
file (the reference `grappa_eval` contract). Run
grappa_tpu_torch.examples.training.train_small first to produce a model, or
point at any exported .pth / .npz.

    python -m grappa_tpu_torch.examples.evaluation.evaluate \
        [runs/example-train/model.npz] [DATASET_DIR] [--n-mols 12] \
        [--out eval_results.json] [--plots eval_plots] [--device cpu]
"""
import argparse
import json
import tempfile
from pathlib import Path

from grappa_tpu_torch.cli import main as cli_main


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.examples.evaluation.evaluate')
    ap.add_argument('model', nargs='?',
                    default='runs/example-train/model.npz')
    ap.add_argument('dataset_dir', nargs='?', default=None)
    ap.add_argument('--n-mols', type=int, default=12,
                    help='size of the held-out synthetic dataset made when '
                         'no dataset directory is given')
    ap.add_argument('--out', default='eval_results.json')
    ap.add_argument('--plots', default='eval_plots',
                    help="plot directory ('' for none)")
    ap.add_argument('--device', default=None,
                    help='where the model runs (default: CUDA)')
    args = ap.parse_args(argv)

    dataset_dir = args.dataset_dir
    if dataset_dir is None:
        # build a held-out synthetic dataset to evaluate on
        from grappa_tpu_torch.data.dataset import Dataset
        from grappa_tpu_torch.data.synthetic import make_dataset
        dataset_dir = tempfile.mkdtemp(prefix='grappa_evalds_')
        Dataset.from_moldata(
            make_dataset(n_mols=args.n_mols, n_confs=8, seed=99,
                         learnable=True, conf_noise=0.08),
            'heldout').save(dataset_dir)

    out_json = Path(args.out)
    # --set all: evaluate every molecule in the given datasets. With
    # released benchmark models, omit it to restrict to the model's stored
    # TEST split (the published-number protocol).
    flags = ['eval', '-t', args.model, '-d', dataset_dir, '--set', 'all',
             '--n-bootstrap', '200', '-o', str(out_json)]
    if args.plots:
        flags += ['--plots', args.plots]
    if args.device:
        flags += ['--device', args.device]
    rc = cli_main(flags)
    assert rc == 0
    results = json.loads(out_json.read_text())
    for ds, metrics in results['grappa_tpu'].items():
        lo, hi = metrics['rmse_energies_ci']
        print(f"{ds}: energy RMSE {metrics['rmse_energies']:.3f} "
              f"[{lo:.3f}, {hi:.3f}]  force cRMSE "
              f"{metrics['crmse_gradients']:.3f} kcal/mol/A")
    print(f"plots in {args.plots}/; results also stored inside the model "
          f"file" if args.plots else "results also stored inside the model "
          "file")
    return results


if __name__ == '__main__':
    main()
