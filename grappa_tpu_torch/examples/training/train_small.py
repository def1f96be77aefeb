"""A complete small training run (reference: examples/training/
train_peptides.py). Uses synthetic data so it runs without downloaded
datasets; swap `dataset_override` for real tags in the config when data is
in the cache.

The config machinery is identical to the production recipe
(experiments/benchmark/grappa_config.yaml): four yaml sections, curriculum
(classical-parameter epochs first, then QM energy+force), warmup, plateau
decay, best/last checkpoints, model_dict export.

    python -m grappa_tpu_torch.examples.training.train_small \
        [--epochs 40] [--n-mols 48] [--project runs] [--device cpu]

The run is <project>/example-train; resume it later with
grappa_tpu_torch.train.run.resume_trainrun('runs/example-train').
"""
import argparse

from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.data.synthetic import make_dataset
from grappa_tpu_torch.models.grappa_model import get_small_model_config
from grappa_tpu_torch.train.config import default_config, overwrite_config
from grappa_tpu_torch.train.run import do_trainrun


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.examples.training.train_small')
    ap.add_argument('--epochs', type=int, default=40)
    ap.add_argument('--n-mols', type=int, default=48)
    ap.add_argument('--project', default='runs')
    ap.add_argument('--device', default=None,
                    help='where the run trains (default: CUDA)')
    args = ap.parse_args(argv)

    dataset = Dataset.from_moldata(
        make_dataset(n_mols=args.n_mols, n_confs=8, seed=1, learnable=True,
                     conf_noise=0.08),
        'synthetic-demo')

    config = default_config()
    overwrite_config({
        'model_config': get_small_model_config(),  # full size: omit this
        'data_config': {'datasets': [], 'train_batch_size': 8,
                        'conf_strategy': 8, 'val_conf_strategy': 8,
                        'partition': [0.85, 0.15, 0.0]},
        'lit_model_config': {'lr': 5e-4, 'start_qm_epochs': 2,
                             'warmup_steps': 20, 'patience': 30},
        'trainer_config': {'max_epochs': args.epochs,
                           'name': 'example-train'},
        'test_model': True,
    }, config)

    out = do_trainrun(config, project_dir=args.project,
                      run_name='example-train', dataset_override=dataset,
                      cache_batches=True, device=args.device)
    print('best early-stopping loss:',
          round(out['results']['best_early_stopping_loss'], 3))
    print('exported model:', out['model_dict_path'])
    return out


if __name__ == '__main__':
    main()
