"""Reproducing a training run from a released model (reference:
examples/reproduction/grappa-1-1.py).

Published model files carry the full reproducibility contract: trained
state_dict, the complete training config (including dataset tags) and the
train/val/test molecule ids. Reproduction = extract config + split, point
the config at the stored split, and retrain.

With released checkpoints + benchmark data in the cache this reproduces
grappa-1.2; here it demonstrates the mechanism on the model exported by
grappa_tpu_torch.examples.training.train_small (pass a path or tag).

    python -m grappa_tpu_torch.examples.reproduction.reproduce \
        [runs/example-train/model.npz] [--epochs 10] [--n-mols 48] \
        [--project runs] [--device cpu]
"""
import argparse
import json
import tempfile
from pathlib import Path

from grappa_tpu_torch.train.export import load_model_dict
from grappa_tpu_torch.train.run import do_trainrun
from grappa_tpu_torch.zoo import model_path_from_tag


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.examples.reproduction.reproduce')
    ap.add_argument('tag', nargs='?', default='runs/example-train/model.npz',
                    help='model tag or file')
    ap.add_argument('--epochs', type=int, default=10,
                    help='demo length on the rebuilt synthetic dataset')
    ap.add_argument('--n-mols', type=int, default=48,
                    help="the rebuilt synthetic dataset's size (the "
                         "train_small example's)")
    ap.add_argument('--project', default='runs')
    ap.add_argument('--device', default=None,
                    help='where the run trains (default: CUDA)')
    args = ap.parse_args(argv)

    model_dict = load_model_dict(model_path_from_tag(args.tag))
    config = model_dict['config']
    split_ids = model_dict.get('split_names')
    assert split_ids, "model file carries no split -- cannot reproduce"

    splitpath = Path(tempfile.mkdtemp(prefix='grappa_repro_')) / 'split.json'
    splitpath.write_text(json.dumps(split_ids))
    config.setdefault('data_config', {})['splitpath'] = str(splitpath)

    # demo-only: the example model was trained on an unsaved synthetic
    # dataset, so rebuild it; with released models the dataset tags in the
    # config resolve through the zoo cache and this override is not needed
    dataset_override = None
    if not config['data_config'].get('datasets'):
        from grappa_tpu_torch.data.dataset import Dataset
        from grappa_tpu_torch.data.synthetic import make_dataset
        dataset_override = Dataset.from_moldata(
            make_dataset(n_mols=args.n_mols, n_confs=8, seed=1,
                         learnable=True, conf_noise=0.08), 'synthetic-demo')
        config.setdefault('trainer_config', {})['max_epochs'] = args.epochs

    out = do_trainrun(config, project_dir=args.project,
                      run_name='reproduce-demo',
                      dataset_override=dataset_override, cache_batches=True,
                      device=args.device)
    print('reproduction run finished; best early-stopping loss:',
          round(out['results']['best_early_stopping_loss'], 3))
    print('same split:', json.loads(splitpath.read_text()).keys())
    return out


if __name__ == '__main__':
    main()
