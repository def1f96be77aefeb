"""The model_dict contract (reference: examples/usage/inspect_models.py).

Published models are `.pth` files holding {state_dict, config, split_names,
results} -- the full reproducibility contract. This example exports a fresh
(untrained) model to show the layout, then loads it back through the
inference API; with a released checkpoint in the cache, pass its tag
instead.

    python -m grappa_tpu_torch.examples.usage.inspect_models [--device cpu]
"""
import argparse
import tempfile
from pathlib import Path

import torch

from grappa_tpu_torch.api import Grappa
from grappa_tpu_torch.data.synthetic import random_molecule
from grappa_tpu_torch.models.grappa_model import (get_small_model_config,
                                                  make_model)
from grappa_tpu_torch.train.export import (build_model_dict, load_model_dict,
                                           save_model_dict)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.examples.usage.inspect_models')
    ap.add_argument('--device', default=None,
                    help='where the model runs (default: CUDA)')
    args = ap.parse_args(argv)

    cfg = get_small_model_config()
    model = make_model(cfg, generator=torch.Generator().manual_seed(0))

    path = Path(tempfile.mkdtemp(prefix='grappa_model_')) / 'demo.npz'
    save_model_dict(build_model_dict(model, {'model_config': cfg}), path)

    loaded = load_model_dict(path)
    print("model_dict keys:", sorted(loaded))
    print("config sections:", sorted(loaded['config']))
    print("first state_dict entries (reference torch naming):")
    for name in list(loaded['state_dict'])[:5]:
        print("  ", name, tuple(loaded['state_dict'][name].shape))

    ff = Grappa.from_tag(str(path), device=args.device)  # tags and paths
    out = ff.predict(random_molecule(seed=3), check_eq_values=False)
    print("predicted bond_k shape:", out.bond_k.shape,
          "field of view:", ff.field_of_view)
    return out


if __name__ == '__main__':
    main()
