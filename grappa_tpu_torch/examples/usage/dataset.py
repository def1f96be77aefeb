"""Datasets, splits and loaders (reference: examples/usage/dataset.py).

With released data in the cache, `Dataset.from_tag('spice-dipeptide')`
loads a benchmark set; without it this example builds a synthetic dataset
so it runs anywhere.

    python -m grappa_tpu_torch.examples.usage.dataset [--n-mols 32] \
        [--device cpu]
"""
import argparse
import tempfile

from grappa_tpu_torch.data.dataset import Dataset, calc_split_ids
from grappa_tpu_torch.data.loader import GraphLoader


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.examples.usage.dataset')
    ap.add_argument('--n-mols', type=int, default=32,
                    help='size of the synthetic fallback dataset')
    ap.add_argument('--device', default=None,
                    help='where the batches go (default: CUDA)')
    args = ap.parse_args(argv)

    try:
        ds = Dataset.from_tag('spice-dipeptide')
        print("loaded spice-dipeptide from the cache")
    except (FileNotFoundError, RuntimeError):   # not cached + offline
        from grappa_tpu_torch.data.synthetic import make_dataset
        ds = Dataset.from_moldata(
            make_dataset(n_mols=args.n_mols, n_confs=8, seed=0,
                         learnable=True), 'synthetic-demo')
        print(f"no cached data; built a {args.n_mols}-molecule synthetic "
              f"dataset")

    print(f"{len(ds)} molecules; first mol_id: {ds.mol_ids[0]}")

    # leak-safe split by molecule id (duplicates across subdatasets get one
    # consistent partition -- the reference's calc_split_ids semantics)
    split = calc_split_ids({'demo': ds.mol_ids}, partition=(0.8, 0.1, 0.1),
                           seed=0)
    train, val, test = ds.split(split['train'], split['val'], split['test'])
    print(f"split: {len(train)}/{len(val)}/{len(test)}")

    # the loader pads to shared shapes (one set of kernel shapes per size
    # bucket), samples conformers per the conf strategy, and can weight
    # datasets
    loader = GraphLoader(train, batch_size=8, conf_strategy=8, shuffle=True,
                         seed=0, device=args.device)
    batch, ds_names = next(iter(loader))
    print("batch:", batch.num_mols, "mols,", batch.xyz.shape[0],
          "padded atoms,", batch.xyz.shape[1], "confs on",
          batch.xyz.device, "; from:", set(ds_names))

    # save/load round-trip of the whole dataset directory
    out = tempfile.mkdtemp(prefix='grappa_ds_')
    ds.save(out)
    again = Dataset.load(out)
    assert again.mol_ids == ds.mol_ids
    print("dataset dir round-trip OK:", out)
    return ds, batch


if __name__ == '__main__':
    main()
