"""Building your own MD-engine interface (reference:
examples/wrapper_construction/interface.py + load_model.py).

Everything an engine integration needs is `Grappa.predict`: build a
Molecule from your engine's topology (ids can be your engine's atom
numbers), predict, and write the returned Parameters back in your format.
The GROMACS / OpenMM / kimmdy wrappers in grappa_tpu_torch/wrappers are just
this pattern; units are kcal/mol, Angstrom, radian (signed torsion phases 0
/ pi).

    python -m grappa_tpu_torch.examples.wrapper_construction.interface \
        [--tag grappa-1.2] [--device cpu]
"""
import argparse

import numpy as np
import torch

from grappa_tpu_torch.api import Grappa
from grappa_tpu_torch.data import Molecule


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.examples.wrapper_construction.'
             'interface')
    ap.add_argument('--tag', default='grappa-1.2',
                    help='model tag or file')
    ap.add_argument('--device', default=None,
                    help='where the model runs (default: CUDA)')
    args = ap.parse_args(argv)

    # 1. load a model: by tag ('grappa-1.2', cached), or a local .pth/.npz.
    #    Without one: a freshly initialized small model, so the example
    #    runs anywhere.
    try:
        ff = Grappa.from_tag(args.tag, device=args.device)
    except Exception:
        from grappa_tpu_torch.models.grappa_model import (
            get_small_model_config, make_model)
        cfg = get_small_model_config()
        ff = Grappa(make_model(cfg,
                               generator=torch.Generator().manual_seed(0)),
                    {'model_config': cfg}, device=args.device)
        print("no cached release model; using a random small model")

    # 2. your engine's topology -> Molecule (ids = your atom numbers)
    mol = Molecule(
        atoms=[10, 11, 12, 13, 14, 15],
        bonds=[(10, 11), (11, 12), (12, 13), (11, 14), (12, 15)],
        impropers=[],
        atomic_numbers=[1, 6, 6, 1, 8, 8],
        partial_charges=[0.05, -0.1, -0.1, 0.05, 0.05, 0.05],
    )

    # 3. predict MM parameters; tuples come back in your id space
    params = ff.predict(mol, check_eq_values=False)
    for bond, eq, k in zip(params.bonds, params.bond_eq, params.bond_k):
        print(f"bond {tuple(bond)}: eq={eq:.3f} A  k={k:.1f} kcal/mol/A^2")
    print("proper ks (signed-phase convention):",
          np.round(params.proper_ks[:2], 3))

    # 4. partial reparametrization: restrict writes to the neighborhood of
    #    changed atoms using the model's field of view (see
    #    wrappers/gromacs_wrapper.fov_neighborhood for the reference logic)
    print("field of view (bond hops):", ff.field_of_view)
    return params


if __name__ == '__main__':
    main()
