"""Parametrize a molecule and run MD on it, entirely on the device.

An extension with no reference counterpart (the reference hands
parametrized systems to OpenMM / GROMACS): grappa_tpu_torch.md integrates
the predicted bonded force field on the batch's device, and the conformer
axis carries independent replicas. NVE energy conservation below doubles
as a live check that the predicted forces are the exact gradient of the
predicted energy.

    python -m grappa_tpu_torch.examples.usage.molecular_dynamics \
        [--steps 1000] [--device cpu]
"""
import argparse

import numpy as np
import torch

from grappa_tpu_torch import md
from grappa_tpu_torch.data import MolGraph, collate
from grappa_tpu_torch.data.synthetic import make_moldata


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.examples.usage.molecular_dynamics')
    ap.add_argument('--steps', type=int, default=1000,
                    help='Langevin steps (NVE runs half as many)')
    ap.add_argument('--device', default=None,
                    help='where MD runs (default: CUDA)')
    args = ap.parse_args(argv)

    # ground-truth bonded parameters of a synthetic molecule stand in for a
    # Grappa.predict(...) result so the example runs without a checkpoint;
    # with one: params = Grappa.from_tag('grappa-1.2').predict(molecule)
    mdata = make_moldata(seed=11, n_confs=4, learnable=True, conf_noise=0.05)
    batch = collate([MolGraph.from_moldata(mdata)], n_confs=4,
                    device=args.device)
    params = {f'{t}_{p}': torch.nan_to_num(getattr(batch.terms[t],
                                                   f'{p}_ref'))
              for t, p in (('n2', 'k'), ('n2', 'eq'), ('n3', 'k'),
                           ('n3', 'eq'), ('n4', 'k'), ('n4_improper', 'k'))}
    masses = md.masses_from_molecules([mdata.molecule], batch.xyz.shape[0],
                                      device=batch.xyz.device)

    # relax, then 4 independent replicas of 300 K Langevin sampling
    x_min = md.minimize(batch, params, n_steps=200, lr=5e-4)
    n = args.steps
    nvt = md.simulate(batch, params, masses, dt_fs=0.5, n_steps=n,
                      xyz0=x_min, temperature=300.0, friction_per_ps=5.0,
                      seed=0, record_every=max(1, n // 10))
    print(f"NVT: 4 replicas x {n} steps; "
          f"{nvt['trajectory'].shape[0]} recorded frames")
    ke = nvt['kinetic'][:, 0].cpu().numpy().mean(axis=0)
    print(f"mean kinetic energy per replica [kcal/mol]: {np.round(ke, 2)}")

    # NVE from the thermalized state: total energy must be flat
    nve = md.simulate(batch, params, masses, dt_fs=0.2, n_steps=n // 2,
                      xyz0=nvt['xyz'], v0=nvt['velocities'])
    total = (nve['potential'][:, 0, 0] + nve['kinetic'][:, 0, 0]
             ).cpu().numpy()
    drift = float(np.abs(total - total[0]).max())
    print(f"NVE drift over {n // 2} steps: {drift:.4f} kcal/mol "
          f"(scale {total.std():.4f})")
    return drift, float(total.std())


if __name__ == '__main__':
    main()
